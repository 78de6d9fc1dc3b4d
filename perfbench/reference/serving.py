"""The serving layer stated plainly: a tick's location reports written into
the fleet, and the alert manager's registry after a run of alert lists.

Ingest: each reported vehicle's slot takes the report's position,
velocity, acceleration and heading (in a 2D world z, vz and az are 0), its
size and type, and becomes live; every other slot keeps its values.

Alert manager (the upstream's warning_system.py:120-197): one alert per
ordered (vehicle, other) pair, created on the pair's first listing and
updated in place by every later one (risk, ttc, priority); nothing
expires while no pump runs.
"""
from __future__ import annotations

import math

import torch


def ingest(prev: dict, reports: dict, sizes, otypes, is3d: bool,
           dtype=torch.float32) -> dict:
    """The fleet after one tick's reports ({"slot" [R], "pos", "vel"
    [R, 3], "heading" [R]} as numpy) with each reported vehicle's size and
    type from `otypes` ([N] numpy)."""
    dev = prev["pos"].device
    slot = torch.as_tensor(reports["slot"], device=dev)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64,
                                     device=dev).to(dtype).float()
    pos, vel = as_t(reports["pos"]), as_t(reports["vel"])
    if not is3d:
        pos[:, 2] = 0.0
        vel[:, 2] = 0.0
    t = torch.as_tensor(otypes[reports["slot"]], device=dev)
    out = {k: v.clone() for k, v in prev.items()}
    out["pos"][slot] = pos
    out["vel"][slot] = vel
    out["acc"][slot] = 0.0
    out["heading"][slot] = as_t(reports["heading"])
    out["size"][slot] = torch.as_tensor(sizes, dtype=torch.float32,
                                        device=dev)[t.long()]
    out["otype"][slot] = t.to(torch.int32)
    out["alive"][slot] = True
    return out


def judge_ingest(want: dict, got: dict) -> float:
    """The largest gap of any field of any slot between two fleets."""
    return max(float((want[f].double() - got[f].double()).abs().max())
               for f in want)


def registry(batches, name_of, dtype=None) -> tuple:
    """({(vehicle id, other id): (risk, ttc, priority)}, created, updated)
    after upserting every listed alert of `batches` in order. Each batch is
    {"valid", "vehicle_oid", "other_oid", "risk", "ttc", "priority"} as
    numpy arrays; `dtype` (a torch dtype) rounds risk and ttc to it."""
    reg, created, updated = {}, 0, 0
    for b in batches:
        risk, ttc = b["risk"], b["ttc"]
        if dtype is not None:
            risk = torch.as_tensor(risk).to(dtype).float().numpy()
            ttc = torch.as_tensor(ttc).to(dtype).float().numpy()
        for i in b["valid"].nonzero()[0]:
            key = (name_of(b["vehicle_oid"][i]), name_of(b["other_oid"][i]))
            if key in reg:
                updated += 1
            else:
                created += 1
            reg[key] = (float(risk[i]), float(ttc[i]), int(b["priority"][i]))
    return reg, created, updated


def judge_registry(want: tuple, got: tuple) -> int:
    """Pairs present on one side only, pairs whose (risk, ttc, priority)
    differ, and the gaps of the created and updated counts; alert ids that
    are not unique count too. `got` is (registry, created, updated,
    number of distinct ids)."""
    reg_w, cre_w, upd_w = want
    reg_g, cre_g, upd_g, ids = got
    miss = len(reg_w.keys() ^ reg_g.keys())
    for k in reg_w.keys() & reg_g.keys():
        rw, tw, pw = reg_w[k]
        rg, tg, pg = reg_g[k]
        same_t = (tw == tg) or (math.isinf(tw) and math.isinf(tg))
        miss += not (rw == rg and same_t and pw == pg)
    return (miss + abs(cre_w - cre_g) + abs(upd_w - upd_g)
            + abs(len(reg_g) - ids))
