"""How a produced step is judged against the reference: the numbers
compared, each of which the cell's limits file bounds.

A produced detection is {"num_risks": int, "alerts": {"valid",
"vehicle_oid", "other_oid", "risk", "priority"} as tensors}.
"""
from __future__ import annotations

import torch

from perfbench.reference.detect import detect, scene_list

# keys closer than this to the list's cut may fall on either side of it:
# equal keys are cut by an order that is the program's own
KEY_TIE = 1e-4


def judge_detection(state: dict, produced: dict, system: dict) -> dict:
    """The numbers by which a step's counters and scene alert list, produced
    on `state`, are judged:

      risks_gap      |num_risks - the reference's hits| / max(1, hits)
      alert_miss     listed pairs that do not qualify, fall below the
                     reference's cut or are listed twice, plus qualifying
                     pairs above the cut that are not listed, plus the gap
                     between the list's length and min(max_scene_alerts,
                     qualifying pairs)
      alert_key_gap  the largest gap of a listed pair's 2 * priority + risk
                     from the reference's"""
    ref = detect(state, system)
    size = system["alerts"]["max_scene_alerts"]
    a = produced["alerts"]
    valid = a["valid"].bool()
    code = (a["vehicle_oid"][valid].long() * (1 << 32)
            + a["other_oid"][valid].long())
    pkey = 2 * a["priority"][valid].float() + a["risk"][valid].float()
    # a sentinel past every code keeps the lookups in range
    rcode, order = torch.sort(torch.cat([ref["code"], code.new_full(
        (1,), 1 << 62)]))
    rkey = torch.cat([ref["key"], ref["key"].new_full((1,), -1.0)])[order]
    nq = ref["code"].numel()
    cut = (torch.topk(ref["key"], size).values[-1].item() if nq >= size
           else -float("inf"))
    at = torch.searchsorted(rcode, code)
    found = rcode[at] == code
    fkey = rkey[at]
    twice = code.numel() - torch.unique(code).numel()
    extra = int((~found | (fkey < cut - KEY_TIE)).sum()) + twice
    above = int((ref["key"] > cut + KEY_TIE).sum())
    missing = above - int((found & (fkey > cut + KEY_TIE)).sum())
    gap = (pkey - fkey)[found].abs()
    hits = ref["hits"]
    return dict(
        risks_gap=abs(produced["num_risks"] - hits) / max(1, hits),
        alert_miss=extra + max(missing, 0)
        + abs(int(valid.sum()) - min(size, nq)),
        alert_key_gap=float(gap.max()) if gap.numel() else 0.0)


def stand_in(state: dict, system: dict, dtype) -> dict:
    """The detection the reference gives computed in `dtype`, in the shape
    of a produced detection (the control puts it in the program's
    place)."""
    ref = detect(state, system, dtype=dtype)
    top = scene_list(ref, system["alerts"]["max_scene_alerts"])
    return dict(num_risks=ref["hits"], alerts=dict(
        valid=torch.ones_like(top["code"], dtype=torch.bool),
        vehicle_oid=top["code"] >> 32, other_oid=top["code"] & 0xFFFFFFFF,
        risk=top["risk"], priority=top["prio"]))


def worst(readings: list) -> dict:
    """The largest reading of each number over a list of judgements."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out
