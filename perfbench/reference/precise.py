"""The 4-stage detection of precise mode, stated plainly for every ordered
pair (i, j) of live objects: stages 1, 2 and 4 as detect.py states them,
and the upstream's sampled stage 3 (collision_detection.py:296-342, the
constant-acceleration kinematics of :433-449):

  3  samples t_k = f32(k) * time_step, k = 0 .. T - 1, T =
     int(time_window / time_step); the relative position at t_k is
     r + v t_k + 1/2 a t_k^2 (r = p_j - p_i, v = v_j - v_i, a = a_j - a_i);
     the first sample whose distance is at most safe is the hit, with
     ttc = t_k and the distance that sample's distance. No sample inside:
     no hit.

A hit counts in num_risks; it qualifies for the scene list when
risk >= risk_low, ranked by 2 * priority + risk, as in detect.py.

Departures from the upstream, as detect.py's: the physical sign convention
of stage 2 (DEVIATIONS.md #1); the sample times are f32(k) * time_step in
float32, not a running sum of time_step, so that t_k is the same number
whatever the chunk it is computed in. The distance is computed as
((r + v t) + (1/2 a) t^2), then the square root of the sum of squares,
the order of tpu_collide_torch/detect/pipeline._dist_at_time, so that a
sample on the safe distance falls on the same side in both.

The module imports nothing of tpu_collide_torch and nothing of the JAX
package. TF32 is switched off on import (no matrix product runs here; the
switch keeps it so).
"""
from __future__ import annotations

import torch

from perfbench.reference.compare import KEY_TIE
from perfbench.reference.detect import (BLOCK_SLOTS, _grid, pair_stages,
                                        scene_list)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# sample x pair entries of one chunk of the sweep
SWEEP_SLOTS = 1 << 24


def sweep(r, v, a, safe, det: dict):
    """Stage 3 of [P, 3] relative positions, velocities and accelerations
    and [P] safe distances, in their dtype: (hit [P] bool, ttc, dist [P]
    (inf where no hit), samples [P] int64: the samples up to and including
    the first hit, T where none)."""
    T, dt = int(det["time_window"] / det["time_step"]), det["time_step"]
    dev, p = r.device, r.shape[0]
    hit = torch.zeros(p, dtype=torch.bool, device=dev)
    ttc = torch.full((p,), float("inf"), dtype=r.dtype, device=dev)
    dist = torch.full((p,), float("inf"), dtype=r.dtype, device=dev)
    first_k = torch.full((p,), T, dtype=torch.int64, device=dev)
    c = max(1, min(T, SWEEP_SLOTS // max(p, 1)))
    for k0 in range(0, T, c):
        k = torch.arange(k0, min(k0 + c, T), device=dev)
        t = (k.to(torch.float32) * dt).to(r.dtype)[:, None, None]
        d = r[None] + v[None] * t + 0.5 * a[None] * (t * t)
        d = torch.sqrt(torch.sum(d * d, dim=-1))            # [C, P]
        inside = d <= safe[None]
        at = torch.argmax(inside.to(torch.int8), dim=0)
        new = inside.any(dim=0) & ~hit
        ttc = torch.where(new, t[:, 0, 0][at], ttc)
        dist = torch.where(new, d.gather(0, at[None])[0], dist)
        first_k = torch.where(new, k[at], first_k)
        hit = hit | new
    samples = torch.where(hit, first_k + 1, torch.full_like(first_k, T))
    return hit, ttc, dist, samples


def risk_priority(dist, ttc, s, safe, hi, hj, ti, tj, det: dict,
                  alerts: dict):
    """Stage 4 and the priority (copied from detect.py:104-116, the part of
    pair_stages that follows its stage 3)."""
    type_f = torch.where(ti == tj, det["same_type_factor"],
                         det["diff_type_factor"]).to(s.dtype)
    risk = (det["weight_distance"] * (1 - dist / safe)
            + det["weight_time"]
            * (1 - torch.clamp_max(ttc / det["max_warning_time"], 1))
            + det["weight_speed"]
            * torch.clamp_max(s / det["max_relative_speed"], 1)
            + det["weight_angle"] * torch.sin(torch.abs(hi - hj))
            + det["weight_type"] * type_f).clamp(0, 1)
    crit = (risk >= alerts["risk_high"]) & (ttc < alerts["ttc_critical"])
    high = (risk >= alerts["risk_high"]) | (ttc < alerts["ttc_high"])
    med = risk >= alerts["risk_medium"]
    prio = torch.where(crit, 3, torch.where(high, 2, torch.where(med, 1, 0)))
    return risk, prio


def stage1_blocks(state: dict, system: dict, dtype):
    """The stage-1 pairs of every live object, block by block: yields
    (fields, i, j), fields the live objects' (pos, vel, acc, size, heading,
    otype, oid) sorted by cell, i / j [P] indices into them. The grid, its
    table and the candidate walk are copied from detect.py:128-175."""
    R = system["detect"]["search_radius"]
    world = system["world"]
    idx = torch.nonzero(state["alive"]).squeeze(1)
    dev = idx.device
    cast = lambda t: t[idx].to(dtype)
    pos, vel, acc = cast(state["pos"]), cast(state["vel"]), cast(state["acc"])
    size, head = cast(state["size"]), cast(state["heading"])
    otype, oid = state["otype"][idx], state["oid"][idx].long()
    c, (nx, ny, nz) = _grid(pos.float(), world, R)
    flat = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    flat, order = torch.sort(flat)
    pos, vel, acc, size, head = (t[order] for t in (pos, vel, acc, size,
                                                    head))
    otype, oid, c = otype[order], oid[order], c[order]
    fields = (pos, vel, acc, size, head, otype, oid)
    n = flat.numel()
    count = torch.bincount(flat, minlength=nx * ny * nz)
    start = torch.cumsum(count, 0) - count
    width = int(count.max()) if n else 1
    table = torch.full((nx * ny * nz, width), -1, dtype=torch.int64,
                       device=dev)
    table[flat, torch.arange(n, device=dev) - start[flat]] = torch.arange(
        n, device=dev)
    offs = [(dx, dy, dz) for dz in ((-1, 0, 1) if nz > 1 else (0,))
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    dims = torch.tensor([nx, ny, nz], device=dev)
    block = max(1, BLOCK_SLOTS // (len(offs) * width))
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        cand = []
        for o in offs:
            nc = c[b0:b1] + torch.tensor(o, device=dev)
            ok = ((nc >= 0) & (nc < dims)).all(1)
            nf = (nc[:, 2].clamp(0, nz - 1) * ny + nc[:, 1].clamp(0, ny - 1)
                  ) * nx + nc[:, 0].clamp(0, nx - 1)
            cand.append(torch.where(ok[:, None], table[nf], -1))
        cand = torch.cat(cand, 1)
        own = torch.arange(b0, b1, device=dev)[:, None]
        i, k = torch.nonzero((cand >= 0) & (cand != own), as_tuple=True)
        i = i + b0
        j = cand[i - b0, k]
        del cand
        rel = pos[j] - pos[i]
        near = (rel * rel).sum(1) <= R * R
        yield fields, i[near], j[near]


def detect(state: dict, system: dict, dtype=torch.float32,
           qualifying: bool = True) -> dict:
    """Every ordered pair of live objects through the four stages, stage 3
    the sampled sweep.

    Returns {"stage1", "stage2", "hits"} (ints), "samples" ([stage2]
    int64: each stage-2 survivor's samples up to and including its first
    hit, T where none) and, with `qualifying`, the qualifying pairs as
    detect.detect gives them ({"code", "key", "risk", "ttc", "dist",
    "prio"})."""
    det, alerts = system["detect"], system["alerts"]
    out = dict(stage1=0, stage2=0, hits=0)
    parts, samples = [], []
    for (pos, vel, acc, size, head, otype, oid), i, j in stage1_blocks(
            state, system, dtype):
        out["stage1"] += int(i.numel())
        pass2 = pair_stages(pos[i], pos[j], vel[i], vel[j], acc[i], acc[j],
                            size[i], size[j], head[i], head[j], otype[i],
                            otype[j], det, alerts)[0]
        i, j = i[pass2], j[pass2]
        out["stage2"] += int(i.numel())
        safe = (size[i] + size[j]) * 0.5 + det["safe_distance_base"]
        hit, ttc, dist, n = sweep(pos[j] - pos[i], vel[j] - vel[i],
                                  acc[j] - acc[i], safe, det)
        samples.append(n)
        out["hits"] += int(hit.sum())
        if qualifying:
            i, j = i[hit], j[hit]
            ttc, dist, safe = ttc[hit], dist[hit], safe[hit]
            s = torch.linalg.vector_norm(vel[j] - vel[i], dim=1)
            risk, prio = risk_priority(dist, ttc, s, safe, head[i], head[j],
                                       otype[i], otype[j], det, alerts)
            q = risk >= alerts["risk_low"]
            parts.append(dict(
                code=oid[i[q]] * (1 << 32) + oid[j[q]],
                key=(2 * prio[q] + risk[q]).float(), risk=risk[q].float(),
                ttc=ttc[q].float(), dist=dist[q].float(), prio=prio[q]))
    dev = state["alive"].device
    out["samples"] = (torch.cat(samples) if samples
                      else torch.zeros(0, dtype=torch.int64, device=dev))
    if qualifying:
        empty = lambda dt: torch.zeros(0, dtype=dt, device=dev)
        if not parts:
            parts = [dict(code=empty(torch.int64), key=empty(torch.float32),
                          risk=empty(torch.float32),
                          ttc=empty(torch.float32),
                          dist=empty(torch.float32),
                          prio=empty(torch.int64))]
        for f in parts[0]:
            out[f] = torch.cat([p[f] for p in parts])
    return out


def judge(state: dict, produced: dict, system: dict) -> dict:
    """risks_gap, alert_miss and alert_key_gap of a produced detection on
    `state` against this module's detection, under
    compare.judge_detection's definitions (its body, compare.py:30-57,
    copied with this module's detect in the place of detect.py's)."""
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
    """This module's detection computed in `dtype`, in the shape of a
    produced detection (compare.stand_in's, with the sweep)."""
    ref = detect(state, system, dtype=dtype)
    top = scene_list(ref, system["alerts"]["max_scene_alerts"])
    return dict(num_risks=ref["hits"], alerts=dict(
        valid=torch.ones_like(top["code"], dtype=torch.bool),
        vehicle_oid=top["code"] >> 32, other_oid=top["code"] & 0xFFFFFFFF,
        risk=top["risk"], priority=top["prio"]))
