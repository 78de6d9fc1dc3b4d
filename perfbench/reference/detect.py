"""The 4-stage detection and the scene alert list, stated plainly for every
ordered pair (i, j) of live objects (the upstream's
collision_detection.py semantics with the physical sign convention,
DEVIATIONS.md #1, and the closed-form stage 3 of `fast` mode):

  1  |p_j - p_i| <= search_radius, i != j
  2  relative speed s = |v_j - v_i| >= min_relative_speed; the time of
     closest approach t* = -(r . v) / s^2 under constant velocity lies in
     [0, time_window]; the distance at t* under constant acceleration is at
     most safe = (size_i + size_j) / 2 + safe_distance_base
  3  the first time t >= 0 with |r + v t| <= safe, rounded up to the
     time_step lattice, where the pair is still inside, and no later than
     time_window - time_step: the hit; ttc = t (0 if already inside) and
     the distance d = |r + v ttc|
  4  risk = w_d (1 - d / safe) + w_t (1 - min(ttc / max_warning_time, 1))
     + w_s min(s / max_relative_speed, 1) + w_a sin|h_i - h_j|
     + w_type (same_type or diff_type factor), clipped to [0, 1];
     priority CRITICAL (3) if risk >= risk_high and ttc < ttc_critical,
     HIGH (2) if risk >= risk_high or ttc < ttc_high, MEDIUM (1) if
     risk >= risk_medium, else LOW (0)

A hit counts in num_risks; it qualifies for the scene list when
risk >= risk_low, ranked by 2 * priority + risk; the list holds the
max_scene_alerts best. Pairs are found on a grid of the benchmark's own
(cells one search radius wide, a dense table of each cell's members), in
blocks of objects, so that 10M objects fit.
"""
from __future__ import annotations

import itertools
import math

import torch

# candidate slots held at once in one block
BLOCK_SLOTS = 1 << 25


def _grid(pos: torch.Tensor, world: dict, cell: float):
    """(integer cell coordinates [N, 3], dims (3,)) of positions on a grid
    of `cell`-wide cells over the world, clamped into it."""
    lo = torch.tensor(world["lo"], dtype=torch.float64, device=pos.device)
    ext = [h - l for l, h in zip(world["lo"], world["hi"])]
    dims = [max(1, math.ceil(e / cell)) for e in ext]
    c = torch.floor((pos.double() - lo) / cell).long()
    hi = torch.tensor([d - 1 for d in dims], device=pos.device)
    return torch.minimum(torch.clamp_min(c, 0), hi), dims


def stencil_counts(pos: torch.Tensor, alive: torch.Tensor, world: dict,
                   cell: float) -> int:
    """Candidates walked by a cell-list broad phase over `cell`-wide cells:
    for every live object, the live objects (itself included) of the
    3 x 3 (2D) or 3 x 3 x 3 (3D) cells around its own."""
    c, (nx, ny, nz) = _grid(pos[alive], world, cell)
    flat = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    cnt = torch.bincount(flat, minlength=nx * ny * nz).reshape(nz, ny, nx)
    pad = torch.nn.functional.pad(cnt, (1, 1, 1, 1, 1, 1))
    near = torch.zeros_like(cnt)
    dzs = (-1, 0, 1) if nz > 1 else (0,)
    for dz, dy, dx in itertools.product(dzs, (-1, 0, 1), (-1, 0, 1)):
        near += pad[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                    1 + dx:1 + dx + nx]
    return int((cnt * near).sum())


def pair_stages(pi, pj, vi, vj, ai, aj, si, sj, hi, hj, ti, tj,
                det: dict, alerts: dict):
    """Stages 2-4 of stage-1 pairs given as [P, ...] tensors of one dtype.
    Returns (pass2, hit, risk, ttc, dist, prio) [P]."""
    r = pj - pi
    v = vj - vi
    a = aj - ai
    s2 = (v * v).sum(1)
    rv = (r * v).sum(1)
    d2 = (r * r).sum(1)
    safe = (si + sj) * 0.5 + det["safe_distance_base"]
    moving = s2 > 0
    s2_safe = torch.where(moving, s2, torch.ones_like(s2))
    tstar = -rv / s2_safe
    ts = tstar[:, None]
    closest = torch.linalg.vector_norm(r + v * ts + 0.5 * a * ts * ts, dim=1)
    s = torch.sqrt(s2)
    pass2 = ((s >= det["min_relative_speed"]) & (tstar >= 0)
             & (tstar <= det["time_window"]) & (closest <= safe))
    # stage 3: roots of |r + v t|^2 = safe^2
    c = d2 - safe * safe
    disc = 4 * rv * rv - 4 * s2 * c
    root = torch.sqrt(torch.clamp_min(disc, 0))
    t_in = (-2 * rv - root) / (2 * s2_safe)
    t_out = (-2 * rv + root) / (2 * s2_safe)
    inside = c <= 0
    dt = det["time_step"]
    t0 = torch.where(inside, torch.zeros_like(t_in), t_in.clamp_min(0))
    # an IEEE division (a Python divisor becomes a reciprocal multiply on
    # CUDA), so that times on the lattice snap to themselves
    tq = torch.ceil(t0 / torch.tensor(dt, dtype=t0.dtype, device=t0.device)
                    - 1e-6) * dt
    still = inside | ((tq >= t_in - 1e-6) & (tq <= t_out + 1e-6))
    hit = (pass2 & moving & (disc >= 0) & still
           & (tq <= det["time_window"] - dt + 1e-6))
    ttc = torch.where(inside, torch.zeros_like(tq), tq)
    dist = torch.linalg.vector_norm(r + v * ttc[:, None], dim=1)
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
    return pass2, hit, risk, ttc, dist, prio


def detect(state: dict, system: dict, dtype=torch.float32,
           qualifying: bool = True) -> dict:
    """Every ordered pair of live objects through the four stages.

    Returns {"stage1", "stage2", "hits"} (ints: pairs within the radius,
    stage-2 survivors, hits) and, with `qualifying`, the qualifying pairs
    as {"code" [Q] int64 (vehicle oid * 2^32 + other oid), "key", "risk",
    "ttc", "dist" [Q] float32, "prio" [Q] int64}."""
    det, alerts, world = system["detect"], system["alerts"], system["world"]
    R = det["search_radius"]
    alive = state["alive"]
    idx = torch.nonzero(alive).squeeze(1)
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
    out = dict(stage1=0, stage2=0, hits=0)
    parts = []
    for b0 in range(0, n, block):
        b1 = min(n, b0 + block)
        cand = []
        for o in offs:
            nc = c[b0:b1] + torch.tensor(o, device=dev)
            ok = ((nc >= 0) & (nc < dims)).all(1)
            nf = (nc[:, 2].clamp(0, nz - 1) * ny + nc[:, 1].clamp(0, ny - 1)
                  ) * nx + nc[:, 0].clamp(0, nx - 1)
            rows = table[nf]
            cand.append(torch.where(ok[:, None], rows, -1))
        cand = torch.cat(cand, 1)
        own = torch.arange(b0, b1, device=dev)[:, None]
        i, k = torch.nonzero((cand >= 0) & (cand != own), as_tuple=True)
        i = i + b0
        j = cand[i - b0, k]
        del cand
        rel = pos[j] - pos[i]
        near = (rel * rel).sum(1) <= R * R
        i, j = i[near], j[near]
        out["stage1"] += int(i.numel())
        pass2, hit, risk, ttc, dist, prio = pair_stages(
            pos[i], pos[j], vel[i], vel[j], acc[i], acc[j], size[i],
            size[j], head[i], head[j], otype[i], otype[j], det, alerts)
        out["stage2"] += int(pass2.sum())
        out["hits"] += int(hit.sum())
        if qualifying:
            q = hit & (risk >= alerts["risk_low"])
            parts.append(dict(
                code=oid[i[q]] * (1 << 32) + oid[j[q]],
                key=(2 * prio[q] + risk[q]).float(), risk=risk[q].float(),
                ttc=ttc[q].float(), dist=dist[q].float(), prio=prio[q]))
    if qualifying:
        if not parts:
            parts = [dict(code=torch.zeros(0, dtype=torch.int64, device=dev),
                          key=torch.zeros(0, device=dev),
                          risk=torch.zeros(0, device=dev),
                          ttc=torch.zeros(0, device=dev),
                          dist=torch.zeros(0, device=dev),
                          prio=torch.zeros(0, dtype=torch.int64,
                                           device=dev))]
        for f in parts[0]:
            out[f] = torch.cat([p[f] for p in parts])
    return out


def scene_list(ref: dict, size: int) -> dict:
    """The `size` best qualifying pairs of `detect`'s result by key (ties
    by the lower code): the scene alert list the reference gives."""
    order = torch.argsort(ref["code"])
    order = order[torch.argsort(ref["key"][order], descending=True,
                                stable=True)][:size]
    return {f: ref[f][order] for f in ("code", "key", "risk", "ttc", "dist",
                                       "prio")}
