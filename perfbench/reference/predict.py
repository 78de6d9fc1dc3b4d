"""The upstream's trajectory prediction (CollisionPredictionModel,
collision_detection.py:525-877; SURVEY section 2), stated plainly for every
live object, and how a produced prediction is judged against it.

  ring       each object keeps its last H positions with their times,
             oldest first (H = history_points, the upstream's 100,
             :538-539); a tick appends every live object's position at the
             tick's time and drops the oldest past H
  classify   velocities of consecutive samples whose times grow, (p_k+1 -
             p_k) / (t_k+1 - t_k), and their mean; accelerations of
             consecutive velocities, (v_k+1 - v_k) / (t_k+2 - t_k+1), and
             their mean; stationary if the mean velocity's norm is below
             0.1, constant velocity if the mean acceleration's is, else
             accelerating; an object with no velocity pair is stationary
             (:623-711)
  offsets    t = f32(k) * step for k = 0, 1, ... while k * step < horizon
             (20 offsets over 10 s at 0.5 s, :542-543)
  own        the class-predicted position at t (:713-763): p (stationary),
             p + v t (constant velocity), p + v t + 1/2 a t^2
             (accelerating), from the object's current p, v, a
  candidates every other live object whose CURRENT position lies within
             search_radius of the own predicted position (the upstream
             queries today's index with tomorrow's position, :800-803)
  advance    the candidate moves to t under constant acceleration,
             c_p + c_v t + 1/2 c_a t^2 (:808-812)
  sweep      samples t_s = f32(s) * time_step, s < int(sub_window /
             time_step), of r + v t_s + 1/2 a t_s^2 with r the advanced
             candidate less the own predicted position, v and a the
             candidate's less the own object's current velocity and
             acceleration; the first sample within the safe distance is the
             hit (:789-846)
  risk       stage 4 of detect.py with d the hit's distance, ttc the hit's
             sample time t_s and the speed |v|; the entry's ttc is t + t_s
  merge      per ordered pair (own, candidate) the highest risk over the
             offsets, ties by the earlier offset (:848-865)
  list       the pairs with risk >= risk_low, the r_cap highest by risk

Departures from the upstream, as the port states them: the physical sign
convention of detect.py (DEVIATIONS.md #1); the sample and offset times
are f32(k) * step in float32, not running sums; the merge keeps every pair
of an object, where the port keeps each object's top merge_k pool entries
(a row cut by that cap shows as a miss); the list is cut at r_cap, the
port's scene budget. The distance is ((r + v t) + (1/2 a) t^2), then the
square root of its sum of squares, the order of the port's sweep.

Pairs are found on a grid of the benchmark's own (cells one search radius
wide, a dense table of each cell's members), in blocks of own objects, one
offset at a time, so that 1M objects fit. The module imports nothing of
tpu_collide_torch and nothing of the JAX package; TF32 is switched off on
import (no matrix product runs here; the switch keeps it so).
"""
from __future__ import annotations

import itertools
import math

import torch

from perfbench.reference.compare import KEY_TIE
from perfbench.reference.detect import BLOCK_SLOTS, _grid
from perfbench.reference.precise import risk_priority

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STATIONARY, CONST_VEL, ACCEL = 0, 1, 2


def unroll(pos, t, count, head) -> dict:
    """A ring buffer ([N, H, 3] positions and [N, H] times written at slot
    `head` and on, `count` of them valid) as the reference's ring: {"pos",
    "t" oldest first, "count"}; entries past count are 0 and -inf."""
    n, h = t.shape
    dev = t.device
    slots = torch.arange(h, device=dev)
    start = torch.where(count >= h, head, torch.zeros_like(head)).long()
    at = (start[:, None] + slots[None, :]) % h
    valid = slots[None, :] < count[:, None]
    rows = torch.arange(n, device=dev)[:, None]
    return dict(pos=torch.where(valid[..., None], pos[rows, at], 0.0),
                t=torch.where(valid, t[rows, at], -math.inf),
                count=count.long())


def keep_last(ring: dict, points: int) -> dict:
    """The ring cut to each object's newest `points` entries."""
    n, h = ring["t"].shape
    if h <= points:
        return ring
    dev = ring["t"].device
    k = torch.arange(points, device=dev)
    at = ((ring["count"] - points).clamp_min(0)[:, None] + k[None, :]
          ).clamp_max(h - 1)
    count = ring["count"].clamp_max(points)
    valid = k[None, :] < count[:, None]
    rows = torch.arange(n, device=dev)[:, None]
    return dict(pos=torch.where(valid[..., None], ring["pos"][rows, at], 0),
                t=torch.where(valid, ring["t"][rows, at], -math.inf),
                count=count)


def advance_ring(ring: dict, state: dict, time: float, points: int,
                 dtype=torch.float32) -> dict:
    """The ring after a tick at `time` holding `points` points an object:
    each live object's position appended, the oldest dropped past
    `points`. Computed and returned in `dtype`."""
    ring = keep_last(ring, points)
    pos, t, count = ring["pos"].to(dtype), ring["t"].to(dtype), ring["count"]
    n, h = t.shape
    dev = t.device
    if h < points:
        pos = torch.cat([pos, pos.new_zeros((n, points - h, 3))], 1)
        t = torch.cat([t, t.new_full((n, points - h), -math.inf)], 1)
    alive = state["alive"]
    full = count >= points
    # a full ring moves one place towards the oldest end
    shift = alive & full
    pos = torch.where(shift[:, None, None], torch.roll(pos, -1, 1), pos)
    t = torch.where(shift[:, None], torch.roll(t, -1, 1), t)
    at = torch.where(full, points - 1, count).clamp_max(points - 1)
    rows = torch.nonzero(alive).squeeze(1)
    pos = pos.clone()
    t = t.clone()
    pos[rows, at[rows]] = state["pos"][rows].to(dtype)
    t[rows, at[rows]] = torch.tensor(time, dtype=torch.float32,
                                     device=dev).to(dtype)
    count = torch.where(alive, torch.clamp_max(count + 1, points), count)
    return dict(pos=pos, t=t, count=count)


def ring_gap(got: dict, want: dict) -> float:
    """The largest gap of a valid entry's position (m) or time (s) between
    two rings; infinite where a count differs."""
    if got["t"].shape[1] != want["t"].shape[1] or not torch.equal(
            got["count"], want["count"]):
        return math.inf
    h = got["t"].shape[1]
    valid = torch.arange(h, device=got["t"].device)[None, :] < \
        got["count"][:, None]
    if not bool(valid.any()):
        return 0.0
    dp = (got["pos"].float() - want["pos"].float()).abs().amax(-1)[valid]
    dt = (got["t"].float() - want["t"].float()).abs()[valid]
    return float(torch.maximum(dp.max(), dt.max()))


def classify(ring: dict) -> torch.Tensor:
    """[N] int64 trajectory classes of a ring, in its dtype."""
    pos, t, count = ring["pos"], ring["t"], ring["count"]
    h = t.shape[1]
    k = torch.arange(h, device=t.device)
    valid = k[None, :] < count[:, None]
    dt = t[:, 1:] - t[:, :-1]
    vok = valid[:, 1:] & valid[:, :-1] & (dt > 0)
    vel = (pos[:, 1:] - pos[:, :-1]) / torch.where(vok, dt, 1)[..., None]
    vel = torch.where(vok[..., None], vel, 0)
    nv = vok.sum(1)
    mean_v = vel.sum(1) / nv.clamp_min(1)[:, None].to(vel.dtype)
    dtv = t[:, 2:] - t[:, 1:-1]
    aok = vok[:, 1:] & vok[:, :-1] & (dtv > 0)
    acc = (vel[:, 1:] - vel[:, :-1]) / torch.where(aok, dtv, 1)[..., None]
    acc = torch.where(aok[..., None], acc, 0)
    mean_a = acc.sum(1) / aok.sum(1).clamp_min(1)[:, None].to(acc.dtype)
    speed = torch.linalg.vector_norm(mean_v, dim=1)
    accel = torch.linalg.vector_norm(mean_a, dim=1)
    cls = torch.where(accel < 0.1, CONST_VEL, ACCEL)
    return torch.where((nv == 0) | (speed < 0.1), STATIONARY, cls)


def offsets(horizon: float, step: float) -> list:
    """The offsets' indices k: t = f32(k) * step for k * step < horizon."""
    out, k = [], 0
    while k * step < horizon:
        out.append(k)
        k += 1
    return out


def _table(pos, alive, world: dict, cell: float):
    """((nx, ny, nz), the [cells, width] table of each cell's live object
    indices padded with -1, the live count of each cell's 3 x 3 (x 3)
    stencil) of positions on `cell`-wide cells."""
    idx = torch.nonzero(alive).squeeze(1)
    c, (nx, ny, nz) = _grid(pos[idx].float(), world, cell)
    flat = (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0]
    flat, order = torch.sort(flat)
    idx = idx[order]
    cnt = torch.bincount(flat, minlength=nx * ny * nz)
    start = torch.cumsum(cnt, 0) - cnt
    width = max(1, int(cnt.max()) if idx.numel() else 1)
    table = torch.full((nx * ny * nz, width), -1, dtype=torch.int64,
                       device=pos.device)
    table[flat, torch.arange(idx.numel(), device=pos.device) - start[flat]] \
        = idx
    dzs = (-1, 0, 1) if nz > 1 else (0,)
    grid = cnt.reshape(nz, ny, nx)
    pad = torch.nn.functional.pad(grid, (1, 1, 1, 1, 1, 1))
    near = torch.zeros_like(grid)
    for dz, dy, dx in itertools.product(dzs, (-1, 0, 1), (-1, 0, 1)):
        near += pad[1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny,
                    1 + dx:1 + dx + nx]
    return (nx, ny, nz), table, near.reshape(-1)


def sweep(r, v, a, safe, steps: int, dt: float):
    """The first of `steps` samples t_s = f32(s) * dt of r + v t_s + 1/2 a
    t_s^2 ([P, 3]) within `safe` ([P]): (hit [P], t_s, distance, samples
    up to and including the first hit, `steps` where none)."""
    p = r.shape[0]
    times = (torch.arange(steps, dtype=torch.float32) * dt).to(r.dtype).to(
        r.device)
    hit = torch.zeros(p, dtype=torch.bool, device=r.device)
    t_hit = torch.zeros(p, dtype=r.dtype, device=r.device)
    d_hit = torch.zeros(p, dtype=r.dtype, device=r.device)
    samples = torch.full((p,), steps, dtype=torch.int64, device=r.device)
    for s in range(steps):
        ts = times[s]
        d = r + v * ts + 0.5 * a * (ts * ts)
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                          + d[:, 2] * d[:, 2])
        new = (dist <= safe) & ~hit
        t_hit = torch.where(new, ts, t_hit)
        d_hit = torch.where(new, dist, d_hit)
        samples = torch.where(new, s + 1, samples)
        hit = hit | new
    return hit, t_hit, d_hit, samples


def predict(state: dict, ring: dict, system: dict, pred: dict,
            dtype=torch.float32) -> dict:
    """The merged predicted pairs of every live object from its ring.

    Returns {"code" [Q] int64 (own oid * 2^32 + other oid), "risk", "ttc",
    "dist" [Q] (float32)} of every merged pair with risk >= risk_low,
    "total" (Q), and the work the predict kernel's bound reads: "rows"
    (live objects x offsets), "walked" (stencil candidates of the
    predicted cells, itself included), "pairs" (candidates within the
    radius), "samples" (their samples up to and including the first hit)
    and "hits" (pairs with a hit, before the merge)."""
    det, alerts, world = system["detect"], system["alerts"], system["world"]
    R = det["search_radius"]
    steps = int(pred["sub_window"] / det["time_step"])
    dev = state["pos"].device
    alive = state["alive"]
    cast = lambda x: x.to(dtype)
    pos, vel, acc = cast(state["pos"]), cast(state["vel"]), cast(state["acc"])
    size, head = cast(state["size"]), cast(state["heading"])
    otype, oid = state["otype"], state["oid"].long()
    cls = classify(dict(ring, pos=ring["pos"].to(dtype),
                        t=ring["t"].to(dtype)))
    (nx, ny, nz), table, near = _table(pos, alive, world, R)
    cell = system["grid"]["cell_size"]
    walk_near = near if cell == R else _table(pos, alive, world, cell)[2]
    dims = torch.tensor([nx, ny, nz], device=dev)
    offs = torch.tensor([(dx, dy, dz) for dz in ((-1, 0, 1) if nz > 1
                                                 else (0,))
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                        device=dev)
    hi = dims - 1
    rows = torch.nonzero(alive).squeeze(1)
    block = max(1, BLOCK_SLOTS // (len(offs) * table.shape[1]))
    work = dict(rows=0, walked=0, pairs=0, samples=0, hits=0)
    hits = []
    for k in offsets(pred["horizon"], pred["step"]):
        t = torch.tensor(k, dtype=torch.float32).mul(pred["step"]).to(
            dtype).to(dev)
        p_cv = pos + vel * t
        p_acc = p_cv + 0.5 * acc * t * t
        c3 = cls[:, None]
        own_at = torch.where(c3 == STATIONARY, pos,
                             torch.where(c3 == CONST_VEL, p_cv, p_acc))
        cw, (wx, wy, wz) = _grid(own_at[rows].float(), world, cell)
        work["rows"] += int(rows.numel())
        work["walked"] += int(walk_near[(cw[:, 2] * wy + cw[:, 1]) * wx
                                        + cw[:, 0]].sum())
        for b0 in range(0, rows.numel(), block):
            own = rows[b0:b0 + block]
            at = own_at[own]
            c, _ = _grid(at.float(), world, R)
            # the stencil's cells around each predicted cell: [B, S, 3]
            nc = c[:, None, :] + offs[None]
            ok = ((nc >= 0) & (nc <= hi)).all(2)
            nc = torch.minimum(nc.clamp_min(0), hi)
            nf = (nc[..., 2] * ny + nc[..., 1]) * nx + nc[..., 0]
            cand = torch.where(ok[..., None], table[nf], -1).reshape(
                own.numel(), -1)
            li, kk = torch.nonzero((cand >= 0) & (cand != own[:, None]),
                                   as_tuple=True)
            j = cand[li, kk]
            del cand
            q = pos[j] - at[li]
            qd = torch.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                            + q[:, 2] * q[:, 2])
            keep = qd <= R
            li, j = li[keep], j[keep]
            i = own[li]
            work["pairs"] += int(i.numel())
            cpos = pos[j] + vel[j] * t + 0.5 * acc[j] * t * t
            safe = (size[i] + size[j]) * 0.5 + det["safe_distance_base"]
            dv = vel[j] - vel[i]
            hit, t_s, d_s, n = sweep(cpos - own_at[i], dv, acc[j] - acc[i],
                                     safe, steps, det["time_step"])
            work["samples"] += int(n.sum())
            work["hits"] += int(hit.sum())
            i, j, t_s, d_s, dv, safe = (x[hit] for x in (i, j, t_s, d_s, dv,
                                                         safe))
            s = torch.linalg.vector_norm(dv, dim=1)
            risk, _ = risk_priority(d_s, t_s, s, safe, head[i], head[j],
                                    otype[i], otype[j], det, alerts)
            hits.append(dict(code=oid[i] * (1 << 32) + oid[j],
                             risk=risk.float(), ttc=(t_s + t).float(),
                             dist=d_s.float(),
                             off=torch.full_like(i, k)))
    merged = merge(hits, dev)
    q = merged["risk"] >= alerts["risk_low"]
    out = {f: v[q] for f, v in merged.items()}
    out["total"] = int(q.sum())
    out.update(work)
    return out


def merge(hits: list, dev) -> dict:
    """Per code the entry of highest risk, ties by the earlier offset."""
    if not hits:
        empty = lambda d: torch.zeros(0, dtype=d, device=dev)
        return dict(code=empty(torch.int64), risk=empty(torch.float32),
                    ttc=empty(torch.float32), dist=empty(torch.float32))
    h = {f: torch.cat([x[f] for x in hits]) for f in hits[0]}
    order = torch.argsort(h["off"], stable=True)
    order = order[torch.argsort(-h["risk"][order], stable=True)]
    order = order[torch.argsort(h["code"][order], stable=True)]
    code = h["code"][order]
    first = torch.ones_like(code, dtype=torch.bool)
    first[1:] = code[1:] != code[:-1]
    pick = order[first]
    return {f: h[f][pick] for f in ("code", "risk", "ttc", "dist")}


def top(ref: dict, size: int) -> dict:
    """The `size` highest merged pairs by risk, ties by the lower code."""
    order = torch.argsort(ref["code"])
    order = order[torch.argsort(ref["risk"][order], descending=True,
                                stable=True)][:size]
    return {f: ref[f][order] for f in ("code", "risk", "ttc", "dist")}


def judge(state: dict, ring_before: dict, ring_after: dict, time: float,
          produced: dict, system: dict, pred: dict) -> dict:
    """The numbers by which a predict tick is judged. `ring_before` and
    `ring_after` are the program's rings (as `unroll` gives them) before
    and after the tick's update at `time`; `state` the state the tick's
    prediction ran on; `produced` its list: {"risk", "vehicle_oid",
    "other_oid", "ttc" [r] (entries with risk < 0 are not listed),
    "count"}.

      ring_err        the largest gap of ring_after from this module's
                      update of ring_before (m or s; inf where a count
                      differs)
      pred_miss       listed pairs that do not qualify, fall below the
                      reference's cut or are listed twice, plus qualifying
                      pairs above the cut that are not listed, plus the
                      gap between the list's length and min(r_cap, total);
                      ties within KEY_TIE of the cut may fall either way
      pred_key_gap    the largest gap of a listed pair's risk
      pred_ttc_gap    the largest gap of a listed pair's ttc (s)
      pred_total_gap  |count - total| / max(1, total)

    The prediction is computed on this module's ring, not the program's."""
    ring = advance_ring(ring_before, state, time, pred["history_points"])
    ref = predict(state, ring, system, pred)
    out = dict(ring_err=ring_gap(ring_after, ring))
    out.update(judge_list(produced, ref, pred["r_cap"]))
    return out


def judge_list(produced: dict, ref: dict, size: int) -> dict:
    """pred_miss, pred_key_gap, pred_ttc_gap and pred_total_gap of a
    produced list against this module's prediction `ref`."""
    listed = produced["risk"] >= 0
    code = (produced["vehicle_oid"][listed].long() * (1 << 32)
            + produced["other_oid"][listed].long())
    key = produced["risk"][listed].float()
    ttc = produced["ttc"][listed].float()
    rcode, order = torch.sort(torch.cat([ref["code"], code.new_full(
        (1,), 1 << 62)]))
    rkey = torch.cat([ref["risk"], ref["risk"].new_full((1,), -1.0)])[order]
    rttc = torch.cat([ref["ttc"], ref["ttc"].new_zeros(1)])[order]
    nq = ref["code"].numel()
    cut = (torch.topk(ref["risk"], size).values[-1].item() if nq >= size
           else -math.inf)
    at = torch.searchsorted(rcode, code)
    found = rcode[at] == code
    fkey = rkey[at]
    twice = code.numel() - torch.unique(code).numel()
    extra = int((~found | (fkey < cut - KEY_TIE)).sum()) + twice
    above = int((ref["risk"] > cut + KEY_TIE).sum())
    missing = above - int((found & (fkey > cut + KEY_TIE)).sum())
    kgap = (key - fkey)[found].abs()
    tgap = (ttc - rttc[at])[found].abs()
    total = ref["total"]
    return dict(
        pred_miss=extra + max(missing, 0)
        + abs(int(listed.sum()) - min(size, nq)),
        pred_key_gap=float(kgap.max()) if kgap.numel() else 0.0,
        pred_ttc_gap=float(tgap.max()) if tgap.numel() else 0.0,
        pred_total_gap=abs(int(produced["count"]) - total) / max(1, total))


def stand_in(state: dict, ring: dict, system: dict, pred: dict,
             dtype=torch.float32) -> dict:
    """This module's prediction on `ring`, computed in `dtype`, in the shape
    of a produced list (a control puts it in the program's place)."""
    ref = predict(state, ring, system, pred, dtype=dtype)
    t = top(ref, pred["r_cap"])
    return dict(risk=t["risk"], vehicle_oid=t["code"] >> 32,
                other_oid=t["code"] & 0xFFFFFFFF, ttc=t["ttc"],
                count=ref["total"])
