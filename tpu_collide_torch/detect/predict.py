"""Trajectory-based collision prediction (the port of
tpu_collide/detect/predict.py, the CollisionPredictionModel analog).

  * each object's recent positions live in a ring buffer [N, H] on the
    device (`TrajectoryHistory`, one `update_history` per tick, span
    tc.history; H = 16 unless the caller names the reference's 100);
  * `classify_trajectories` sorts each trajectory into stationary /
    constant velocity / accelerating from its history-averaged speed and
    acceleration (0.1 thresholds; span tc.classify); objects with fewer
    than 2 samples need the plain detector (`needs_fallback`);
  * at each offset t = 0, step, ..., the object moves to its
    class-predicted position (`_predicted_position`, current velocity and
    acceleration); candidates come from the CURRENT grid around that
    position (the reference's quirk of querying today's index with
    tomorrow's position), advance to the same offset under constant
    acceleration, and a 1 s sampled sweep plus the stage-4 risk score each
    pair;
  * `merge_pair_risks` keeps each object's top merge_k pool entries and one
    entry per other object, at its max risk.

`predict_collisions` is the reference-shaped path over the grid
(index/grid.py); kernels/refine.fused_predict is the kernel path. Both
score their pairs with `predict_pair_risks`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor, resolve_device
from tpu_collide_torch.core.ops import stable_topk
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import traced
from tpu_collide_torch.detect.pipeline import (PairSide, _norm,
                                               _pair_safe_distance,
                                               _precise_sweep, _risk_score)
from tpu_collide_torch.index.grid import (GridIndex, cell_coords,
                                          gather_candidates)

CLASS_STATIONARY, CLASS_CONST_VEL, CLASS_ACCEL = 0, 1, 2
HISTORY_FIELDS = ("pos", "t", "count", "head")


@dataclasses.dataclass(frozen=True)
class TrajectoryHistory:
    """Ring buffer of past positions: pos [N, H, 3] f32, t [N, H] f32
    seconds (-inf where never written), count [N] int32 valid samples,
    head [N] int32 next write slot."""
    pos: torch.Tensor
    t: torch.Tensor
    count: torch.Tensor
    head: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).cpu().numpy() for f in HISTORY_FIELDS}


def empty_history(n: int, capacity: int = 16, device=None
                  ) -> TrajectoryHistory:
    """An empty ring of `capacity` points an object: 16 by default, where
    classification reads the recent window; the reference keeps 100
    (collision_detection.py:538-539). On the card unless `device` names
    another."""
    device = resolve_device(device)
    return TrajectoryHistory(
        pos=torch.zeros((n, capacity, 3), dtype=torch.float32, device=device),
        t=torch.full((n, capacity), float("-inf"), dtype=torch.float32,
                     device=device),
        count=torch.zeros((n,), dtype=torch.int32, device=device),
        head=torch.zeros((n,), dtype=torch.int32, device=device),
    )


def history_from_jax_numpy(d: Mapping[str, np.ndarray], device=None
                           ) -> TrajectoryHistory:
    """The port's history from the JAX TrajectoryHistory's fields given as
    numpy arrays ({'pos': ..., 't': ..., 'count': ..., 'head': ...}), on
    the card unless `device` names another."""
    missing = [f for f in HISTORY_FIELDS if f not in d]
    if missing:
        raise ValueError(f"JAX history fields missing: {missing}")
    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return TrajectoryHistory(pos=f32(d["pos"]), t=f32(d["t"]),
                             count=i32(d["count"]), head=i32(d["head"]))


@traced("tc.history")
def update_history(hist: TrajectoryHistory, state: ObjectState,
                   timestamp) -> TrajectoryHistory:
    """Append the fleet's current positions, one write per alive object
    (reference update_trajectory). Returns a new history; the old one is
    left as it was. The timestamp's copy to the device is a host wait on a
    card (core/device.host_tensor)."""
    n, h = hist.t.shape
    dev = hist.t.device
    rows = torch.arange(n, device=dev)
    head = hist.head.to(torch.int64)
    alive = state.alive
    ts = host_tensor(timestamp, torch.float32, dev)
    pos = hist.pos.clone()
    t = hist.t.clone()
    pos[rows, head] = torch.where(alive[:, None], state.pos, pos[rows, head])
    t[rows, head] = torch.where(alive, ts.expand(n), t[rows, head])
    new_head = torch.where(alive, (hist.head + 1) % h, hist.head)
    count = torch.where(alive, torch.clamp_max(hist.count + 1, h), hist.count)
    return TrajectoryHistory(pos=pos, t=t, count=count.to(torch.int32),
                             head=new_head.to(torch.int32))


def _chronological(hist: TrajectoryHistory):
    """The rings unrolled into time order: (pos [N, H, 3], t [N, H],
    valid [N, H]), oldest first."""
    n, h = hist.t.shape
    dev = hist.t.device
    slots = torch.arange(h, device=dev)
    # the oldest sample sits at `head` when the ring is full, else at 0
    start = torch.where(hist.count >= h, hist.head,
                        torch.zeros_like(hist.head)).to(torch.int64)
    order = (start[:, None] + slots[None, :]) % h
    rows = torch.arange(n, device=dev)[:, None]
    valid = slots[None, :] < hist.count[:, None]
    return hist.pos[rows, order], hist.t[rows, order], valid


@traced("tc.classify")
def classify_trajectories(hist: TrajectoryHistory) -> torch.Tensor:
    """[N] int32 trajectory class from history-averaged speed and
    acceleration (reference _analyze_trajectory_pattern)."""
    pos, t, valid = _chronological(hist)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    dt = t[:, 1:] - t[:, :-1]                                # [N, H-1]
    vpair = valid[:, 1:] & valid[:, :-1] & (dt > 0)
    dt_safe = torch.where(vpair, dt, one)
    vel = (pos[:, 1:] - pos[:, :-1]) / dt_safe[..., None]
    vel = torch.where(vpair[..., None], vel, torch.zeros_like(vel))
    nv = vpair.sum(dim=1)
    avg_vel = vel.sum(dim=1) / torch.clamp_min(nv, 1)[:, None]

    dtv = t[:, 2:] - t[:, 1:-1]
    apair = vpair[:, 1:] & vpair[:, :-1] & (dtv > 0)
    dtv_safe = torch.where(apair, dtv, one)
    acc = (vel[:, 1:] - vel[:, :-1]) / dtv_safe[..., None]
    acc = torch.where(apair[..., None], acc, torch.zeros_like(acc))
    na = apair.sum(dim=1)
    avg_acc = acc.sum(dim=1) / torch.clamp_min(na, 1)[:, None]

    speed = _norm(avg_vel)
    accel = _norm(avg_acc)
    cls = torch.where(speed < 0.1, CLASS_STATIONARY,
                      torch.where(accel < 0.1, CLASS_CONST_VEL, CLASS_ACCEL))
    # no velocity pairs at all -> stationary (reference :695-696)
    return torch.where(nv == 0, CLASS_STATIONARY, cls).to(torch.int32)


def needs_fallback(hist: TrajectoryHistory) -> torch.Tensor:
    """[N] bool: fewer than 2 samples; the caller runs the plain detector
    for these rows (reference :590-592)."""
    return hist.count < 2


def class_advance(pos, vel, acc, cls, t) -> torch.Tensor:
    """Class-dependent future position at offset t, with the expressions
    and order of the reference (_predict_future_trajectory): p + v t, then
    + 0.5 a t t. pos/vel/acc [*, 3], cls [*]; `t` is a 0-dim f32 tensor or
    broadcasts against pos."""
    p_cv = pos + vel * t
    p_acc = p_cv + 0.5 * acc * t * t
    c = cls[..., None]
    return torch.where(c == CLASS_STATIONARY, pos,
                       torch.where(c == CLASS_CONST_VEL, p_cv, p_acc))


def _predicted_position(state: ObjectState, cls: torch.Tensor,
                        t) -> torch.Tensor:
    """[N, 3] class-predicted positions of the fleet at offset t."""
    return class_advance(state.pos, state.vel, state.acc, cls, t)


def predict_offsets(horizon: float, step: float) -> list:
    """The offsets 0, step, ... below horizon, as f32 values (the
    reference's jnp.arange(0.0, horizon, step, dtype=float32))."""
    return [float(o) for o in np.arange(0.0, horizon, step,
                                        dtype=np.float32)]


def sub_window_config(det, sub_window: float):
    """The detection config of the prediction sweep: the sampled sweep runs
    over `sub_window` seconds."""
    return dataclasses.replace(det, time_window=sub_window)


def predict_pair_risks(o: PairSide, c: PairSide, pred, t, det, sub_det):
    """(hit, risk, ttc, dist) of pairs (o, c) at offset t (broadcasting
    against the sides' scalars): the own object at its class-predicted
    position `pred`, the candidate advanced to t under constant
    acceleration (reference _detect_at_position :808-812), the stage-1
    radius on the candidate's CURRENT position (the reference's quirk of
    querying today's index with tomorrow's position, :800-803), the sampled
    sweep over sub_det's window and the stage-4 risk. risk 0, ttc (counted
    from now, t_hit + t) and dist inf where no hit."""
    tb = t[..., None]
    o_pos = c.pos + c.vel * tb + 0.5 * c.acc * tb * tb
    ok = (o.alive & c.alive & (o.id != c.id)
          & (_norm(c.pos - pred) <= det.search_radius))
    safe = _pair_safe_distance(o.size, c.size, det)
    sep_vel = c.vel - o.vel
    hit, t_hit, d_hit = _precise_sweep(o_pos - pred, sep_vel, c.acc - o.acc,
                                       safe, sub_det)
    hit = hit & ok
    zero = torch.zeros_like(t_hit)
    inf = torch.full_like(t_hit, float("inf"))
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), _norm(sep_vel),
                       o.heading, c.heading, o.otype, c.otype, safe, det)
    return (hit, torch.where(hit, risk, zero),
            torch.where(hit, t_hit + t, inf), torch.where(hit, d_hit, inf))


def predict_collisions(state: ObjectState, hist: TrajectoryHistory,
                       index: GridIndex, cfg: SystemConfig,
                       horizon: float = 10.0, step: float = 0.5,
                       sub_window: float = 1.0, merge_k: int = 32):
    """Predicted risks over the grid, merged per pair keeping the max risk.

    Returns (other [N, merge_k] state indices, valid, risk, ttc, distance).
    Candidates beyond a bucket's cell_capacity are not seen (counted by
    engine.grid_overflow). Runs one offset at a time."""
    det = cfg.detect
    n = state.n
    dev = state.device
    cls = classify_trajectories(hist)
    sub_det = sub_window_config(det, sub_window)
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    side = lambda i, alive, ids: PairSide(
        pos=state.pos[i], vel=state.vel[i], acc=state.acc[i],
        size=state.size[i], heading=state.heading[i],
        otype=state.otype[i], alive=alive, id=ids)
    own = side(np.s_[:, None], state.alive[:, None], rows)
    cols = []
    for o in predict_offsets(horizon, step):
        offset = torch.tensor(o, dtype=torch.float32, device=dev)
        pred_pos = _predicted_position(state, cls, offset)
        cand, ok = gather_candidates(index, cell_coords(pred_pos, cfg), cfg)
        c = cand.to(torch.int64)
        cols.append((cand,) + predict_pair_risks(
            own, side(c, ok & state.alive[c], cand), pred_pos[:, None, :],
            offset, det, sub_det))
    # per offset [N, K] -> [N, P*K], offset-major columns
    merged = [torch.cat([col[j] for col in cols], dim=1) for j in range(5)]
    return merge_pair_risks(*merged, merge_k)


def merge_pair_risks(cand, hit, risk, ttc, dist, merge_k: int,
                     return_kth: bool = False):
    """Top merge_k by risk per object, then dedup by other id keeping the
    max-risk occurrence (reference _merge_collision_risks). Inputs are
    [N, M] per-object candidate records; ties in the top merge_k break by
    the lower column, as in the reference's top_k.

    return_kth: also return the pre-dedup merge_k-th pool risk per object
    ([N] f32, -1.0 where fewer than merge_k hits exist), which the fused
    path's truncation certificate compares against."""
    n, m = cand.shape
    dev = cand.device
    if m < merge_k:
        # fewer columns than the merge width: pad with invalid entries so
        # the [N, merge_k] output contract holds
        pad = merge_k - m
        padf = lambda a, v: torch.cat(
            [a, torch.full((n, pad), v, dtype=a.dtype, device=dev)], dim=1)
        cand, hit = padf(cand, 0), padf(hit, False)
        risk, ttc, dist = (padf(risk, 0.0), padf(ttc, float("inf")),
                           padf(dist, float("inf")))
    neg_one = torch.full_like(risk, -1.0)
    top_risk, top_i = stable_topk(torch.where(hit, risk, neg_one), merge_k,
                                  dim=1)
    top_other = cand.gather(1, top_i)
    top_valid = top_risk >= 0.0
    big = torch.iinfo(torch.int32).max
    srt = torch.sort(torch.where(top_valid, top_other,
                                 torch.full_like(top_other, big)),
                     dim=1, stable=True).indices
    o_s = top_other.gather(1, srt)
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                     o_s[:, 1:] == o_s[:, :-1]], dim=1)
    # risks within runs of equal other id are not risk-sorted after the id
    # sort: take the run's max, then its first max-risk member's ttc/dist
    r_s = top_risk.gather(1, srt)
    t_s = ttc.gather(1, top_i).gather(1, srt)
    d_s = dist.gather(1, top_i).gather(1, srt)
    v_s = top_valid.gather(1, srt)

    run_id = torch.cumsum((~dup).to(torch.int64), dim=1) - 1
    neg = torch.where(v_s, r_s, torch.full_like(r_s, -1.0))
    run_max = torch.full((n, merge_k), -1.0, dtype=risk.dtype,
                         device=dev).scatter_reduce(1, run_id, neg, "amax")
    rmax_here = run_max.gather(1, run_id)
    valid_out = ~dup & (rmax_here >= 0.0)
    risk_out = torch.where(valid_out, rmax_here, torch.zeros_like(rmax_here))

    pos_in_row = torch.arange(merge_k, device=dev).expand(n, merge_k)
    best_pos = torch.where(v_s & (neg >= rmax_here), pos_in_row,
                           torch.full_like(pos_in_row, merge_k))
    run_best = torch.full((n, merge_k), merge_k, dtype=torch.int64,
                          device=dev).scatter_reduce(1, run_id, best_pos,
                                                     "amin")
    sel = torch.clamp(run_best.gather(1, run_id), 0, merge_k - 1)
    inf = torch.full_like(t_s, float("inf"))
    merged = (torch.where(valid_out, o_s, torch.zeros_like(o_s)), valid_out,
              risk_out, torch.where(valid_out, t_s.gather(1, sel), inf),
              torch.where(valid_out, d_s.gather(1, sel), inf))
    if return_kth:
        return merged + (top_risk[:, -1],)
    return merged
