"""The 4-stage detection pipeline (the port of
tpu_collide/detect/pipeline.py).

  stage 1  spatial filter: grid-stencil candidates, exact radius, no self
  stage 2  temporal filter: rel-speed floor, closest-approach time t*,
           window clip, closest distance against the pair's safe distance
  stage 3  precise: first sample t = 0, dt, ... with dist <= safe under
           constant acceleration; fast: the closed-form constant-velocity
           first crossing, snapped up to the dt lattice
  stage 4  weighted risk

`detect_pairs` / `detect_rows` run the stages over each object's grid
candidates ([N, K] tables, the reference-shaped path of engine.step). The
refine tail (kernels/refine.py) runs the stage functions on the few pairs
that become alerts; the fused kernel carries its own copy of the stage math
in the kernel's order (kernels/fused_detect.py).
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor
from tpu_collide_torch.core.ops import stable_topk
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import span
from tpu_collide_torch.index.grid import GridIndex, gather_candidates


@dataclasses.dataclass(frozen=True)
class PairRisks:
    """Per-object candidate risk table, fixed shape [Q, K].

    valid rows carry a detected risk; the rest is padding (risk 0, ttc inf).
    survivor_overflow counts stage-2 survivors beyond cfg.survivor_cap whose
    stage-3 sweep was skipped (0 in fast mode and whenever the cap holds);
    num_checked counts candidate pairs that passed stage 1 (alive, not
    self, within search_radius)."""
    other: torch.Tensor      # [Q, K] int32 other-object index
    valid: torch.Tensor      # [Q, K] bool
    risk: torch.Tensor       # [Q, K] f32 in [0, 1]
    ttc: torch.Tensor        # [Q, K] f32 seconds (inf when invalid)
    distance: torch.Tensor   # [Q, K] f32 distance at collision time
    rel_speed: torch.Tensor  # [Q, K] f32
    col_pos: torch.Tensor    # [Q, K, 3] f32 midpoint at collision time
    survivor_overflow: torch.Tensor   # [] int32
    num_checked: torch.Tensor         # [] int32


def _pair_safe_distance(size_i, size_j, det):
    return (size_i + size_j) * 0.5 + det.safe_distance_base


def _norm(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(d * d, dim=-1))


def _dist_at_time(rel_pos, rel_vel, rel_acc, t):
    """|rel_pos + rel_vel t + 0.5 rel_acc t^2| (constant acceleration)."""
    d = (rel_pos + rel_vel * t[..., None]
         + 0.5 * rel_acc * torch.square(t)[..., None])
    return _norm(d)


def _precise_sweep(rel_pos, rel_vel, rel_acc, safe, det):
    """Stage-3 sampled sweep over t = f32(k) * dt, k = 0..T-1, in float32.
    Returns (hit, t_hit, dist_hit) of the FIRST sample with dist <= safe
    (inf where none). Samples are evaluated in chunks whose [C, P, 3]
    temporary stays near 32M elements."""
    T = det.num_time_steps
    dt = det.time_step
    lead = rel_pos.shape[:-1]
    p = max(1, lead.numel())
    C = max(1, min(T, int(32e6 // p)))
    dev = rel_pos.device
    hit = torch.zeros(lead, dtype=torch.bool, device=dev)
    t_hit = torch.full(lead, float("inf"), dtype=torch.float32, device=dev)
    d_hit = torch.full(lead, float("inf"), dtype=torch.float32, device=dev)
    view = (-1,) + (1,) * len(lead)
    with span("tc.precise_sweep"):
        for k0 in range(0, T, C):
            k = torch.arange(k0, min(k0 + C, T), dtype=torch.int32,
                             device=dev)
            t = (k.to(torch.float32) * dt).reshape(view).expand(
                (k.numel(),) + tuple(lead))
            d = _dist_at_time(rel_pos[None], rel_vel[None], rel_acc[None], t)
            inside = d <= safe[None]
            has = inside.any(dim=0)
            first = torch.argmax(inside.to(torch.int8), dim=0, keepdim=True)
            new = has & ~hit
            t_hit = torch.where(new, torch.gather(t, 0, first)[0], t_hit)
            d_hit = torch.where(new, torch.gather(d, 0, first)[0], d_hit)
            hit = hit | new
    return hit, t_hit, d_hit


def _fast_first_crossing(rel_pos, rel_vel, safe, det):
    """Closed-form constant-velocity first time with dist <= safe, snapped up
    to the stage-3 sampling lattice."""
    a = torch.sum(rel_vel * rel_vel, dim=-1)
    b = 2.0 * torch.sum(rel_pos * rel_vel, dim=-1)
    c = torch.sum(rel_pos * rel_pos, dim=-1) - safe * safe
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    a_safe = torch.where(a > 1e-12, a, torch.ones_like(a))
    t_enter = (-b - sq) / (2.0 * a_safe)
    t_exit = (-b + sq) / (2.0 * a_safe)
    already_inside = c <= 0.0
    t_first = torch.where(already_inside, torch.zeros_like(t_enter),
                          torch.clamp_min(t_enter, 0.0))
    dt = det.time_step
    dt_t = host_tensor(dt, torch.float32, rel_pos.device)
    t_snap = torch.ceil(t_first / dt_t - 1e-6) * dt
    inside_at_snap = already_inside | ((t_snap >= t_enter - 1e-6)
                                       & (t_snap <= t_exit + 1e-6))
    hit = (((disc >= 0.0) | already_inside) & (a > 1e-12) & inside_at_snap
           & (t_snap <= det.time_window - dt + 1e-6))
    hit = hit | (already_inside & (a <= 1e-12))
    t_hit = torch.where(already_inside, torch.zeros_like(t_snap), t_snap)
    d_hit = _dist_at_time(rel_pos, rel_vel, torch.zeros_like(rel_pos), t_hit)
    inf = torch.full_like(t_hit, float("inf"))
    return hit, torch.where(hit, t_hit, inf), torch.where(hit, d_hit, inf)


def _angle_factor(heading_i, heading_j, det):
    """sin(|hi - hj|): literal ('direct') or via the angle-difference
    identity ('product', DEVIATIONS #18)."""
    if det.angle_form == "product":
        sd = (torch.sin(heading_i) * torch.cos(heading_j)
              - torch.cos(heading_i) * torch.sin(heading_j))
        return torch.where(heading_i >= heading_j, sd, -sd)
    return torch.sin(torch.abs(heading_i - heading_j))


def _risk_score(dist_hit, t_hit, rel_speed, heading_i, heading_j,
                type_i, type_j, safe, det):
    """Stage-4 weighted risk, clipped to [0, 1]."""
    dev = dist_hit.device
    mwt = host_tensor(det.max_warning_time, torch.float32, dev)
    mrs = host_tensor(det.max_relative_speed, torch.float32, dev)
    distance_factor = 1.0 - dist_hit / safe
    time_factor = 1.0 - torch.clamp_max(t_hit / mwt, 1.0)
    speed_factor = torch.clamp_max(rel_speed / mrs, 1.0)
    angle_factor = _angle_factor(heading_i, heading_j, det)
    type_factor = torch.where(
        type_i == type_j,
        torch.full_like(distance_factor, det.same_type_factor),
        torch.full_like(distance_factor, det.diff_type_factor))
    risk = (det.weight_distance * distance_factor
            + det.weight_time * time_factor
            + det.weight_speed * speed_factor
            + det.weight_angle * angle_factor
            + det.weight_type * type_factor)
    return torch.clamp(risk, 0.0, 1.0)


def detect_pairs(state: ObjectState, index: GridIndex,
                 cfg: SystemConfig) -> PairRisks:
    """Stages 1-4 for every alive object against its grid candidates."""
    return detect_rows(state, index, cfg,
                       torch.arange(state.n, dtype=torch.int64,
                                    device=state.device))


def detect_rows(state: ObjectState, index: GridIndex, cfg: SystemConfig,
                rows: torch.Tensor,
                row_valid: torch.Tensor | None = None) -> PairRisks:
    """Stages 1-4 for the query objects `rows` ([Q] int) against the whole
    indexed fleet. `detect_pairs` is rows = arange(N); the chunked path runs
    this over row blocks, passing `row_valid` to mask its duplicated tail
    rows out of the stage-1 counter."""
    det = cfg.detect
    dev = state.device
    rows = rows.to(torch.int64)

    # ---- stage 1: spatial filtering ----
    cand, cand_ok = gather_candidates(index, index.cell3[rows], cfg)
    cand_ok = cand_ok & (cand != rows[:, None])

    # the per-object fields packed into one [N, 13] matrix, one row gather
    # per side (otype and alive cast exactly to f32)
    fmat = torch.cat(
        [state.pos, state.vel, state.acc, state.size[:, None],
         state.heading[:, None], state.otype.to(torch.float32)[:, None],
         state.alive.to(torch.float32)[:, None]], dim=1)
    fo = fmat[rows][:, None, :]              # [Q, 1, 13]
    fc = fmat[cand.to(torch.int64)]          # [Q, K, 13]

    cand_ok = cand_ok & (fc[..., 12] > 0.5) & (fo[..., 12] > 0.5)
    if row_valid is not None:
        cand_ok = cand_ok & row_valid[:, None]

    pos_i, pos_j = fo[..., 0:3], fc[..., 0:3]
    cand_ok = cand_ok & (_norm(pos_j - pos_i) <= det.search_radius)

    # ---- stage 2: temporal filtering ----
    vel_i, vel_j = fo[..., 3:6], fc[..., 3:6]
    acc_i, acc_j = fo[..., 6:9], fc[..., 6:9]
    rel_vel = vel_i - vel_j                  # vehicle minus other
    rel_pos = pos_j - pos_i                  # other minus vehicle
    rel_speed = _norm(rel_vel)
    safe = _pair_safe_distance(fo[..., 9], fc[..., 9], det)

    # closest approach of s(t) = rel_pos + (v_j - v_i) t; 'reference' keeps
    # the reference's sign bug (DEVIATIONS.md #1)
    sep_vel = vel_j - vel_i
    sep_acc = acc_j - acc_i
    conv = 1.0 if det.convention == "physical" else -1.0
    dot = conv * torch.sum(rel_pos * sep_vel, dim=-1)
    rs2 = torch.where(rel_speed > 0, rel_speed * rel_speed,
                      torch.ones_like(rel_speed))
    t_star = -dot / rs2
    closest = _dist_at_time(rel_pos, sep_vel, sep_acc, t_star)
    pass2 = (cand_ok
             & (rel_speed >= det.min_relative_speed)
             & (t_star >= 0.0)
             & (t_star <= det.time_window)
             & (closest <= safe))

    # ---- stage 3 ----
    surv_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if det.mode == "fast":
        hit, t_hit, d_hit = _fast_first_crossing(rel_pos, sep_vel, safe, det)
        hit = hit & pass2
    else:
        # the sampled sweep runs on the first `cap` stage-2 survivors in
        # index order (jax.lax.top_k of the 0/1 mask breaks ties by the
        # lower index; stable_topk does the same)
        q, k = pass2.shape
        cap = min(cfg.survivor_cap, q * k)
        flat2 = pass2.reshape(-1)
        surv_overflow = torch.clamp_min(
            flat2.sum(dtype=torch.int32) - cap, 0)
        _, surv_idx = stable_topk(flat2.to(torch.int32), cap)
        g = lambda a: a.reshape(q * k, *a.shape[2:])[surv_idx]
        s_hit, s_t, s_d = _precise_sweep(g(rel_pos), g(sep_vel), g(sep_acc),
                                         g(safe), det)
        s_hit = s_hit & flat2[surv_idx]
        inf = torch.full_like(s_t, float("inf"))
        hit = torch.zeros(q * k, dtype=torch.bool, device=dev)
        hit[surv_idx] = s_hit
        t_hit = torch.full((q * k,), float("inf"), device=dev)
        t_hit[surv_idx] = torch.where(s_hit, s_t, inf)
        d_hit = torch.full((q * k,), float("inf"), device=dev)
        d_hit[surv_idx] = torch.where(s_hit, s_d, inf)
        hit, t_hit, d_hit = (x.reshape(q, k) for x in (hit, t_hit, d_hit))

    # collision position: midpoint of the two predicted positions
    zero = torch.zeros_like(t_hit)
    t_h = torch.where(hit, t_hit, zero)[..., None]
    fut_i = pos_i + vel_i * t_h + 0.5 * acc_i * t_h * t_h
    fut_j = pos_j + vel_j * t_h + 0.5 * acc_j * t_h * t_h
    col_pos = 0.5 * (fut_i + fut_j)

    # ---- stage 4: risk assessment ----
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), rel_speed,
                       fo[..., 10], fc[..., 10], fo[..., 11], fc[..., 11],
                       safe, det)
    inf = torch.full_like(t_hit, float("inf"))
    return PairRisks(
        other=cand, valid=hit, risk=torch.where(hit, risk, zero),
        ttc=torch.where(hit, t_hit, inf),
        distance=torch.where(hit, d_hit, inf),
        rel_speed=torch.where(hit, rel_speed, zero),
        col_pos=col_pos,
        survivor_overflow=surv_overflow.to(torch.int32),
        num_checked=cand_ok.sum(dtype=torch.int32),
    )
