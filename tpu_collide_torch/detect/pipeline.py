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
refine tail (kernels/refine.py) runs them on the few pairs that become
alerts ([P] lists). Both take stages 1-2 from `pair_stage2` and stage 4 and
the alert payload from `pair_payload`, and run stage 3 between the two; the
fused kernel carries its own copy of the stage math in the kernel's order
(kernels/fused_detect.py).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor
from tpu_collide_torch.core.ops import stable_topk
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import span
from tpu_collide_torch.index.grid import GridIndex, gather_candidates
from tpu_collide_torch.kernels._build import _check_inputs, launch


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
    (inf where none). rel_pos, rel_vel, rel_acc [..., D] (D 2 or 3), safe
    [...]. CUDA tensors launch the kernel (precise_sweep_kernel,
    csrc/precise_sweep.cu) or raise; CPU tensors take precise_sweep_plain.
    Both give the same bits on the card."""
    dev = rel_pos.device
    with span("tc.precise_sweep"):
        if dev.type == "cuda":
            return precise_sweep_kernel(rel_pos, rel_vel, rel_acc, safe, det)
        if dev.type == "cpu":
            return precise_sweep_plain(rel_pos, rel_vel, rel_acc, safe, det)
    raise ValueError(f"_precise_sweep has no kernel for device {dev}")


def precise_sweep_plain(rel_pos, rel_vel, rel_acc, safe, det):
    """_precise_sweep in plain PyTorch on any device. Samples are evaluated
    in chunks whose [C, P, 3] temporary stays near 32M elements."""
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
    for k0 in range(0, T, C):
        k = torch.arange(k0, min(k0 + C, T), dtype=torch.int32, device=dev)
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


# samples the kernel's float sample counter counts exactly
SWEEP_STEPS_MAX = 1 << 24


def precise_sweep_kernel(rel_pos, rel_vel, rel_acc, safe, det):
    """_precise_sweep as one launch of csrc/precise_sweep.cu on the card:
    a thread a record, each swept in registers to its first hit. Counts
    each launch in `precise_sweep_kernel.launches`."""
    dev = rel_pos.device
    lead = tuple(rel_pos.shape[:-1])
    dims = rel_pos.shape[-1] if rel_pos.dim() else 0
    steps = det.num_time_steps
    if dev.type != "cuda" or dims not in (2, 3) or steps > SWEEP_STEPS_MAX:
        raise ValueError(
            f"precise_sweep_kernel: no sweep of {steps} samples over "
            f"{tuple(rel_pos.shape)} records on {dev}")
    _check_inputs("precise_sweep_kernel", dev, (
        ("rel_pos", rel_pos, torch.float32, lead + (dims,)),
        ("rel_vel", rel_vel, torch.float32, lead + (dims,)),
        ("rel_acc", rel_acc, torch.float32, lead + (dims,)),
        ("safe", safe, torch.float32, lead)))
    hit = torch.empty(lead, dtype=torch.bool, device=dev)
    t_hit = torch.empty(lead, dtype=torch.float32, device=dev)
    d_hit = torch.empty(lead, dtype=torch.float32, device=dev)
    p = safe.numel()
    if p == 0:
        return hit, t_hit, d_hit
    launch("precise_sweep", "tc_precise_sweep", dev,
           rel_pos.data_ptr(), rel_vel.data_ptr(), rel_acc.data_ptr(),
           safe.data_ptr(), p, dims, steps, det.time_step, hit.data_ptr(),
           t_hit.data_ptr(), d_hit.data_ptr())
    precise_sweep_kernel.launches += 1
    return hit, t_hit, d_hit


precise_sweep_kernel.launches = 0


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


class PairSide(NamedTuple):
    """One side of a set of pairs, as tensors that broadcast against the
    other side's: [P] lists, or [Q, 1] against [Q, K] tables (pos, vel and
    acc with a last dimension of 3). `alive` is False for a dead object or
    a table's padding entry; two sides with equal `id` are one object."""
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    size: torch.Tensor
    heading: torch.Tensor
    otype: torch.Tensor
    alive: torch.Tensor
    id: torch.Tensor


class Stage2(NamedTuple):
    """The terms of pairs (o, c) after stages 1-2 (pair_stage2)."""
    rel_pos: torch.Tensor    # c.pos - o.pos
    sep_vel: torch.Tensor    # c.vel - o.vel
    sep_acc: torch.Tensor    # c.acc - o.acc
    rel_speed: torch.Tensor  # |sep_vel|
    safe: torch.Tensor       # the pair's safe distance
    ok1: torch.Tensor        # stage 1: alive, distinct, within search_radius
    pass2: torch.Tensor      # stages 1 and 2


def pair_stage2(o: PairSide, c: PairSide, det) -> Stage2:
    """Stages 1-2 of pairs (o, c): both alive, distinct and within
    search_radius; then the rel-speed floor and the closest approach of
    s(t) = rel_pos + sep_vel t + sep_acc t^2 / 2 within the window and the
    safe distance."""
    rel_pos = c.pos - o.pos
    ok1 = (o.alive & c.alive & (o.id != c.id)
           & (_norm(rel_pos) <= det.search_radius))
    sep_vel = c.vel - o.vel
    sep_acc = c.acc - o.acc
    rel_speed = _norm(sep_vel)
    safe = _pair_safe_distance(o.size, c.size, det)
    # 'reference' keeps the reference's sign bug (DEVIATIONS.md #1)
    conv = 1.0 if det.convention == "physical" else -1.0
    dot = conv * torch.sum(rel_pos * sep_vel, dim=-1)
    rs2 = torch.where(rel_speed > 0, rel_speed * rel_speed,
                      torch.ones_like(rel_speed))
    t_star = -dot / rs2
    closest = _dist_at_time(rel_pos, sep_vel, sep_acc, t_star)
    pass2 = (ok1 & (rel_speed >= det.min_relative_speed)
             & (t_star >= 0.0) & (t_star <= det.time_window)
             & (closest <= safe))
    return Stage2(rel_pos, sep_vel, sep_acc, rel_speed, safe, ok1, pass2)


def pair_payload(o: PairSide, c: PairSide, s2: Stage2, hit, t_hit, d_hit,
                 det) -> dict:
    """Stage 4 of pairs (o, c) whose stage 3 gave (hit, t_hit, d_hit), as
    {risk, ttc, distance, rel_speed, col_pos}: risk and rel_speed 0, ttc
    and distance (at collision time) inf where no hit; col_pos [..., 3] the
    midpoint of the two predicted positions at t_hit (at t = 0 where no
    hit)."""
    zero = torch.zeros_like(t_hit)
    t_h = torch.where(hit, t_hit, zero)[..., None]
    fut_o = o.pos + o.vel * t_h + 0.5 * o.acc * t_h * t_h
    fut_c = c.pos + c.vel * t_h + 0.5 * c.acc * t_h * t_h
    col_pos = 0.5 * (fut_o + fut_c)
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), s2.rel_speed,
                       o.heading, c.heading, o.otype, c.otype, s2.safe, det)
    inf = torch.full_like(t_hit, float("inf"))
    return dict(risk=torch.where(hit, risk, zero),
                ttc=torch.where(hit, t_hit, inf),
                distance=torch.where(hit, d_hit, inf),
                rel_speed=torch.where(hit, s2.rel_speed, zero),
                col_pos=col_pos)


def detect_pairs(state: ObjectState, index: GridIndex,
                 cfg: SystemConfig) -> PairRisks:
    """Stages 1-4 for every alive object against its grid candidates."""
    return detect_rows(state, index, cfg,
                       torch.arange(state.n, dtype=torch.int64,
                                    device=state.device))


# detect_rows packs each object's fields into one [N, 13] f32 record
# (otype and alive cast exactly), so that each side takes one row gather
_POS, _VEL, _ACC = slice(0, 3), slice(3, 6), slice(6, 9)
_SIZE, _HEADING, _OTYPE, _ALIVE = 9, 10, 11, 12


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

    cand, cand_ok = gather_candidates(index, index.cell3[rows], cfg)
    rec = torch.cat(
        [state.pos, state.vel, state.acc, state.size[:, None],
         state.heading[:, None], state.otype.to(torch.float32)[:, None],
         state.alive.to(torch.float32)[:, None]], dim=1)
    fo = rec[rows][:, None, :]               # [Q, 1, 13]
    fc = rec[cand.to(torch.int64)]           # [Q, K, 13]
    alive_o = fo[..., _ALIVE] > 0.5
    if row_valid is not None:
        alive_o = alive_o & row_valid[:, None]
    side = lambda f, alive, ids: PairSide(
        pos=f[..., _POS], vel=f[..., _VEL], acc=f[..., _ACC],
        size=f[..., _SIZE], heading=f[..., _HEADING], otype=f[..., _OTYPE],
        alive=alive, id=ids)
    o = side(fo, alive_o, rows[:, None])
    c = side(fc, cand_ok & (fc[..., _ALIVE] > 0.5), cand)
    s2 = pair_stage2(o, c, det)

    # ---- stage 3 ----
    surv_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if det.mode == "fast":
        hit, t_hit, d_hit = _fast_first_crossing(s2.rel_pos, s2.sep_vel,
                                                 s2.safe, det)
        hit = hit & s2.pass2
    else:
        # the sampled sweep runs on the first `cap` stage-2 survivors in
        # index order (jax.lax.top_k of the 0/1 mask breaks ties by the
        # lower index; stable_topk does the same)
        q, k = s2.pass2.shape
        cap = min(cfg.survivor_cap, q * k)
        flat2 = s2.pass2.reshape(-1)
        surv_overflow = torch.clamp_min(
            flat2.sum(dtype=torch.int32) - cap, 0)
        _, surv_idx = stable_topk(flat2.to(torch.int32), cap)
        g = lambda a: a.reshape(q * k, *a.shape[2:])[surv_idx]
        s_hit, s_t, s_d = _precise_sweep(g(s2.rel_pos), g(s2.sep_vel),
                                         g(s2.sep_acc), g(s2.safe), det)
        s_hit = s_hit & flat2[surv_idx]
        inf = torch.full_like(s_t, float("inf"))
        hit = torch.zeros(q * k, dtype=torch.bool, device=dev)
        hit[surv_idx] = s_hit
        t_hit = torch.full((q * k,), float("inf"), device=dev)
        t_hit[surv_idx] = torch.where(s_hit, s_t, inf)
        d_hit = torch.full((q * k,), float("inf"), device=dev)
        d_hit[surv_idx] = torch.where(s_hit, s_d, inf)
        hit, t_hit, d_hit = (x.reshape(q, k) for x in (hit, t_hit, d_hit))

    return PairRisks(
        other=cand, valid=hit,
        **pair_payload(o, c, s2, hit, t_hit, d_hit, det),
        survivor_overflow=surv_overflow.to(torch.int32),
        num_checked=s2.ok1.sum(dtype=torch.int32),
    )
