"""Stage functions of the 4-stage detection pipeline (the port of
tpu_collide/detect/pipeline.py:64-190).

The refine tail (kernels/refine.py) runs these on the few pairs that become
alerts; the fused kernel carries its own copy of the stage math in the
kernel's order (kernels/fused_detect.py). `detect_pairs` / `detect_rows`, the
reference-shaped XLA path, are not ported yet.
"""
from __future__ import annotations

import torch


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
    dt_t = torch.tensor(dt, dtype=torch.float32, device=rel_pos.device)
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
    mwt = torch.tensor(det.max_warning_time, dtype=torch.float32, device=dev)
    mrs = torch.tensor(det.max_relative_speed, dtype=torch.float32, device=dev)
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
