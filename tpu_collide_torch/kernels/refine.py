"""The fused step's tail after the kernel's slots (the port of
tpu_collide/kernels/refine.py:1-523).

  * fast mode: the scene top-A is taken directly on the slot keys (they are
    the scene ranking key 2*priority + risk); only the selected pairs get
    their payload (ttc, distance, col_pos, ...) recomputed. Rows with more
    qualifying pairs than slots (hot rows) have their whole stencil
    neighbourhood recomputed and merged into the selection (`_hot_topup`).
  * precise mode: the slots hold stage-2 survivors; they are compacted to
    `survivor_cap` records and swept with the sampled constant-acceleration
    stage 3.

The recomputation uses the stage functions of detect/pipeline.py, so alert
values follow the reference path's math. The alert buffer always has
`max_scene_alerts` entries.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.alerts.extract import AlertBatch, compute_priority
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.detect.pipeline import (_dist_at_time,
                                               _fast_first_crossing, _norm,
                                               _pair_safe_distance,
                                               _precise_sweep, _risk_score)
from tpu_collide_torch.kernels.cell_list import CellList, FI, stencil_pairs
from tpu_collide_torch.kernels.fused_detect import KEY_NONE, fused_topk


def decode_risk(keys: torch.Tensor) -> torch.Tensor:
    """risk from an occupied fast-mode slot key: qualifying keys are
    2*priority + risk, sub-threshold keys risk - 2; both give
    risk = key - 2*floor(key/2)."""
    return keys - 2.0 * torch.floor(keys * 0.5)


@dataclasses.dataclass(frozen=True)
class RefinedPairs:
    """Recomputed detection quantities for explicit (own, cand) pairs."""
    hit: torch.Tensor        # [P] bool, stages 1-3 recomputed
    risk: torch.Tensor       # [P] f32 (0 where ~hit)
    ttc: torch.Tensor        # [P] f32 (inf where ~hit)
    distance: torch.Tensor   # [P] f32 distance at collision time
    rel_speed: torch.Tensor  # [P] f32
    col_pos: torch.Tensor    # [P, 3] f32
    priority: torch.Tensor   # [P] int32
    own_oid: torch.Tensor    # [P] int32
    cand_oid: torch.Tensor   # [P] int32


def refine_pairs(cl: CellList, own_idx: torch.Tensor, cand_idx: torch.Tensor,
                 cfg: SystemConfig, mode: str) -> RefinedPairs:
    """Stages 1-4 for pairs of sorted indices. mode='fast' uses the
    closed-form stage 3, mode='precise' the sampled sweep (run it only on
    compacted survivor lists)."""
    oi = torch.clamp(own_idx.to(torch.int64), 0, cl.n - 1)
    ci = torch.clamp(cand_idx.to(torch.int64), 0, cl.n - 1)
    alive = cl.alive
    return refine_rows(cl.fields[oi], cl.fields[ci], cl.oid[oi], cl.oid[ci],
                       alive[oi], alive[ci], cfg, mode)


def refine_rows(fo, fc, oid_o, oid_c, alive_o, alive_c, cfg: SystemConfig,
                mode: str) -> RefinedPairs:
    """Stages 1-4 on gathered [P, NF] records of each pair's two sides."""
    det = cfg.detect
    pos_o, pos_c = fo[:, 0:3], fc[:, 0:3]
    vel_o, vel_c = fo[:, 3:6], fc[:, 3:6]
    acc_o, acc_c = fo[:, 6:9], fc[:, 6:9]

    # stage 1
    rel_pos = pos_c - pos_o
    ok1 = (alive_o & alive_c & (oid_o != oid_c)
           & (_norm(rel_pos) <= det.search_radius))

    # stage 2, with the configured sign convention
    sep_vel = vel_c - vel_o
    sep_acc = acc_c - acc_o
    rel_speed = _norm(sep_vel)
    safe = _pair_safe_distance(fo[:, FI["size"]], fc[:, FI["size"]], det)
    conv = 1.0 if det.convention == "physical" else -1.0
    dot = conv * torch.sum(rel_pos * sep_vel, dim=-1)
    rs2 = torch.where(rel_speed > 0, rel_speed * rel_speed,
                      torch.ones_like(rel_speed))
    t_star = -dot / rs2
    closest = _dist_at_time(rel_pos, sep_vel, sep_acc, t_star)
    pass2 = (ok1 & (rel_speed >= det.min_relative_speed)
             & (t_star >= 0.0) & (t_star <= det.time_window)
             & (closest <= safe))

    # stage 3
    if mode == "fast":
        hit, t_hit, d_hit = _fast_first_crossing(rel_pos, sep_vel, safe, det)
    else:
        hit, t_hit, d_hit = _precise_sweep(rel_pos, sep_vel, sep_acc, safe,
                                           det)
    hit = hit & pass2

    # collision position = midpoint of the two predicted positions
    zero = torch.zeros_like(t_hit)
    t_h = torch.where(hit, t_hit, zero)[:, None]
    fut_o = pos_o + vel_o * t_h + 0.5 * acc_o * t_h * t_h
    fut_c = pos_c + vel_c * t_h + 0.5 * acc_c * t_h * t_h
    col_pos = 0.5 * (fut_o + fut_c)

    # stage 4
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), rel_speed,
                       fo[:, FI["heading"]], fc[:, FI["heading"]],
                       fo[:, FI["otype"]], fc[:, FI["otype"]], safe, det)
    inf = torch.full_like(t_hit, float("inf"))
    risk = torch.where(hit, risk, zero)
    ttc = torch.where(hit, t_hit, inf)
    return RefinedPairs(
        hit=hit, risk=risk, ttc=ttc,
        distance=torch.where(hit, d_hit, inf),
        rel_speed=torch.where(hit, rel_speed, zero),
        col_pos=col_pos, priority=compute_priority(risk, ttc, cfg),
        own_oid=oid_o, cand_oid=oid_c)


@dataclasses.dataclass(frozen=True)
class FusedSceneResult:
    alerts: AlertBatch
    num_checked: torch.Tensor     # [] int64 stage-1 pairs (-1: not counted)
    num_risks: torch.Tensor       # [] int32 per-direction detected risks
    max_risk: torch.Tensor        # [] f32
    alert_overflow: torch.Tensor  # [] int32 qualifying pairs (fast) or
                                  # survivors (precise) beyond the slots and
                                  # caps; 0 means the alert list is complete


def _alert_batch(valid, vehicle_oid, ref: RefinedPairs,
                 size: int) -> AlertBatch:
    """Alert buffer of `size` entries from the first valid.numel() selected
    pairs (the rest is invalid padding)."""
    pad = size - valid.numel()

    def col(x, fill):
        x = torch.where(valid.reshape((-1,) + (1,) * (x.dim() - 1)), x,
                        torch.full_like(x, fill))
        if pad > 0:
            x = torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                         dtype=x.dtype, device=x.device)])
        return x

    return AlertBatch(
        vehicle_oid=col(vehicle_oid.to(torch.int32), -1),
        other_oid=col(ref.cand_oid.to(torch.int32), -1),
        risk=col(ref.risk, 0.0),
        ttc=col(ref.ttc, float("inf")),
        distance=col(ref.distance, float("inf")),
        rel_speed=col(ref.rel_speed, 0.0),
        priority=col(ref.priority, 0),
        col_pos=col(ref.col_pos, 0.0),
        valid=col(valid, False),
        count=valid.sum(dtype=torch.int32),
    )


def _hot_topup(cl: CellList, cfg: SystemConfig, qual: torch.Tensor, k: int):
    """Exact top-up for hot rows (own rows with more qualifying pairs than
    the k slots). The up to `hot_topup` hottest rows get their whole stencil
    neighbourhood (the runs the kernel walks) recomputed; their pairs replace
    their slots in the scene selection. Rows beyond the cap stay counted in
    alert_overflow.

    Returns (covered [m] bool, hkey [P] f32 scene key (KEY_NONE where not
    qualifying), hown [P], hcand [P] int64 sorted indices). Waits for the
    device once, to learn whether any row is hot, and once more for the
    pair count when one is."""
    H = cfg.detect.hot_topup
    m = qual.numel()
    hot = cl.alive & (qual > k)
    hot_rank = torch.where(hot, qual.to(torch.float32),
                           torch.full_like(qual, -1, dtype=torch.float32))
    top_q, hot_rows = torch.topk(hot_rank, min(H, m))
    hot_valid = top_q > 0.0
    covered = torch.zeros((m,), dtype=torch.bool, device=qual.device)
    covered[hot_rows] = hot_valid
    rows = hot_rows[hot_valid]
    if rows.numel() == 0:
        empty = torch.zeros((0,), dtype=torch.int64, device=qual.device)
        return covered, empty.to(torch.float32), empty, empty
    hown, hcand = stencil_pairs(cl, rows)
    ref = refine_pairs(cl, hown, hcand, cfg, mode="fast")
    q = ref.hit & (ref.risk >= cfg.alerts.risk_low)
    hkey = torch.where(q, ref.priority.to(torch.float32) * 2.0 + ref.risk,
                       torch.full_like(ref.risk, KEY_NONE))
    return covered, hkey, hown, hcand


def fused_scene_fast(cl: CellList, cfg: SystemConfig,
                     topk=fused_topk) -> FusedSceneResult:
    """Fast mode after the cell list: kernel slots -> scene top-A on the slot
    keys (plus hot rows) -> refine the selected pairs -> AlertBatch.

    Each object's qualifying pairs enter from its own side, so both
    directions of a pair may appear. `topk` is the slot function
    (fused_topk; fused_topk_plain to compare the two on one device)."""
    s = topk(cl, cfg, mode="hits")
    keys, idx = s.keys, s.idx
    m, k = keys.shape
    own = cl.alive
    occupied = idx >= 0
    if cfg.detect.hot_topup > 0:
        covered, hkey, hown, hcand = _hot_topup(cl, cfg, s.qual, k)
    else:
        covered = torch.zeros((m,), dtype=torch.bool, device=keys.device)
        hkey = keys.new_zeros((0,))
    sel = torch.where(own[:, None] & occupied & ~covered[:, None], keys,
                      torch.full_like(keys, KEY_NONE))
    allk = torch.cat([sel.reshape(-1), hkey])
    a = min(cfg.alerts.max_scene_alerts, allk.numel())
    top_key, top_i = torch.topk(allk, a)
    valid = top_key >= 0.0                       # qualifying keys only
    mk = m * k
    flat_slot = torch.clamp(top_i, max=mk - 1)
    own_slot = flat_slot // k
    cand_idx = idx.reshape(-1)[flat_slot].to(torch.int64)
    if hkey.numel():
        is_slot = top_i < mk
        hj = torch.clamp(top_i - mk, 0, hkey.numel() - 1)
        own_slot = torch.where(is_slot, own_slot, hown[hj])
        cand_idx = torch.where(is_slot, cand_idx, hcand[hj])
    ref = refine_pairs(cl, own_slot, cand_idx, cfg, mode="fast")
    valid = valid & ref.hit & (ref.risk >= cfg.alerts.risk_low)
    alerts = _alert_batch(valid, cl.oid[own_slot], ref,
                          cfg.alerts.max_scene_alerts)

    slot_risk = torch.where(occupied, decode_risk(keys),
                            torch.zeros_like(keys))
    zero = torch.zeros_like(s.qual)
    return FusedSceneResult(
        alerts=alerts,
        num_checked=s.checked,
        num_risks=torch.where(own, s.emitted, zero).sum(dtype=torch.int32),
        max_risk=slot_risk.max() if slot_risk.numel() else keys.new_zeros(()),
        alert_overflow=torch.where(
            own & ~covered, torch.clamp_min(s.qual - k, 0),
            zero).sum(dtype=torch.int32),
    )


def fused_scene_precise(cl: CellList, cfg: SystemConfig,
                        topk=fused_topk) -> FusedSceneResult:
    """Precise mode: kernel survivor slots -> compaction to survivor_cap
    records -> sampled constant-acceleration sweep and risk -> scene
    top-A."""
    s = topk(cl, cfg, mode="survivors")
    keys, idx = s.keys, s.idx
    m, k = keys.shape
    own = cl.alive
    occupied = (idx >= 0) & own[:, None]
    sel = torch.where(occupied, keys, torch.full_like(keys, KEY_NONE))
    cap = min(cfg.survivor_cap, m * k)
    top_key, top_flat = torch.topk(sel.reshape(-1), cap)
    svalid = top_key >= 0.0                 # survivor keys lie in [0, 1]
    own_slot = top_flat // k
    cand_idx = idx.reshape(-1)[top_flat]
    ref = refine_pairs(cl, own_slot, cand_idx, cfg, mode="precise")
    hit = ref.hit & svalid
    zero = torch.zeros_like(ref.risk)
    inf = torch.full_like(ref.risk, float("inf"))
    ref = dataclasses.replace(
        ref, hit=hit,
        risk=torch.where(hit, ref.risk, zero),
        ttc=torch.where(hit, ref.ttc, inf),
        distance=torch.where(hit, ref.distance, inf),
        rel_speed=torch.where(hit, ref.rel_speed, zero),
        priority=torch.where(hit, ref.priority,
                             torch.zeros_like(ref.priority)))

    # scene top-A over the swept records, on the reference ranking key
    keep = hit & (ref.risk >= cfg.alerts.risk_low)
    rank = torch.where(keep, ref.priority.to(torch.float32) * 2.0 + ref.risk,
                       torch.full_like(ref.risk, -1.0))
    top_rank, sel_i = torch.topk(rank, min(cfg.alerts.max_scene_alerts, cap))
    ref_a = RefinedPairs(**{f.name: getattr(ref, f.name)[sel_i]
                            for f in dataclasses.fields(RefinedPairs)})
    alerts = _alert_batch(top_rank >= 0.0, cl.oid[own_slot][sel_i], ref_a,
                          cfg.alerts.max_scene_alerts)

    n_surv = occupied.sum(dtype=torch.int32)
    slot_overflow = torch.where(own, torch.clamp_min(s.emitted - k, 0),
                                torch.zeros_like(s.emitted)).sum(
                                    dtype=torch.int32)
    return FusedSceneResult(
        alerts=alerts,
        num_checked=s.checked,
        num_risks=hit.sum(dtype=torch.int32),
        max_risk=torch.where(hit, ref.risk, zero).max(),
        alert_overflow=slot_overflow + torch.clamp_min(n_surv - cap, 0),
    )
