"""The fused step's tail after the kernel's slots, and the fused
prediction's (the port of tpu_collide/kernels/refine.py).

  * fast mode: the scene top-A is taken directly on the slot keys (they are
    the scene ranking key 2*priority + risk); only the selected pairs get
    their payload (ttc, distance, col_pos, ...) recomputed. Rows with more
    qualifying pairs than slots (hot rows) have their whole stencil
    neighbourhood recomputed and merged into the selection (`_hot_topup`).
  * precise mode: the slots hold stage-2 survivors; they are compacted to
    `survivor_cap` records and swept with the sampled constant-acceleration
    stage 3.

  * prediction (`fused_predict`): the predict kernel's per-offset slots
    -> the selected pairs recomputed -> merge per pair in sorted-row
    space, with the truncation certificate and its hot top-up -> scatter
    back to object order.

The recomputation uses the stage functions of detect/pipeline.py, so alert
and predicted-risk values follow the reference path's math. The alert
buffer always has `max_scene_alerts` entries. Every selection (hot rows,
scene top-A, survivor compaction) takes ties by the lower flat index, as
jax.lax.top_k does (core/ops.topk_low_index), so a cap that binds on equal
keys keeps the same entries in every run.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.alerts.extract import AlertBatch, compute_priority
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.ops import stable_topk, topk_low_index
from tpu_collide_torch.detect.pipeline import (_dist_at_time,
                                               _fast_first_crossing, _norm,
                                               _pair_safe_distance,
                                               _precise_sweep, _risk_score)
from tpu_collide_torch.detect.predict import (class_advance,
                                              classify_trajectories,
                                              merge_pair_risks,
                                              predict_offsets,
                                              sub_window_config)
from tpu_collide_torch.kernels.cell_list import (CellList, FI,
                                                 build_cell_list, decode_oid,
                                                 flat_cells, stencil_pairs)
from tpu_collide_torch.kernels.fused_detect import (KEY_NONE, fused_topk,
                                                    predict_topk)


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
    own_oid: torch.Tensor    # [P] int32, halo marks undone
    cand_oid: torch.Tensor   # [P] int32, halo marks undone


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
    """Stages 1-4 on gathered [P, NF] records of each pair's two sides.
    oid_o / oid_c are the cell list's oids: a pair's identity is taken on
    them as they are (an object and a halo mirror stay distinct), the
    reported ids have the halo marks undone."""
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
        own_oid=decode_oid(oid_o), cand_oid=decode_oid(oid_c))


@dataclasses.dataclass(frozen=True)
class FusedSceneResult:
    alerts: AlertBatch
    num_checked: torch.Tensor     # [] int32 stage-1 pairs (-1: not counted)
    num_risks: torch.Tensor       # [] int32 per-direction detected risks
    max_risk: torch.Tensor        # [] f32
    alert_overflow: torch.Tensor  # [] int32 qualifying pairs (fast) or
                                  # survivors (precise) beyond the slots and
                                  # caps; 0 means the alert list is complete


def _alert_batch(valid, ref: RefinedPairs, size: int) -> AlertBatch:
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
        vehicle_oid=col(ref.own_oid.to(torch.int32), -1),
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
    """Exact top-up for hot rows (own rows, never halo mirrors, with more
    qualifying pairs than the k slots). The up to `hot_topup` hottest rows
    get their whole stencil neighbourhood (the runs the kernel walks)
    recomputed; their pairs replace their slots in the scene selection.
    Rows beyond the cap stay counted in alert_overflow.

    Returns (covered [m] bool, hkey [P] f32 scene key (KEY_NONE where not
    qualifying), hown [P], hcand [P] int64 sorted indices). Waits for the
    device once, to learn whether any row is hot, and once more for the
    pair count when one is."""
    H = cfg.detect.hot_topup
    m = qual.numel()
    hot = cl.own & (qual > k)
    hot_rank = torch.where(hot, qual.to(torch.float32),
                           torch.full_like(qual, -1, dtype=torch.float32))
    top_q, hot_rows = topk_low_index(hot_rank, min(H, m))
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
    (fused_topk; fused_topk_plain to compare the two on one device).

    Only own rows (`cl.own`) emit alerts and count in num_risks and
    alert_overflow; num_checked and max_risk take every row, halo mirrors
    included, as in the JAX package."""
    s = topk(cl, cfg, mode="hits")
    keys, idx = s.keys, s.idx
    m, k = keys.shape
    own = cl.own
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
    top_key, top_i = topk_low_index(allk, a)
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
    alerts = _alert_batch(valid, ref, cfg.alerts.max_scene_alerts)

    slot_risk = torch.where(occupied, decode_risk(keys),
                            torch.zeros_like(keys))
    zero = torch.zeros_like(s.qual)
    return FusedSceneResult(
        alerts=alerts,
        num_checked=s.checked.to(torch.int32),
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
    top-A. Only own rows' survivors are kept (see fused_scene_fast)."""
    s = topk(cl, cfg, mode="survivors")
    keys, idx = s.keys, s.idx
    m, k = keys.shape
    own = cl.own
    occupied = (idx >= 0) & own[:, None]
    sel = torch.where(occupied, keys, torch.full_like(keys, KEY_NONE))
    cap = min(cfg.survivor_cap, m * k)
    # the cap is a large share of the slots: a full stable sort is quicker
    # here than a top-k of that size
    top_key, top_flat = stable_topk(sel.reshape(-1), cap)
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
    top_rank, sel_i = topk_low_index(
        rank, min(cfg.alerts.max_scene_alerts, cap))
    ref_a = RefinedPairs(**{f.name: getattr(ref, f.name)[sel_i]
                            for f in dataclasses.fields(RefinedPairs)})
    alerts = _alert_batch(top_rank >= 0.0, ref_a,
                          cfg.alerts.max_scene_alerts)

    n_surv = occupied.sum(dtype=torch.int32)
    slot_overflow = torch.where(own, torch.clamp_min(s.emitted - k, 0),
                                torch.zeros_like(s.emitted)).sum(
                                    dtype=torch.int32)
    return FusedSceneResult(
        alerts=alerts,
        num_checked=s.checked.to(torch.int32),
        num_risks=hit.sum(dtype=torch.int32),
        max_risk=torch.where(hit, ref.risk, zero).max(),
        alert_overflow=slot_overflow + torch.clamp_min(n_surv - cap, 0),
    )


# ---- prediction ----------------------------------------------------------

# The truncation certificate's margin between a truncated offset's lowest
# kept slot key and the risk of any hit it dropped. The port's slot keys
# are the kernel's exact f32 risks; the refine recomputes the kept pairs'
# risks with the pipeline helpers, whose norms may sum in another order, so
# the two can differ by a few ulps. 0.51 / KEY_Q (KEY_Q = 8192, the TPU
# kernel's slot-key quantiser at the default cand_lanes) is the JAX
# package's margin (tpu_collide/kernels/refine.py:927-929): it covers those
# ulps many times over and keeps slot_oflow equal to the JAX package's.
KEY_Q = 8192.0
PREDICT_KEY_MARGIN = 0.51 / KEY_Q


def _predict_pairs(cl: CellList, own, cand, t, cfg: SystemConfig,
                   sub_window: float):
    """(other oid, hit, risk, ttc, dist) [P] of explicit (own row,
    candidate row) pairs at offsets t ([P] f32), with the expressions of
    detect/predict.predict_collisions: the own object at its class-predicted
    position, the candidate advanced under constant acceleration, the
    stage-1 radius on the candidate's CURRENT position, the sampled sweep
    over the sub-window and the stage-4 risk."""
    det = cfg.detect
    fo, fc = cl.fields[own], cl.fields[cand]
    p_o, v_o, a_o = fo[:, 0:3], fo[:, 3:6], fo[:, 6:9]
    p_c, v_c, a_c = fc[:, 0:3], fc[:, 3:6], fc[:, 6:9]
    tb = t[:, None]
    pred = class_advance(p_o, v_o, a_o, fo[:, FI["cls"]], tb)
    o_pos = p_c + v_c * tb + 0.5 * a_c * tb * tb
    alive = cl.alive
    ok = (alive[own] & alive[cand] & (cl.oid[own] != cl.oid[cand])
          & (_norm(p_c - pred) <= det.search_radius))
    safe = _pair_safe_distance(fo[:, FI["size"]], fc[:, FI["size"]], det)
    sep_vel = v_c - v_o
    hit, t_hit, d_hit = _precise_sweep(o_pos - pred, sep_vel, a_c - a_o,
                                       safe, sub_window_config(det,
                                                               sub_window))
    hit = hit & ok
    zero = torch.zeros_like(t_hit)
    inf = torch.full_like(t_hit, float("inf"))
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), _norm(sep_vel),
                       fo[:, FI["heading"]], fc[:, FI["heading"]],
                       fo[:, FI["otype"]], fc[:, FI["otype"]], safe, det)
    return (cl.oid_decoded[cand], hit, torch.where(hit, risk, zero),
            torch.where(hit, t_hit + t, inf), torch.where(hit, d_hit, inf))


_POOL_FILL = (0, False, 0.0, float("inf"), float("inf"))


def _pool(shape, dev, at, values):
    """The five pool columns (other, hit, risk, ttc, dist) of `shape`, each
    filled with _POOL_FILL and set to `values` at index tuple `at`."""
    out = []
    for v, fill in zip(values, _POOL_FILL):
        buf = torch.full(shape, fill, dtype=v.dtype, device=dev)
        buf[at] = v
        out.append(buf)
    return out


def _predict_hot_topup(cl: CellList, cfg: SystemConfig, offs, uncert,
                       excess, k_slots: int, slot_cols, merged,
                       merge_k: int, sub_window: float):
    """Exact re-merge for the rows whose per-offset truncations the
    certificate could not prove harmless (the JAX package's
    _predict_hot_topup, tpu_collide/kernels/refine.py:526-732). The up to
    HOT_F flagged (offset, row) pairs with the most uncertified excess are
    recomputed over the exact stencil runs of the row's predicted cell at
    that offset; their exact top-merge_k replaces that offset's slot columns
    in the merge pool of the up to H_U rows with the most excess, which are
    merged again. Adding entries only raises a row's merge_k-th pool risk,
    so certificates already granted stay sound.

    The budgets HOT_F = min(1024, n_off*m) and H_U = min(512, m) are the
    JAX package's, so the counters agree; flagged pairs beyond them (or
    whose row is outside the H_U set) fail closed and stay in slot_oflow.
    The port's spans have no static cap, so no recompute falls short: the
    port may certify a row that the JAX package fails closed on, never the
    reverse.

    Returns (merged, slot_oflow). Waits for the device once, to learn
    whether any truncation is uncertified, and twice more when one is."""
    n_off, m = excess.shape
    dev = excess.device
    excess_u = torch.where(uncert, excess, torch.zeros_like(excess))
    total_unc = int(excess_u.sum())
    if total_unc == 0:
        return merged, torch.zeros((), dtype=torch.int32, device=dev)
    hot_f, h_u = min(1024, n_off * m), min(512, m)
    fex, fidx = stable_topk(excess_u.reshape(-1).to(torch.float32), hot_f)
    f_valid = fex > 0.0
    f_off, f_row = fidx // m, fidx % m
    uex, urows = stable_topk(excess_u.sum(dim=0).to(torch.float32), h_u)
    u_valid = uex > 0.0
    row2slot = torch.full((m,), -1, dtype=torch.int64, device=dev)
    row2slot[urows] = torch.where(u_valid, torch.arange(h_u, device=dev),
                                  torch.full_like(urows, -1))

    # each flagged (offset, row) over the runs of its predicted cell; the
    # query index q labels the pairs of flagged entry q
    t_f = offs[f_off]
    fo = cl.fields[f_row]
    pred = class_advance(fo[:, 0:3], fo[:, 3:6], fo[:, 6:9],
                         fo[:, FI["cls"]], t_f[:, None])
    cells = flat_cells(pred, f_valid & cl.alive[f_row], cfg)
    q, cand = stencil_pairs(cl, torch.arange(hot_f, device=dev), cells)
    other, hit, risk, ttc, dist = _predict_pairs(cl, f_row[q], cand, t_f[q],
                                                 cfg, sub_window)
    # exact top-merge_k of each flagged entry by (risk desc, candidate asc)
    q, cand, vals = q[hit], cand[hit], [x[hit] for x in
                                        (other, hit, risk, ttc, dist)]
    perm = torch.sort(-vals[2], stable=True).indices
    perm = perm[torch.sort(q[perm], stable=True).indices]
    q, vals = q[perm], [x[perm] for x in vals]
    rank = torch.arange(q.numel(), device=dev) - torch.searchsorted(q, q)
    keep = rank < merge_k
    extras = _pool((hot_f, merge_k), dev, (q[keep], rank[keep]),
                   [x[keep] for x in vals])

    # the extras into [H_U, n_off, merge_k] (one dump row for the rest)
    u_slot = row2slot[f_row]
    okf = f_valid & (u_slot >= 0)
    tgt = torch.where(okf, u_slot * n_off + f_off,
                      torch.full_like(f_off, h_u * n_off))
    xbufs = _pool((h_u * n_off + 1, merge_k), dev, (tgt,), extras)
    xcols = [x[:-1].reshape(h_u, n_off * merge_k) for x in xbufs]
    recomp = torch.zeros((h_u * n_off + 1,), dtype=torch.bool, device=dev)
    recomp[tgt] = okf
    # a recomputed offset's slot columns leave the pool: its exact top
    # supersedes them, and both would put one (pair, offset) twice
    keep_cols = ~recomp[:-1].reshape(h_u, n_off).repeat_interleave(
        k_slots, dim=1)
    pool = [s[urows] for s in slot_cols]
    pool[1] = pool[1] & keep_cols
    remerged = merge_pair_risks(
        *[torch.cat([a, b], dim=1) for a, b in zip(pool, xcols)], merge_k)
    out = []
    for big, small in zip(merged, remerged):
        big = big.clone()
        big[urows] = torch.where(u_valid[:, None], small, big[urows])
        out.append(big)
    covered = torch.where(okf, fex, torch.zeros_like(fex)).sum()
    return tuple(out), (total_unc - covered.to(torch.int32)).to(torch.int32)


def fused_predict_rows(state, cls, cfg: SystemConfig, horizon: float = 10.0,
                       step: float = 0.5, sub_window: float = 1.0,
                       merge_k: int = 32, k_slots: int = 8,
                       window_rows=None):
    """Row-space core of the fused prediction. `cls` is the [N] trajectory
    class in state order. Returns per SORTED row:

        (other [m, merge_k] int32 oids (halo marks undone), valid, risk,
         ttc, dist, soid [m] int32 row oids (-1 for dead rows and halo
         mirrors), own [m] bool (cl.own: alive and not a mirror),
         overflow [] int32 (0: the kernel walks exact stencil runs),
         slot_oflow [] int32 uncertified slot truncations,
         slot_trunc [] int32 all counted truncations)

    Per offset the kernel (predict_topk) keeps each row's k_slots best
    hits by risk over the exact runs around its class-predicted cell (the
    reference's candidate rule); the selected pairs are recomputed with the
    helpers predict_collisions uses,
    so values follow it, and merged per pair. A truncated (offset, row) is
    certified when every hit it dropped (at most the lowest kept slot's
    risk + PREDICT_KEY_MARGIN) lies strictly below the row's merge_k-th pool
    risk. Halo mirrors (marked oids, shard/halo.extend_with_halo) are
    candidates only: their rows emit nothing and count no truncation.
    `window_rows` is accepted and ignored. Waits for the device once
    for the selected pairs' count, and in the hot top-up."""
    del window_rows
    det = cfg.detect
    dev = state.device
    offsets = predict_offsets(horizon, step)
    if not offsets:
        raise ValueError(f"no prediction offsets below horizon {horizon} "
                         f"at step {step}")
    offs = torch.tensor(offsets, dtype=torch.float32, device=dev)
    n_off = offs.numel()
    # the kernel sweeps as many samples as the refine's _precise_sweep
    sub_steps = sub_window_config(det, sub_window).num_time_steps
    cl = build_cell_list(state, cfg, cls=cls)
    m = cl.n
    # halo mirrors (shard/predict.py) are candidates only: no query rows
    own = cl.own
    s = predict_topk(cl, cfg, offs, k_slots, sub_steps)

    # recompute the occupied slots' pairs
    at = ((s.idx >= 0) & own[None, :, None]).nonzero(as_tuple=True)
    cand = s.idx[at].to(torch.int64)
    vals = _predict_pairs(cl, at[1], cand, offs[at[0]], cfg, sub_window)
    slot_cols = tuple(
        x.permute(1, 0, 2).reshape(m, n_off * k_slots)
        for x in _pool((n_off, m, k_slots), dev, at, vals))
    *merged, kth = merge_pair_risks(*slot_cols, merge_k, return_kth=True)

    # hits beyond k_slots at one offset never reach the merge: count them,
    # and certify those that could not have entered the merged top merge_k
    excess = torch.where(own[None, :], torch.clamp_min(s.emitted - k_slots, 0),
                         torch.zeros_like(s.emitted))
    slot_trunc = excess.sum(dtype=torch.int32)
    bound = s.keys[:, :, k_slots - 1] + PREDICT_KEY_MARGIN
    uncert = (excess > 0) & (bound >= kth[None, :])
    slot_oflow = torch.where(uncert, excess,
                             torch.zeros_like(excess)).sum(dtype=torch.int32)
    if det.hot_topup > 0:
        merged, slot_oflow = _predict_hot_topup(
            cl, cfg, offs, uncert, excess, k_slots, slot_cols, merged,
            merge_k, sub_window)
    soid = torch.where(own, cl.oid_decoded, torch.full_like(cl.oid, -1))
    return tuple(merged) + (soid, own, cl.overflow, slot_oflow, slot_trunc)


def fused_predict(state, hist, cfg: SystemConfig, horizon: float = 10.0,
                  step: float = 0.5, sub_window: float = 1.0,
                  merge_k: int = 32, k_slots: int = 8, window_rows=None):
    """Trajectory prediction through the predict kernel: classify the
    trajectories, run the row-space core, scatter the merged rows back to
    object order by oid (as the JAX package does, refine.py:1018-1020; this
    assumes oid == state index). Returns predict_collisions' tuple
    (other [N, merge_k], valid, risk, ttc, dist) plus three counters:

      * overflow: 0, the kernel walks exact stencil runs;
      * slot_oflow: uncertified per-offset slot truncations (the merged
        list may be missing pairs);
      * slot_trunc: all counted truncations, the certified ones included.

    overflow == slot_oflow == 0 certifies the merged set equals
    predict_collisions' over an untruncated grid."""
    n = state.n
    cls = classify_trajectories(hist)
    (*rows, soid, _, overflow, slot_oflow, slot_trunc) = fused_predict_rows(
        state, cls, cfg, horizon=horizon, step=step, sub_window=sub_window,
        merge_k=merge_k, k_slots=k_slots, window_rows=window_rows)
    tgt = torch.where((soid >= 0) & (soid < n), soid,
                      torch.full_like(soid, n)).to(torch.int64)
    out = [x[:-1] for x in _pool((n + 1, merge_k), state.device, (tgt,),
                                 rows)]
    return tuple(out) + (overflow, slot_oflow, slot_trunc)
