"""Fused broad + narrow phase: each object's top-k pair slots.

The port of tpu_collide/kernels/fused_detect.py::fused_topk (the Pallas
kernel `_kernel`) in its two detection modes, and in its predict mode as
`predict_topk` (see there; csrc/fused_predict.cu, one launch for all
offsets):

  mode='hits' (fast): stages 1-4 with the closed-form stage 3. A hit keys
      2*priority + risk when it qualifies (risk >= risk_low), risk - 2 when
      it does not; emitted counts hits, qual counts qualifying hits.
  mode='survivors' (precise): stages 1-2. A survivor keys 1 - cd^2/safe^2;
      emitted == qual == survivors. The sampled sweep runs afterwards on
      the compacted survivors (kernels/refine.py).

Each object keeps k slots (k <= 32) ordered by key descending, then
candidate sorted index ascending; an empty slot holds (KEY_NONE, -1).
Slot keys are exact f32 values (the TPU kernel quantized them to
1/KEY_Q = 1.22e-4 to pack a lane index beside them), and the per-object
emitted / qual counts are exact int32 (the TPU kernel saturated them at
2047). `checked` is the scene total of stage-1 pairs (alive, not self,
within search_radius), or -1 when DetectionConfig.count_checked is False.

`fused_topk` launches the CUDA kernel (csrc/fused_detect.cu) for tensors on
a CUDA device and counts the launch in `fused_topk.launches`; for tensors on
the CPU it runs `fused_topk_plain`, the same function in plain PyTorch.
The plain version writes the arithmetic in the kernel's order, and the
kernel is built with -fmad=false, so the two agree bit for bit on the card.
`predict_topk` / `predict_topk_plain` / `predict_topk.launches` are the
same for the predict mode.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.detect.predict import class_advance
from tpu_collide_torch.kernels.cell_list import (CellList, FI, NF, flat_cells,
                                                 stencil_pairs, stencil_runs)

MODES = ("hits", "survivors")
KEY_NONE = -3.0          # key of an empty slot
KEY_SUB = -2.0           # sub-threshold hits key at risk + KEY_SUB
K_MAX = 32               # slots of the kernels' shared memory per object

# Order of the f32 constants handed to the kernel (csrc/fused_detect.cu
# reads them in this order).
PARAM_NAMES = ("r2", "min_rs2", "time_window", "dt", "t_max", "conv",
               "safe_base", "max_warning_time", "max_relative_speed",
               "w_dist", "w_time", "w_speed", "w_angle", "w_type",
               "same_type", "diff_type", "risk_low", "risk_medium",
               "risk_high", "ttc_critical", "ttc_high")


@dataclasses.dataclass(frozen=True)
class Slots:
    keys: torch.Tensor      # [N, k] f32, per row descending
    idx: torch.Tensor       # [N, k] int32 candidate sorted index, -1 empty
    checked: torch.Tensor   # [] int64 scene-total stage-1 pairs, or -1
    emitted: torch.Tensor   # [N] int32 hits (fast) / survivors (precise)
    qual: torch.Tensor      # [N] int32 qualifying hits / survivors


def slot_count(cfg: SystemConfig, mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    k = (cfg.alerts.max_alerts_per_object if mode == "hits"
         else cfg.detect.survivor_k)
    if not 1 <= k <= K_MAX:
        raise ValueError(f"per-object slot count {k} outside 1..{K_MAX}")
    return k


def kernel_params(cfg: SystemConfig) -> dict:
    """The f32 constants of the pair math, rounded once from the config's
    Python floats, shared by the kernel and its plain version."""
    det, al = cfg.detect, cfg.alerts
    v = dict(
        r2=det.search_radius * det.search_radius,
        min_rs2=det.min_relative_speed ** 2,
        time_window=det.time_window,
        dt=det.time_step,
        t_max=det.time_window - det.time_step + 1e-6,
        conv=1.0 if det.convention == "physical" else -1.0,
        safe_base=det.safe_distance_base,
        max_warning_time=det.max_warning_time,
        max_relative_speed=det.max_relative_speed,
        w_dist=det.weight_distance, w_time=det.weight_time,
        w_speed=det.weight_speed, w_angle=det.weight_angle,
        w_type=det.weight_type,
        same_type=det.same_type_factor, diff_type=det.diff_type_factor,
        risk_low=al.risk_low, risk_medium=al.risk_medium,
        risk_high=al.risk_high, ttc_critical=al.ttc_critical,
        ttc_high=al.ttc_high)
    return {name: float(np.float32(v[name])) for name in PARAM_NAMES}


def fused_topk(cl: CellList, cfg: SystemConfig, mode: str = "hits") -> Slots:
    """Top-k pair slots of every sorted object (see the module docstring).
    CUDA tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    k = slot_count(cfg, mode)
    dev = cl.fields.device
    if dev.type == "cuda":
        out = _launch(cl, cfg, mode, k)
        fused_topk.launches += 1
        return out
    if dev.type == "cpu":
        return fused_topk_plain(cl, cfg, mode)
    raise ValueError(f"fused_topk has no kernel for device {dev}")


fused_topk.launches = 0


# ---- the kernel's launch plan and walk, mirrored in Python ---------------
# The constants of csrc/fused_detect.cu: threads of a block, the fewest
# lanes an own object gets, and the blocks a launch should have.
THREADS = 256
WIDTH_MIN, GRID_MIN = 2, 1056
PLAN_FIELDS = ("width", "blocks", "threads", "smem")


def launch_plan(n: int, k: int) -> dict:
    """The launch of the kernel for n objects with k slots each, as
    tc_fused_topk makes it (integer for integer): `width` lanes per own
    object, the fewest of WIDTH_MIN .. 32 with which the fleet fills GRID_MIN
    blocks of THREADS threads (few lanes share a round's instructions among
    the many objects of a warp; a small fleet needs more lanes per object
    to spread over the card); a block owns THREADS / width consecutive
    sorted objects and keeps their slots in dynamic shared memory."""
    width = WIDTH_MIN
    while width < 32 and n * width < GRID_MIN * THREADS:
        width *= 2
    span = THREADS // width
    return dict(width=width, blocks=(n + span - 1) // span, threads=THREADS,
                smem=span * k * 8)


def group_walk(first: list, end: list, group: int) -> list:
    """The candidates the `group` lanes of one own object visit, per lane
    and in the lane's order: a lane strides through the object's runs
    [first[r], end[r]), concatenated, `group` candidates at a time (the
    kernel's settle)."""
    runs, lanes = len(first), []
    for gl in range(group):
        seen, r, pos, lim = [], 0, first[0] + gl, end[0]
        while True:
            while r < runs and pos >= lim:
                over = pos - lim
                r += 1
                if r < runs:
                    pos, lim = first[r] + over, end[r]
            if r >= runs:
                break
            seen.append(pos)
            pos += group
        lanes.append(seen)
    return lanes


def _block_cache(names, params_of):
    """-> block(cfg): params_of(cfg) in the order of `names` as the ctypes
    f32 array the kernels take, made once per config object. The configs
    are frozen, and an entry holds its config, so that the config's id
    stays its own: another config, equal or not, gets a block of its own."""
    cache = {}

    def block(cfg: SystemConfig):
        hit = cache.get(id(cfg))
        if hit is None or hit[0] is not cfg:
            if len(cache) >= 64:
                cache.clear()
            p = params_of(cfg)
            hit = cache[id(cfg)] = (cfg, (ctypes.c_float * len(names))(
                *[p[name] for name in names]))
        return hit[1]
    return block


param_block = _block_cache(PARAM_NAMES, kernel_params)
_CHECKED_LIBS: set = set()


def _library():
    """The kernel library, its parameter counts checked once."""
    from tpu_collide_torch.kernels._build import load_library
    lib = load_library()
    if lib not in _CHECKED_LIBS:
        if lib.tc_param_count() != len(PARAM_NAMES) \
                or lib.tc_pred_param_count() != len(PRED_PARAM_NAMES):
            raise RuntimeError("csrc/fused_detect.cu, csrc/fused_predict.cu "
                               "and PARAM_NAMES / PRED_PARAM_NAMES disagree")
        _CHECKED_LIBS.add(lib)
    return lib


def _on_device(dev):
    """A context in which `dev` is the current CUDA device; nothing to
    switch where it already is."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check_inputs(who: str, dev, tensors) -> None:
    for name, t, dtype, shape in tensors:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _launch(cl: CellList, cfg: SystemConfig, mode: str, k: int) -> Slots:
    n = cl.n
    dev = cl.fields.device
    nx, ny, nz = cl.grid_dims
    _check_inputs("fused_topk", dev, (
        ("fields", cl.fields, torch.float32, (n, NF)),
        ("cell", cl.cell, torch.int32, (n,)),
        ("cell_start", cl.cell_start, torch.int32, (cl.num_cells + 1,))))
    count = cfg.detect.count_checked
    keys = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int32, device=dev)
    emitted = torch.empty((n,), dtype=torch.int32, device=dev)
    qual = torch.empty((n,), dtype=torch.int32, device=dev)
    checked = (torch.zeros((), dtype=torch.int64, device=dev) if count
               else torch.full((), -1, dtype=torch.int64, device=dev))
    lib = _library()
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tc_fused_topk(
            cl.fields.data_ptr(), cl.cell.data_ptr(),
            cl.cell_start.data_ptr(), n, nx, ny, nz, int(cl.is3d), k,
            int(mode == "hits"), int(count),
            int(cfg.detect.angle_form == "product"),
            ctypes.cast(param_block(cfg), ctypes.c_void_p),
            keys.data_ptr(), idx.data_ptr(), emitted.data_ptr(),
            qual.data_ptr(), checked.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_topk kernel launch failed: CUDA error {rc} "
            f"({lib.tc_error_string(rc).decode()})")
    return Slots(keys=keys, idx=idx, checked=checked, emitted=emitted,
                 qual=qual)


def _pair_math(fo, fc, not_self, p, is3d: bool, hits: bool, angle_product):
    """The kernel's per-pair math, op for op and in its order
    (tpu_collide/kernels/fused_detect.py:651-784). fo/fc: [P, NF] own and
    candidate records. Returns (ok1, emitted, qual, key)."""
    f = lambda t, name: t[:, FI[name]]
    dev = fo.device
    # 0-dim tensors keep these divisions IEEE divisions on every device
    dt_t = torch.tensor(p["dt"], dtype=torch.float32, device=dev)
    mwt = torch.tensor(p["max_warning_time"], dtype=torch.float32, device=dev)
    mrs = torch.tensor(p["max_relative_speed"], dtype=torch.float32,
                       device=dev)

    # stage 1: within search radius, alive (runs hold alive objects only),
    # not self
    dxp = f(fc, "x") - f(fo, "x")
    dyp = f(fc, "y") - f(fo, "y")
    d2 = dxp * dxp + dyp * dyp
    if is3d:
        dzp = f(fc, "z") - f(fo, "z")
        d2 = d2 + dzp * dzp
    ok1 = not_self & (d2 <= p["r2"])

    # stage 2: closest approach under constant acceleration
    dvx = f(fc, "vx") - f(fo, "vx")
    dvy = f(fc, "vy") - f(fo, "vy")
    rs2 = dvx * dvx + dvy * dvy
    dot = dxp * dvx + dyp * dvy
    if is3d:
        dvz = f(fc, "vz") - f(fo, "vz")
        rs2 = rs2 + dvz * dvz
        dot = dot + dzp * dvz
    rs2s = torch.where(rs2 > 1e-12, rs2, torch.ones_like(rs2))
    ts = -(p["conv"] * dot) / rs2s
    dax = f(fc, "ax") - f(fo, "ax")
    day = f(fc, "ay") - f(fo, "ay")
    cdx = dxp + dvx * ts + 0.5 * dax * ts * ts
    cdy = dyp + dvy * ts + 0.5 * day * ts * ts
    cd2 = cdx * cdx + cdy * cdy
    if is3d:
        daz = f(fc, "az") - f(fo, "az")
        cdz = dzp + dvz * ts + 0.5 * daz * ts * ts
        cd2 = cd2 + cdz * cdz
    safe = (f(fo, "size") + f(fc, "size")) * 0.5 + p["safe_base"]
    safe2 = safe * safe
    ok2 = ok1 & ((rs2 >= p["min_rs2"]) & (ts >= 0.0)
                 & (ts <= p["time_window"]) & (cd2 <= safe2))
    none = torch.full_like(d2, KEY_NONE)
    if not hits:
        return ok1, ok2, ok2, torch.where(ok2, 1.0 - cd2 / safe2, none)

    # stage 3 (fast): first crossing of |p + v t| = safe, snapped up to the
    # dt lattice
    bq = 2.0 * dot
    cq = d2 - safe2
    disc = bq * bq - 4.0 * rs2 * cq
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_en = (-bq - sq) / (2.0 * rs2s)
    t_ex = (-bq + sq) / (2.0 * rs2s)
    inside = cq <= 0.0
    zero = torch.zeros_like(d2)
    t_fi = torch.where(inside, zero, torch.clamp_min(t_en, 0.0))
    t_sn = torch.ceil(t_fi / dt_t - 1e-6) * p["dt"]
    sok = inside | ((t_sn >= t_en - 1e-6) & (t_sn <= t_ex + 1e-6))
    hit = (ok2 & (disc >= 0.0) & (rs2 > 1e-12) & sok
           & (t_sn <= p["t_max"]))
    t_hit = torch.where(inside, zero, t_sn)
    hdx = dxp + dvx * t_hit
    hdy = dyp + dvy * t_hit
    hd2 = hdx * hdx + hdy * hdy
    if is3d:
        hdz = dzp + dvz * t_hit
        hd2 = hd2 + hdz * hdz
    d_hit = torch.sqrt(hd2)

    # stage 4: weighted risk
    oh, ch = f(fo, "heading"), f(fc, "heading")
    if angle_product:
        sd = f(fo, "sin_h") * f(fc, "cos_h") - f(fo, "cos_h") * f(fc, "sin_h")
        angle = torch.where(oh >= ch, sd, -sd)
    else:
        angle = torch.sin(torch.abs(oh - ch))
    tfac = torch.where(f(fc, "otype") == f(fo, "otype"),
                       torch.full_like(d2, p["same_type"]),
                       torch.full_like(d2, p["diff_type"]))
    risk = (p["w_dist"] * (1.0 - d_hit / safe)
            + p["w_time"] * (1.0 - torch.clamp_max(t_hit / mwt, 1.0))
            + p["w_speed"] * torch.clamp_max(torch.sqrt(rs2) / mrs, 1.0)
            + p["w_angle"] * angle
            + p["w_type"] * tfac)
    risk = torch.clamp(risk, 0.0, 1.0)

    # priority (warning_system.py:287-311) and the scene ranking key
    crit = (risk >= p["risk_high"]) & (t_hit < p["ttc_critical"])
    high = (risk >= p["risk_high"]) | (t_hit < p["ttc_high"])
    med = risk >= p["risk_medium"]
    prio = torch.where(crit, 3.0, torch.where(high, 2.0,
                                              torch.where(med, 1.0, 0.0)))
    qual = hit & (risk >= p["risk_low"])
    key = torch.where(qual, 2.0 * prio + risk,
                      torch.where(hit, risk + KEY_SUB, none))
    return ok1, hit, qual, key


def _pair_chunks(cl: CellList, rows: torch.Tensor, cells=None,
                 max_pairs: int = 1 << 22):
    """Yields (own, cand) int64 pair chunks of the rows' stencil runs
    (around `cells` when given), each of about `max_pairs` pairs, in the
    order of stencil_pairs over all rows."""
    start, end = stencil_runs(cl, rows, cells)
    bounds = torch.cumsum((end - start).sum(dim=1), 0).cpu()
    n = rows.numel()
    r0 = 0
    while r0 < n:
        base = int(bounds[r0 - 1]) if r0 else 0
        r1 = int(torch.searchsorted(bounds, base + max_pairs, right=True))
        r1 = min(n, max(r1, r0 + 1))
        yield stencil_pairs(cl, rows[r0:r1],
                            None if cells is None else cells[r0:r1])
        r0 = r1


def _rank_slots(n: int, k: int, own: list, cand: list, key: list, dev):
    """(keys [n, k] f32, idx [n, k] int32) of each own row's k best pairs by
    (key descending, candidate ascending), from chunk lists of pairs in
    (own, candidate) ascending order."""
    keys = torch.full((n, k), KEY_NONE, dtype=torch.float32, device=dev)
    idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    if own:
        own, cand, key = torch.cat(own), torch.cat(cand), torch.cat(key)
        # two stable sorts rank by (own, key desc) and keep candidate order
        perm = torch.sort(-key, stable=True).indices
        perm = perm[torch.sort(own[perm], stable=True).indices]
        own, cand, key = own[perm], cand[perm], key[perm]
        rank = (torch.arange(own.numel(), device=dev)
                - torch.searchsorted(own, own))
        keep = rank < k
        keys[own[keep], rank[keep]] = key[keep]
        idx[own[keep], rank[keep]] = cand[keep].to(torch.int32)
    return keys, idx


def fused_topk_plain(cl: CellList, cfg: SystemConfig, mode: str = "hits",
                     max_pairs: int = 1 << 22) -> Slots:
    """fused_topk in plain PyTorch, on any device. Pairs are enumerated
    from the same stencil runs as the kernel walks, in chunks of own rows
    holding about `max_pairs` candidate pairs."""
    k = slot_count(cfg, mode)
    p = kernel_params(cfg)
    n = cl.n
    dev = cl.fields.device
    hits = mode == "hits"
    emitted = torch.zeros((n,), dtype=torch.int64, device=dev)
    qual = torch.zeros((n,), dtype=torch.int64, device=dev)
    checked = torch.zeros((), dtype=torch.int64, device=dev)
    e_own, e_cand, e_key = [], [], []
    for own, cand in _pair_chunks(cl, torch.arange(n, device=dev),
                                  max_pairs=max_pairs):
        ok1, emit, q, key = _pair_math(
            cl.fields[own], cl.fields[cand], own != cand, p, cl.is3d, hits,
            cfg.detect.angle_form == "product")
        checked += ok1.sum()
        emitted += torch.bincount(own[emit], minlength=n)
        qual += torch.bincount(own[q], minlength=n)
        e_own.append(own[emit])
        e_cand.append(cand[emit])
        e_key.append(key[emit])
    keys, idx = _rank_slots(n, k, e_own, e_cand, e_key, dev)
    if not cfg.detect.count_checked:
        checked = torch.full((), -1, dtype=torch.int64, device=dev)
    return Slots(keys=keys, idx=idx, checked=checked,
                 emitted=emitted.to(torch.int32), qual=qual.to(torch.int32))


# ---- predict mode --------------------------------------------------------

# Order of the f32 constants of the predict mode (csrc/fused_predict.cu
# reads them in this order, after PARAM_NAMES).
PRED_PARAM_NAMES = ("lo_x", "lo_y", "lo_z", "cell_size", "radius")


@dataclasses.dataclass(frozen=True)
class PredSlots:
    keys: torch.Tensor      # [n_off, N, k] f32 risk, per row descending
    idx: torch.Tensor       # [n_off, N, k] int32 candidate sorted index
    emitted: torch.Tensor   # [n_off, N] int32 hits of each row and offset


def pred_params(cfg: SystemConfig) -> dict:
    v = dict(lo_x=cfg.world.lo[0], lo_y=cfg.world.lo[1],
             lo_z=cfg.world.lo[2], cell_size=cfg.grid.cell_size,
             radius=cfg.detect.search_radius)
    return {name: float(np.float32(v[name])) for name in PRED_PARAM_NAMES}


def _check_k(k: int) -> None:
    if not 1 <= k <= K_MAX:
        raise ValueError(f"per-object slot count {k} outside 1..{K_MAX}")


def predict_topk(cl: CellList, cfg: SystemConfig, offsets: torch.Tensor,
                 k: int, sub_steps: int) -> PredSlots:
    """Top-k predicted pair slots of every sorted object at every offset
    (the predict mode of the TPU kernel, tpu_collide/kernels/
    fused_detect.py:553-646), all offsets in one launch.

    Per offset t and own row: the row moves to its class-predicted position
    (the record's cls field; detect/predict.class_advance); its candidates
    are the objects of the 1-cell stencil around the predicted position's
    cell, tested at their CURRENT positions (|p_c - pred| <= search_radius,
    alive, not self); each candidate advances to t under constant
    acceleration, and the first of `sub_steps` samples (t_s = s * dt)
    within the safe distance is a hit, keyed by its stage-4 risk. Slots
    are ordered by (risk descending, candidate sorted index ascending); an
    empty slot is (KEY_NONE, -1). `emitted` counts every hit exactly.

    offsets: [n_off] f32 on the cell list's device. CUDA tensors launch
    the kernel (csrc/fused_predict.cu) or raise; CPU tensors take
    predict_topk_plain."""
    _check_k(k)
    dev = cl.fields.device
    if dev.type == "cuda":
        out = _launch_predict(cl, cfg, offsets, k, sub_steps)
        predict_topk.launches += 1
        return out
    if dev.type == "cpu":
        return predict_topk_plain(cl, cfg, offsets, k, sub_steps)
    raise ValueError(f"predict_topk has no kernel for device {dev}")


predict_topk.launches = 0


_pred_param_block = _block_cache(PRED_PARAM_NAMES, pred_params)


def _launch_predict(cl: CellList, cfg: SystemConfig, offsets: torch.Tensor,
                    k: int, sub_steps: int) -> PredSlots:
    n = cl.n
    dev = cl.fields.device
    n_off = offsets.numel()
    nx, ny, nz = cl.grid_dims
    _check_inputs("predict_topk", dev, (
        ("fields", cl.fields, torch.float32, (n, NF)),
        ("cell_start", cl.cell_start, torch.int32, (cl.num_cells + 1,)),
        ("offsets", offsets, torch.float32, (n_off,))))
    if not 1 <= n_off <= 65535 or sub_steps < 0:
        raise ValueError(f"predict_topk: {n_off} offsets (1..65535) and "
                         f"{sub_steps} sub-steps (>= 0)")
    keys = torch.empty((n_off, n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_off, n, k), dtype=torch.int32, device=dev)
    emitted = torch.empty((n_off, n), dtype=torch.int32, device=dev)
    lib = _library()
    with _on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tc_fused_predict(
            cl.fields.data_ptr(), cl.cell_start.data_ptr(),
            offsets.data_ptr(), n_off, n, nx, ny, nz, int(cl.is3d), k,
            sub_steps, int(cfg.detect.angle_form == "product"),
            ctypes.cast(param_block(cfg), ctypes.c_void_p),
            ctypes.cast(_pred_param_block(cfg), ctypes.c_void_p),
            keys.data_ptr(), idx.data_ptr(), emitted.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"predict_topk kernel launch failed: CUDA error {rc} "
            f"({lib.tc_error_string(rc).decode()})")
    return PredSlots(keys=keys, idx=idx, emitted=emitted)


def _predict_pair_math(fo, fc, pred, not_self, t, p, radius, is3d: bool,
                       sub_steps: int, angle_product):
    """The predict kernel's per-pair math, op for op and in its order.
    fo/fc: [P, NF] own and candidate records, pred [P, 3] the own object's
    predicted position, t the offset (0-dim f32). Returns (hit, risk)."""
    f = lambda a, name: a[:, FI[name]]
    dev = fo.device
    # 0-dim tensors keep these divisions IEEE divisions on every device
    mwt = torch.tensor(p["max_warning_time"], dtype=torch.float32, device=dev)
    mrs = torch.tensor(p["max_relative_speed"], dtype=torch.float32,
                       device=dev)

    # stage 1: the candidate's CURRENT position within the search radius of
    # the predicted one
    qx = f(fc, "x") - pred[:, 0]
    qy = f(fc, "y") - pred[:, 1]
    q2 = qx * qx + qy * qy
    if is3d:
        qz = f(fc, "z") - pred[:, 2]
        q2 = q2 + qz * qz
    ok1 = not_self & (torch.sqrt(q2) <= radius)

    # the candidate advanced to t under constant acceleration
    adv = lambda a: (f(fc, a) + f(fc, "v" + a) * t
                     + 0.5 * f(fc, "a" + a) * t * t)
    sx = adv("x") - pred[:, 0]
    sy = adv("y") - pred[:, 1]
    dvx = f(fc, "vx") - f(fo, "vx")
    dvy = f(fc, "vy") - f(fo, "vy")
    dax = f(fc, "ax") - f(fo, "ax")
    day = f(fc, "ay") - f(fo, "ay")
    if is3d:
        sz = adv("z") - pred[:, 2]
        dvz = f(fc, "vz") - f(fo, "vz")
        daz = f(fc, "az") - f(fo, "az")
    safe = (f(fo, "size") + f(fc, "size")) * 0.5 + p["safe_base"]

    # first sample of the sub-window sweep within the safe distance
    hit = torch.zeros_like(ok1)
    t_hit = torch.zeros_like(safe)
    d_hit = torch.zeros_like(safe)
    dt = np.float32(p["dt"])
    for s in range(sub_steps):
        ts = np.float32(s) * dt
        tt = float(ts * ts)
        ts = float(ts)
        ddx = sx + dvx * ts + 0.5 * dax * tt
        ddy = sy + dvy * ts + 0.5 * day * tt
        dd2 = ddx * ddx + ddy * ddy
        if is3d:
            ddz = sz + dvz * ts + 0.5 * daz * tt
            dd2 = dd2 + ddz * ddz
        d = torch.sqrt(dd2)
        new = ~hit & (d <= safe)
        t_hit = torch.where(new, ts, t_hit)
        d_hit = torch.where(new, d, d_hit)
        hit = hit | new
    hit = hit & ok1

    # stage 4: weighted risk, the slot key
    rs2 = dvx * dvx + dvy * dvy
    if is3d:
        rs2 = rs2 + dvz * dvz
    oh, ch = f(fo, "heading"), f(fc, "heading")
    if angle_product:
        sd = f(fo, "sin_h") * f(fc, "cos_h") - f(fo, "cos_h") * f(fc, "sin_h")
        angle = torch.where(oh >= ch, sd, -sd)
    else:
        angle = torch.sin(torch.abs(oh - ch))
    tfac = torch.where(f(fc, "otype") == f(fo, "otype"),
                       torch.full_like(safe, p["same_type"]),
                       torch.full_like(safe, p["diff_type"]))
    risk = (p["w_dist"] * (1.0 - d_hit / safe)
            + p["w_time"] * (1.0 - torch.clamp_max(t_hit / mwt, 1.0))
            + p["w_speed"] * torch.clamp_max(torch.sqrt(rs2) / mrs, 1.0)
            + p["w_angle"] * angle
            + p["w_type"] * tfac)
    return hit, torch.clamp(risk, 0.0, 1.0)


def predict_topk_plain(cl: CellList, cfg: SystemConfig,
                       offsets: torch.Tensor, k: int, sub_steps: int,
                       max_pairs: int = 1 << 22) -> PredSlots:
    """predict_topk in plain PyTorch, on any device: per offset, the pairs
    of the same runs as the kernel walks (around each row's predicted
    cell), in chunks of about `max_pairs` pairs. Waits for the device for
    every chunk."""
    _check_k(k)
    p, q = kernel_params(cfg), pred_params(cfg)
    n = cl.n
    dev = cl.fields.device
    rows = torch.arange(n, device=dev)
    fl = cl.fields
    angle_product = cfg.detect.angle_form == "product"
    keys, idx, emitted = [], [], []
    for o in range(offsets.numel()):
        t = offsets[o]
        pred = class_advance(fl[:, 0:3], fl[:, 3:6], fl[:, 6:9],
                             fl[:, FI["cls"]], t)
        cells = flat_cells(pred, cl.alive, cfg)
        emit = torch.zeros((n,), dtype=torch.int64, device=dev)
        e_own, e_cand, e_key = [], [], []
        for own, cand in _pair_chunks(cl, rows, cells, max_pairs):
            hit, risk = _predict_pair_math(
                fl[own], fl[cand], pred[own], own != cand, t, p,
                q["radius"], cl.is3d, sub_steps, angle_product)
            emit += torch.bincount(own[hit], minlength=n)
            e_own.append(own[hit])
            e_cand.append(cand[hit])
            e_key.append(risk[hit])
        kk, ii = _rank_slots(n, k, e_own, e_cand, e_key, dev)
        keys.append(kk)
        idx.append(ii)
        emitted.append(emit.to(torch.int32))
    return PredSlots(keys=torch.stack(keys), idx=torch.stack(idx),
                     emitted=torch.stack(emitted))
