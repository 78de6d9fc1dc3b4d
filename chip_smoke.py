"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one JSON line each (any failure raises and exits non-zero):

  device           the card, and nvidia-smi's name and power limit
  build            nvcc builds tpu_collide_torch/csrc into a shared library
  kernel_vs_plain  the CUDA fused_topk against its plain PyTorch version on
                   one cell list, 20k-object 2D and 3D fleets, both modes
  probe            the head-on pair (ttc 4.70 s) through the fused path
  main_path        make_step(cfg, backend="fused") at the configurations of
                   bench.py's flagship rows; at 100k the step's detection
                   also runs through the plain version and must agree
  predict_kernel_vs_plain
                   the CUDA predict kernel against its plain version on one
                   cell list, all 20 offsets, 20k-object 2D and 3D fleets
  predict_path     trajectory prediction at the size of bench.py's predict
                   row: 100k city-skew objects, 4 fused steps each followed
                   by update_history, then _predict_device_fused (k_slots
                   16, merge_k 32, horizon 10 s at 0.5 s); the kernel
                   against its plain version on the first and last offset
  predict_oracle   fused_predict (the kernel) against predict_collisions
                   (the grid path) on a 20k uniform fleet whose buckets do
                   not truncate
  xla_path         make_step(cfg, backend="xla") at bench.py's XLA rows
                   (1k precise and 1k fast, city skew) and
                   make_step(cfg100k, chunk_size=8192) on a uniform 100k
                   fleet at a fleet-exact cell_capacity
  fused_vs_xla     the fused and the reference-shaped detection on the
                   same state (1k precise, 100k fast) with a scene budget
                   that does not bind: equal unordered alert sets and risk
                   counts; a pair that flips is reported with its distance
                   to the threshold it sits on
  burst            make_burst_step(cfg, 8) against 8 single steps from the
                   same generator seed: bit-equal states
  detect_probe     make_detect on the head-on pair: ttc 4.70
  cosort_vs_plain  the CUDA co-sort on the cell-list build's operands
                   (1M-3D: 14 operands, 100k-2D: 11) against its plain
                   version (bit-equal) and torch.sort plus gathers

The line before the last lists the kernels with their launches (the
detection kernels' on main_path, the predict kernel's on predict_path, the
co-sort's on cosort_vs_plain), their times and their bounds; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import time

REPEATS = 10
# Slot keys of the kernel against its plain version: both run the same f32
# operations in the same order (the kernel is built with -fmad=false), so
# they agree bit for bit; 1e-6 would still allow one ulp of a key below 8.
KEY_TOL = 1e-6
# Alert values of the kernel path against the plain path: the same refine
# code on bit-equal slots (the tolerance of tests/test_fused_kernel.py).
ALERT_TOL = 1e-5
# Predicted risks and ttcs of fused_predict against predict_collisions: the
# same pipeline helpers recompute both (the tolerance of
# tests/test_torch_predict.py).
ORACLE_TOL = 1e-5
# bench.py's predict row (bench.py:429-443): horizon 10 s at 0.5 s steps,
# k_slots 16, merge_k 32 (the default), a 1 s sub-window at time_step
# 0.1 s, so 10 sweep samples
HORIZON, PRED_STEP, K_SLOTS, SUB_STEPS = 10.0, 0.5, 16, 10
# bench.py's 100k row of the blocked reference-shaped step (BENCH_NOTES.md:76)
CHUNK = 8192
XLA_100K_STEPS = 5
# fused_vs_xla: a pair in one alert set and not the other must sit within
# this distance of the threshold that decides it (m, m/s, s or risk units):
# the two paths round the same f32 stage math in other orders
FLIP_MARGIN = 1e-3

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet):
# device memory, and f32 outside the tensor cores (integer compares of the
# co-sort are counted against the same rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per pair (2D, 3D), counted from the f32 expressions of the
# plain versions (kernels/fused_detect.py _pair_math and
# _predict_pair_math), a square root or a compare as one:
#   walk      stage 1 of every candidate walked (differences, d^2, compare)
#   stage2    closest approach of a stage-1 pair (relative motion, t*, the
#             distance at t*, the safe distance, the four tests)
#   hit_tail  stage 3 (closed-form crossing, snap to the dt lattice), stage
#             4 (risk), priority and key of a stage-2 survivor
#   surv_key  the survivor key 1 - cd^2/safe^2
#   p_walk    predict stage 1 (distance of the current candidate to the
#             predicted position, square root, compare)
#   p_setup   the candidate advanced to t, relative velocity and
#             acceleration, safe distance
#   p_sample  one sweep sample (position at t_s, distance, compare, select)
#   p_risk    stage 4 of a predicted hit
OPS = dict(walk=(6, 9), stage2=(38, 52), hit_tail=(85, 89), surv_key=(2, 2),
           p_walk=(7, 10), p_setup=(21, 30), p_sample=(18, 25),
           p_risk=(30, 32))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, torch, repeats=REPEATS) -> float:
    """Median over `repeats` runs of fn, each bracketed by CUDA events
    (after one warm-up run)."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare_pred_slots(got, want, k, torch) -> dict:
    """Kernel slots against plain slots (detection [N, k] or predict
    [n_off, N, k]): emitted exact; slot sets equal and keys within KEY_TOL
    wherever emitted <= k."""
    if not torch.equal(got.emitted, want.emitted):
        raise AssertionError("emitted differs")
    rows = want.emitted <= k
    gi, go = torch.sort(got.idx[rows], dim=1)
    wi, wo = torch.sort(want.idx[rows], dim=1)
    if not torch.equal(gi, wi):
        raise AssertionError("slot sets differ")
    err = float((got.keys[rows].gather(1, go)
                 - want.keys[rows].gather(1, wo)).abs().max()) \
        if bool(rows.any()) else 0.0
    if err > KEY_TOL:
        raise AssertionError(f"slot keys differ by {err}")
    return dict(emitted=int(got.emitted.sum()),
                rows_over_k=int((~rows).sum()), max_abs_err=err,
                bit_equal=bool(torch.equal(got.keys, want.keys)
                               and torch.equal(got.idx, want.idx)))


def compare_slots(got, want, k, torch) -> dict:
    """Detection kernel slots against plain slots: compare_pred_slots, and
    the checked and qualifying counters exact."""
    if int(got.checked) != int(want.checked):
        raise AssertionError(f"checked {int(got.checked)} != "
                             f"{int(want.checked)}")
    if not torch.equal(got.qual, want.qual):
        raise AssertionError("qual differs")
    res = compare_pred_slots(got, want, k, torch)
    return dict(checked=int(got.checked), emitted=res.pop("emitted"),
                qual=int(got.qual.sum()), **res)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, operations=n_ops)


def pair_work(cl, cfg, pos, cells, torch) -> tuple:
    """(candidates walked, pairs within the search radius) of the cell
    list's rows at positions `pos` ([N, 3], the rows' own or predicted
    positions) over the runs around `cells` (their own cells when None),
    self pairs excluded from the second count."""
    from tpu_collide_torch.kernels.cell_list import stencil_runs
    from tpu_collide_torch.kernels.fused_detect import _pair_chunks
    rows = torch.arange(cl.n, device=cl.fields.device)
    start, end = stencil_runs(cl, rows, cells)
    walked = int((end - start).sum())
    r2 = cfg.detect.search_radius ** 2
    inside = 0
    for own, cand in _pair_chunks(cl, rows, cells):
        d = cl.fields[cand, 0:3] - pos[own]
        inside += int(((own != cand) & ((d * d).sum(dim=1) <= r2)).sum())
    return walked, inside


def detect_bound(cl, cfg, mode, slots, torch) -> dict:
    """bound() of fused_topk on this cell list: its inputs (records, cell
    ids, cell starts) read once, its slots and counters written once, and
    the operations these pairs need: every walked candidate's stage 1,
    every stage-1 pair's stage 2, and stage 3-4 (hits) or the key
    (survivors) of every stage-2 survivor."""
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    d3 = int(cl.is3d)
    n, k = slots.keys.shape
    walked, stage1 = pair_work(cl, cfg, cl.fields[:, 0:3], None, torch)
    surv = int(fused_topk(cl, cfg, "survivors").emitted.sum())
    tail = OPS["hit_tail" if mode == "hits" else "surv_key"][d3]
    n_ops = (walked * OPS["walk"][d3] + stage1 * OPS["stage2"][d3]
             + surv * tail)
    n_bytes = (cl.fields.numel() * 4 + n * 4 + cl.cell_start.numel() * 4
               + n * k * 8 + n * 8 + 8)
    return dict(bound(n_bytes, n_ops), walked=walked, stage1=stage1,
                stage2=surv, emitted=int(slots.emitted.sum()))


def predict_bound(cl, cfg, offs, slots, sub_steps, torch) -> dict:
    """bound() of predict_topk on this cell list and these offsets: the
    records and cell starts read once, the [n_off, N, k] slots and the
    emitted counts written once, and per offset the operations of every
    walked candidate's stage 1, and of the sweep of every pair within the
    radius: all sub_steps samples where it does not hit, at least one
    where it hits (the sample of the hit is not known, so this side of
    the count is a lower bound), plus stage 4 of every hit."""
    from tpu_collide_torch.detect.predict import class_advance
    from tpu_collide_torch.kernels.cell_list import FI, flat_cells
    d3 = int(cl.is3d)
    fl = cl.fields
    walked = inside = 0
    for o in range(offs.numel()):
        pred = class_advance(fl[:, 0:3], fl[:, 3:6], fl[:, 6:9],
                             fl[:, FI["cls"]], offs[o])
        w, i = pair_work(cl, cfg, pred, flat_cells(pred, cl.alive, cfg),
                         torch)
        walked += w
        inside += i
    hits = int(slots.emitted.sum())
    n_ops = (walked * OPS["p_walk"][d3]
             + inside * OPS["p_setup"][d3]
             + (inside - hits) * sub_steps * OPS["p_sample"][d3]
             + hits * (OPS["p_sample"][d3] + OPS["p_risk"][d3]))
    n_bytes = (fl.numel() * 4 + cl.cell_start.numel() * 4 + offs.numel() * 4
               + slots.keys.numel() * 8 + slots.emitted.numel() * 4)
    return dict(bound(n_bytes, n_ops), walked=walked, within_radius=inside,
                hits=hits)


def risk_map(other, valid, risk, ttc) -> dict:
    """{(object, other): (risk, ttc)} of the valid merged entries."""
    v = valid.cpu()
    rows = v.nonzero()[:, 0].tolist()
    cols = [x.cpu()[v].tolist() for x in (other, risk, ttc)]
    return {(i, o): (r, t) for i, o, r, t in zip(rows, *cols)}


def check_prediction(out, cfg, n, r_cap, torch) -> int:
    """The repo's own checks of a compacted prediction: shapes, finite
    values, risks in [risk_low, 1], oids in range, ttc within the horizon
    plus the sub-window; entries past the qualifying count carry risk -1.
    Returns the qualifying count."""
    risk, veh, other, ttc, dist, count = out[:6]
    r = min(r_cap, n * 32)
    if any(x.shape != (r,) for x in (risk, veh, other, ttc, dist)):
        raise AssertionError("prediction shape")
    c = min(int(count), r)
    if not bool((risk[c:] == -1.0).all()):
        raise AssertionError("prediction padding")
    risk, veh, other, ttc, dist = (x[:c] for x in (risk, veh, other, ttc,
                                                    dist))
    if not bool(((risk >= cfg.alerts.risk_low) & (risk <= 1.0)).all()):
        raise AssertionError("predicted risk outside [risk_low, 1]")
    if not bool((torch.isfinite(ttc) & (ttc >= 0.0)
                 & (ttc <= HORIZON + 1.0)).all()):
        raise AssertionError("predicted ttc outside [0, horizon + 1 s]")
    if not bool((torch.isfinite(dist) & (dist >= 0.0)).all()):
        raise AssertionError("non-finite predicted distance")
    if not bool(((veh >= 0) & (veh < n) & (other >= 0) & (other < n)
                 & (veh != other)).all()):
        raise AssertionError("predicted oids out of range")
    return int(count)


def alert_dict(alerts) -> dict:
    """{(vehicle, other): (risk, ttc, distance, rel_speed, priority)}."""
    v = alerts.valid.cpu()
    cols = [getattr(alerts, f).cpu()[v].tolist()
            for f in ("vehicle_oid", "other_oid", "risk", "ttc", "distance",
                      "rel_speed", "priority")]
    return {(a, b): tuple(rest) for a, b, *rest in zip(*cols)}


def check_output(out, cfg, torch) -> None:
    """The repo's own checks of a step's output: shapes, finite values,
    counters in range (the callers decide which certificates must be
    0)."""
    a = out.alerts
    size = cfg.alerts.max_scene_alerts
    if a.valid.shape != (size,) or a.col_pos.shape != (size, 3):
        raise AssertionError("alert buffer shape")
    v = a.valid
    if int(a.count) != int(v.sum()):
        raise AssertionError("alert count")
    for f in ("risk", "ttc", "distance", "rel_speed"):
        if not bool(torch.isfinite(getattr(a, f)[v]).all()):
            raise AssertionError(f"non-finite alert {f}")
    if not bool(((a.risk[v] >= cfg.alerts.risk_low)
                 & (a.risk[v] <= 1.0)).all()):
        raise AssertionError("alert risk outside [risk_low, 1]")
    if not bool(torch.isfinite(a.col_pos[v]).all()):
        raise AssertionError("non-finite col_pos")
    if int(out.overflow) < 0 or int(out.alert_overflow) < 0:
        raise AssertionError("certificates out of range")


def unordered(alerts) -> dict:
    """alert_dict keyed by the unordered pair (the fused path lists a pair
    from both of its sides, the reference-shaped path once)."""
    return {tuple(sorted(key)): v for key, v in alert_dict(alerts).items()}


def flip_margins(state, cfg, i, j, risk) -> dict:
    """Signed distances of the pair (state rows i, j) to the thresholds
    that decide whether it alerts, recomputed in float64 from the state's
    f32 values: search radius, relative-speed floor, the closest-approach
    time window, the safe distance at closest approach, and risk_low."""
    import numpy as np
    det = cfg.detect
    g = lambda t: t[[i, j]].double().cpu().numpy()
    pos, vel, acc, size = g(state.pos), g(state.vel), g(state.acc), \
        g(state.size)
    rel_pos, sep_vel, sep_acc = pos[1] - pos[0], vel[1] - vel[0], \
        acc[1] - acc[0]
    rs = float(np.linalg.norm(sep_vel))
    conv = 1.0 if det.convention == "physical" else -1.0
    ts = -conv * float(rel_pos @ sep_vel) / max(rs * rs, 1e-300)
    closest = float(np.linalg.norm(rel_pos + sep_vel * ts
                                   + 0.5 * sep_acc * ts * ts))
    safe = (size[0] + size[1]) * 0.5 + det.safe_distance_base
    return dict(radius=det.search_radius - float(np.linalg.norm(rel_pos)),
                rel_speed=rs - det.min_relative_speed, t_star=ts,
                time_window=det.time_window - ts, closest=safe - closest,
                risk_low=risk - cfg.alerts.risk_low)


def compare_paths(name, state, cfg, xla_fn, budget, smi, torch) -> dict:
    """The fused and the reference-shaped detection of one state, at a
    fleet-exact cell_capacity and a scene budget that does not bind. With
    every certificate 0: equal unordered alert sets (values within
    ALERT_TOL, priority exact) and equal risk counts, except for pairs that
    flip, each reported with its nearest threshold and allowed only within
    FLIP_MARGIN of it."""
    from tpu_collide_torch.engine import detect_and_alerts_fused
    from tpu_collide_torch.kernels.tune import suggest_cell_capacity
    cap = suggest_cell_capacity(state, cfg)
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, cell_capacity=cap),
        alerts=dataclasses.replace(cfg.alerts, max_scene_alerts=budget))
    xo = xla_fn(state, cfg)
    fo = detect_and_alerts_fused(state, cfg)
    certs = dict(xla_overflow=int(xo.overflow),
                 xla_alert_overflow=int(xo.alert_overflow),
                 fused_overflow=int(fo.overflow),
                 fused_alert_overflow=int(fo.alert_overflow))
    line = dict(phase="fused_vs_xla", config=name, cell_capacity=cap,
                max_scene_alerts=budget, valid_xla=int(xo.alerts.count),
                valid_fused=int(fo.alerts.count), **certs,
                num_risks_xla=int(xo.num_risks),
                num_risks_fused=int(fo.num_risks),
                num_pairs_checked_xla=int(xo.num_pairs_checked),
                num_pairs_checked_fused=int(fo.num_pairs_checked), card=smi)
    if max(line["valid_xla"], line["valid_fused"]) >= budget:
        raise AssertionError(f"{name}: the scene budget binds")
    if any(certs.values()):
        line.update(compared=False, note="a certificate is not 0")
        return line
    xm, fm = unordered(xo.alerts), unordered(fo.alerts)
    inv = torch.empty(state.n, dtype=torch.int64, device=state.device)
    inv[state.oid.long()] = torch.arange(state.n, device=state.device)
    inv = inv.cpu()
    flips = []
    for pair in sorted(set(xm) ^ set(fm)):
        risk = (xm.get(pair) or fm.get(pair))[0]
        m = flip_margins(state, cfg, int(inv[pair[0]]), int(inv[pair[1]]),
                         risk)
        near = min(m, key=lambda t: abs(m[t]))
        flips.append(dict(pair=pair, only_in="xla" if pair in xm
                          else "fused", threshold=near, margin=m[near]))
    far = [f for f in flips if abs(f["margin"]) > FLIP_MARGIN]
    if far:
        raise AssertionError(f"{name}: pairs flip away from any "
                             f"threshold: {far[:5]}")
    common = set(xm) & set(fm)
    d = max((abs(x - y) for key in common
             for x, y in zip(xm[key][:4], fm[key][:4])), default=0.0)
    if d > ALERT_TOL or any(xm[key][4] != fm[key][4] for key in common):
        raise AssertionError(f"{name}: alert values differ by {d}")
    dr = abs(line["num_risks_xla"] - line["num_risks_fused"])
    if dr > 2 * len(flips):
        raise AssertionError(f"{name}: num_risks differ by {dr} with "
                             f"{len(flips)} flips")
    checked = (line["num_pairs_checked_xla"],
               line["num_pairs_checked_fused"])
    if min(checked) >= 0 and checked[0] != checked[1] and not flips:
        raise AssertionError(f"{name}: num_pairs_checked {checked}")
    if not common:
        raise AssertionError(f"{name}: no alerts to compare")
    line.update(compared=True, pairs=len(common), flips=flips,
                max_abs_diff=d)
    return line


def cosort_operands(state, cfg, torch) -> list:
    """The cell-list build's co-sort operands as the JAX package forms them
    (tpu_collide/kernels/cell_list.py:384-400): an int32 flat cell key
    (here the port's (z, y, x) cell id, dead objects num_cells), then pos,
    vel, acc, size, heading, otype and oid as f32; a 2D world drops the z
    fields."""
    from tpu_collide_torch.index.grid import cell_coords, flatten_cells
    flat = flatten_cells(cell_coords(state.pos, cfg), cfg)
    key = torch.where(state.alive, flat,
                      torch.full_like(flat, cfg.num_cells)).to(torch.int32)
    cols = [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
            state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            state.acc[:, 0], state.acc[:, 1], state.acc[:, 2],
            state.size, state.heading, state.otype.to(torch.float32),
            state.oid.to(torch.float32)]
    if not cfg.world.is_3d:
        cols = [c for i, c in enumerate(cols) if i not in (2, 5, 8)]
    return [key.contiguous()] + [c.contiguous() for c in cols]


def library_sort(ops, torch) -> list:
    """The yardstick: torch.sort of the key and one gather per payload."""
    key, perm = torch.sort(ops[0])
    return [key] + [x[perm] for x in ops[1:]]


def by_key_oid(out, torch) -> list:
    """The operands reordered by (key, oid); oid (the last operand) is
    unique, so two sorts of the same rows give the same order."""
    o = torch.sort(out[-1], stable=True).indices
    o = o[torch.sort(out[0][o], stable=True).indices]
    return [x[o] for x in out]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import (AlertConfig, DetectionConfig,
                                               GridConfig, WorldConfig)
    from tpu_collide_torch.core.state import state_from_numpy
    from tpu_collide_torch.engine import detect_and_alerts_fused
    from tpu_collide_torch.kernels import _build
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.api.scene import _predict_device_fused
    from tpu_collide_torch.detect.predict import (classify_trajectories,
                                                  empty_history,
                                                  predict_collisions,
                                                  predict_offsets,
                                                  update_history)
    from tpu_collide_torch.engine import grid_overflow
    from tpu_collide_torch.index.grid import build_grid
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        predict_topk,
                                                        predict_topk_plain,
                                                        slot_count)
    from tpu_collide_torch.engine import (_chunked_detect_extract,
                                          detect_and_alerts, make_burst_step)
    from tpu_collide_torch.kernels.block_sort import (ceil_pow2, co_sort,
                                                      co_sort_plain,
                                                      network_stages)
    from tpu_collide_torch.kernels.refine import fused_predict
    from tpu_collide_torch.kernels.tune import suggest_cell_capacity
    from tpu_collide_torch.sim import generate_fleet
    import numpy as np

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    emit(dict(phase="device", name=card, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))

    # ---- build ----
    t0 = time.perf_counter()
    _build.load_library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=str(_build.library_path().relative_to(
                  _build.PKG_DIR.parent)),
              ptxas=[ln.strip() for ln in _build.build_log().splitlines()
                     if "registers" in ln or "spill" in ln]))

    # bench.py:337-342 (100k-2D) and :364-373 (1M-3D)
    cfg100k = tt.SystemConfig(
        num_objects=100_000, world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast", count_checked=False),
        alerts=AlertConfig(max_scene_alerts=1024, max_alerts_per_object=8))
    cfg1m = tt.SystemConfig(
        num_objects=1_000_000,
        world=WorldConfig(hi=(10000.0, 10000.0, 500.0)),
        grid=GridConfig(cell_size=50.0),
        detect=DetectionConfig(mode="fast", search_radius=50.0,
                               count_checked=False, gate_stage1=True),
        alerts=AlertConfig(max_scene_alerts=4096))
    mode_of = {"fast": "hits", "precise": "survivors"}
    err = {"hits": 0.0, "survivors": 0.0}

    # ---- kernel_vs_plain: 20k-object fleets, one cell list each ----
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        for det_mode, mode in mode_of.items():
            cfg = base.replace(num_objects=20_000, detect=dataclasses.replace(
                base.detect, mode=det_mode, count_checked=True))
            gen = torch.Generator(device=dev).manual_seed(7)
            st = generate_fleet(gen, cfg, "city_skew")
            cl = build_cell_list(st, cfg)
            got = fused_topk(cl, cfg, mode)
            want = fused_topk_plain(cl, cfg, mode)
            torch.cuda.synchronize()
            res = compare_slots(got, want, slot_count(cfg, mode), torch)
            err[mode] = max(err[mode], res["max_abs_err"])
            emit(dict(phase="kernel_vs_plain", fleet=f"20k_{dim}_cityskew",
                      mode=mode, k=slot_count(cfg, mode), **res,
                      ms=median_ms(lambda: fused_topk(cl, cfg, mode), torch),
                      plain_ms=median_ms(
                          lambda: fused_topk_plain(cl, cfg, mode), torch),
                      card=smi))

    # ---- probe: head-on pair, 100 m apart closing at 20 m/s ----
    for det_mode in mode_of:
        cfg = tt.SystemConfig(num_objects=2,
                              world=WorldConfig(hi=(200.0, 200.0, 0.0)),
                              detect=DetectionConfig(mode=det_mode))
        st = state_from_numpy(
            np.array([[0, 0, 0], [100, 0, 0]], np.float32),
            np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
            np.zeros((2, 3), np.float32), np.array([0.0, np.pi]),
            np.full(2, 2.0), np.zeros(2, np.int32), device=dev)
        got = alert_dict(detect_and_alerts_fused(st, cfg).alerts)
        if set(got) != {(0, 1), (1, 0)} or any(
                abs(v[1] - 4.7) > 1e-5 for v in got.values()):
            raise AssertionError(f"head-on probe: {got}")
        emit(dict(phase="probe", mode=det_mode,
                  ttc=[v[1] for v in got.values()]))

    # ---- main_path ----
    runs = (
        # bench.py:248-249, the 1k headline (city skew)
        ("1k_precise_cityskew",
         tt.SystemConfig(num_objects=1000,
                         detect=DetectionConfig(mode="precise")),
         "city_skew"),
        ("100k_2d_fast", cfg100k, "uniform"),                # bench.py:337
        ("100k_2d_precise", cfg100k.replace(detect=DetectionConfig(
            mode="precise", count_checked=False)), "uniform"),  # :355-356
        ("1m_3d_fast", cfg1m, "uniform"),                    # bench.py:364
    )
    launches = {"hits": 0, "survivors": 0}
    kernel_ms, bounds = {}, {}
    for seed, (name, cfg, dist) in enumerate(runs):
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        state = generate_fleet(gen, cfg, dist)
        step = tt.make_step(cfg, backend="fused", device=dev)
        worst_of = torch.zeros((), dtype=torch.int32, device=dev)
        worst_ao = torch.zeros((), dtype=torch.int32, device=dev)
        events = []
        fused_topk.launches = 0
        for i in range(2 + REPEATS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, out = step(state, gen)
            b.record()
            if i >= 2:
                events.append((a, b))
            worst_of = torch.maximum(worst_of, out.overflow)
            worst_ao = torch.maximum(worst_ao, out.alert_overflow)
        torch.cuda.synchronize()
        n_launch = fused_topk.launches
        if n_launch != 2 + REPEATS:
            raise AssertionError(f"{name}: {n_launch} kernel launches in "
                                 f"{2 + REPEATS} steps")
        mode = mode_of[cfg.detect.mode]
        launches[mode] += n_launch
        check_output(out, cfg, torch)
        if int(worst_of) != 0:
            raise AssertionError(f"{name}: overflow {int(worst_of)}")
        if int(out.num_alive) != cfg.num_objects:
            raise AssertionError(f"{name}: num_alive {int(out.num_alive)}")
        line = dict(
            phase="main_path", config=name, distribution=dist,
            ms_per_step=statistics.median(a.elapsed_time(b)
                                          for a, b in events),
            steps_timed=REPEATS, kernel_launches=n_launch,
            num_risks=int(out.num_risks), alerts=int(out.alerts.count),
            num_pairs_checked=int(out.num_pairs_checked),
            max_risk=float(out.max_risk),
            worst_overflow=int(worst_of), worst_alert_overflow=int(worst_ao),
            card=smi)

        # the kernel alone at this configuration's shapes, with its plain
        # version on the same cell list
        cl = build_cell_list(state, cfg)
        k = slot_count(cfg, mode)
        got, want = fused_topk(cl, cfg, mode), fused_topk_plain(cl, cfg, mode)
        res = compare_slots(got, want, k, torch)
        err[mode] = max(err[mode], res["max_abs_err"])
        kernel_ms[name] = (
            median_ms(lambda: fused_topk(cl, cfg, mode), torch),
            median_ms(lambda: fused_topk_plain(cl, cfg, mode), torch))
        bounds[name] = detect_bound(cl, cfg, mode, got, torch)
        line.update(kernel=mode, kernel_ms=kernel_ms[name][0],
                    plain_ms=kernel_ms[name][1],
                    kernel_max_abs_err=res["max_abs_err"],
                    kernel_bit_equal=res["bit_equal"],
                    kernel_bound=bounds[name])

        if name.startswith("100k"):
            # detection of the stepped state through the kernel and through
            # the plain version, with the scene budget raised past every
            # slot so that it cannot bind
            big = cfg.replace(alerts=dataclasses.replace(
                cfg.alerts, max_scene_alerts=1 << 20))
            ok = detect_and_alerts_fused(state, big)
            pl = detect_and_alerts_fused(state, big,
                                         topk=fused_topk_plain)
            for f in ("num_pairs_checked", "num_risks", "num_alive",
                      "overflow", "alert_overflow", "max_risk"):
                if float(getattr(ok, f)) != float(getattr(pl, f)):
                    raise AssertionError(f"{name}: plain path {f} differs")
            ka, pa = alert_dict(ok.alerts), alert_dict(pl.alerts)
            if set(ka) != set(pa):
                raise AssertionError(f"{name}: alert sets differ")
            d = max((abs(x - y) for key in ka
                     for x, y in zip(ka[key][:4], pa[key][:4])), default=0.0)
            if d > ALERT_TOL or any(ka[key][4] != pa[key][4] for key in ka):
                raise AssertionError(f"{name}: alert values differ by {d}")
            line.update(plain_path=dict(
                max_scene_alerts=1 << 20, alerts=len(ka),
                alert_overflow=int(ok.alert_overflow), max_abs_diff=d,
                note="scene budget raised so it does not bind; ordered "
                     "pairs equal"))
        emit(line)

    # ---- predict_kernel_vs_plain: 20k fleets, one cell list, all offsets --
    offs = torch.tensor(predict_offsets(HORIZON, PRED_STEP),
                        dtype=torch.float32, device=dev)
    pred_err = 0.0
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        cfg = base.replace(num_objects=20_000)
        gen = torch.Generator(device=dev).manual_seed(11)
        st = generate_fleet(gen, cfg, "city_skew")
        # random accelerations and classes, so that every class branch runs
        zmask = torch.tensor([1.0, 1.0, float(cfg.world.is_3d)], device=dev)
        st = st.replace(acc=torch.randn(st.pos.shape, generator=gen,
                                        device=dev) * 0.8 * zmask)
        cls = torch.randint(0, 3, (st.n,), generator=gen, device=dev,
                            dtype=torch.int32)
        cl = build_cell_list(st, cfg, cls=cls)
        pk = lambda: predict_topk(cl, cfg, offs, K_SLOTS, SUB_STEPS)
        pp = lambda: predict_topk_plain(cl, cfg, offs, K_SLOTS, SUB_STEPS)
        got, want = pk(), pp()
        torch.cuda.synchronize()
        res = compare_pred_slots(got, want, K_SLOTS, torch)
        pred_err = max(pred_err, res["max_abs_err"])
        emit(dict(phase="predict_kernel_vs_plain",
                  fleet=f"20k_{dim}_cityskew", offsets=offs.numel(),
                  k=K_SLOTS, sub_steps=SUB_STEPS, **res,
                  ms=median_ms(pk, torch),
                  plain_ms=median_ms(pp, torch, repeats=3), card=smi))

    # ---- predict_path: bench.py's predict row (bench.py:400-450) ----
    t_phase = time.perf_counter()
    cfg = cfg100k
    gen = torch.Generator(device=dev).manual_seed(5)
    state = generate_fleet(gen, cfg, "city_skew")
    step = tt.make_step(cfg, backend="fused", device=dev)
    hist = empty_history(cfg.num_objects, device=dev)
    clock = 0.0
    for _ in range(4):
        # the fleet moves between ticks, so that the classes are mixed
        state, _ = step(state, gen)
        clock += cfg.sim.dt
        hist = update_history(hist, state, clock)
    classes = torch.bincount(classify_trajectories(hist).long(),
                             minlength=3).tolist()
    r_cap = min(cfg.alerts.max_scene_alerts, cfg.num_objects * 32)
    run = lambda: _predict_device_fused(state, hist, cfg, HORIZON,
                                        PRED_STEP, r_cap, k_slots=K_SLOTS)
    predict_topk.launches = 0
    out = run()
    ms_per_predict = median_ms(run, torch)
    n_pred = predict_topk.launches
    if n_pred != 2 + REPEATS:
        raise AssertionError(f"predict_path: {n_pred} kernel launches in "
                             f"{2 + REPEATS} predict calls")
    count = check_prediction(out, cfg, cfg.num_objects, r_cap, torch)
    overflow, slot_oflow, slot_trunc = (int(x) for x in out[6:9])
    if overflow != 0:
        raise AssertionError(f"predict_path: overflow {overflow}")
    line = dict(
        phase="predict_path", config="100k_2d_cityskew_predict",
        classes=classes, ms_per_predict=ms_per_predict,
        calls_timed=REPEATS, kernel_launches=n_pred, risks=count,
        returned=min(count, r_cap), max_risk=float(out[0][0]),
        overflow=overflow, slot_oflow=slot_oflow, slot_trunc=slot_trunc,
        card=smi)
    # the kernel at this size: all offsets, and against its plain version
    # on the first and the last offset (all 20 take the plain version too
    # long)
    cl = build_cell_list(state, cfg, cls=classify_trajectories(hist))
    ends = offs[[0, -1]].contiguous()
    got = predict_topk(cl, cfg, ends, K_SLOTS, SUB_STEPS)
    want = predict_topk_plain(cl, cfg, ends, K_SLOTS, SUB_STEPS)
    res = compare_pred_slots(got, want, K_SLOTS, torch)
    pred_err = max(pred_err, res["max_abs_err"])
    pred_ms = (
        median_ms(lambda: predict_topk(cl, cfg, ends, K_SLOTS, SUB_STEPS),
                  torch),
        median_ms(lambda: predict_topk_plain(cl, cfg, ends, K_SLOTS,
                                             SUB_STEPS), torch, repeats=3))
    pred_bound = predict_bound(cl, cfg, ends, got, SUB_STEPS, torch)
    line.update(kernel_ms_all_offsets=median_ms(
                    lambda: predict_topk(cl, cfg, offs, K_SLOTS, SUB_STEPS),
                    torch),
                kernel_ms_first_last=pred_ms[0],
                plain_ms_first_last=pred_ms[1],
                kernel_bound_first_last=pred_bound,
                kernel_vs_plain_first_last=res,
                phase_seconds=time.perf_counter() - t_phase)
    emit(line)

    # ---- predict_oracle: the kernel path against the grid path ----
    base = cfg100k.replace(num_objects=20_000)
    gen = torch.Generator(device=dev).manual_seed(21)
    state = generate_fleet(gen, base, "uniform")
    step = tt.make_step(base, backend="fused", device=dev)
    hist = empty_history(base.num_objects, device=dev)
    clock = 0.0
    for _ in range(4):
        state, _ = step(state, gen)
        clock += base.sim.dt
        hist = update_history(hist, state, clock)
    index = build_grid(state.pos, state.alive, base)
    nc = base.num_cells
    cap = int((index.starts[1:nc + 1] - index.starts[:nc]).max())
    # a fleet-exact bucket capacity: the grid path truncates nothing
    cfg = base.replace(grid=dataclasses.replace(base.grid,
                                                cell_capacity=cap))
    g_over = int(grid_overflow(index, cfg))
    want = predict_collisions(state, hist, index, cfg, horizon=HORIZON,
                              step=PRED_STEP)
    got = fused_predict(state, hist, cfg, horizon=HORIZON, step=PRED_STEP,
                        k_slots=K_SLOTS)
    if g_over != 0 or int(got[5]) != 0 or int(got[6]) != 0:
        raise AssertionError(f"predict_oracle: grid_overflow {g_over}, "
                             f"overflow {int(got[5])}, slot_oflow "
                             f"{int(got[6])}")
    wm, gm = risk_map(*want[:4]), risk_map(*got[:4])
    if not wm:
        raise AssertionError("predict_oracle: no predicted risks")
    if set(gm) != set(wm):
        raise AssertionError(f"predict_oracle: pair sets differ "
                             f"({len(set(wm) - set(gm))} missing, "
                             f"{len(set(gm) - set(wm))} extra)")
    d = max(abs(x - y) for key in wm for x, y in zip(gm[key], wm[key]))
    if d > ORACLE_TOL:
        raise AssertionError(f"predict_oracle: values differ by {d}")
    emit(dict(phase="predict_oracle", fleet="20k_2d_uniform",
              cell_capacity=cap, grid_overflow=g_over, pairs=len(wm),
              max_abs_diff=d, slot_trunc=int(got[7]), card=smi))

    # ---- xla_path: the reference-shaped step ----
    cfg1k_p = tt.SystemConfig(num_objects=1000,
                              detect=DetectionConfig(mode="precise"))
    xla_runs = (
        # bench.py:248-264, the XLA rows beside the fused headline
        ("1k_precise_cityskew", cfg1k_p, "city_skew", None),
        ("1k_fast_cityskew", tt.SystemConfig(
            num_objects=1000, detect=DetectionConfig(mode="fast")),
         "city_skew", None),
        # bench.py:337-342 through the blocked step (BENCH_NOTES.md:76)
        ("100k_2d_fast_chunked", cfg100k, "uniform", CHUNK),
    )
    xla_states = {}
    for seed, (name, cfg, dist, chunk) in enumerate(xla_runs):
        t_phase = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(200 + seed)
        state = generate_fleet(gen, cfg, dist)
        if chunk:
            # the default 16 truncates 100 m buckets of a 100k fleet: size
            # the capacity from the first state
            cfg = cfg.replace(grid=dataclasses.replace(
                cfg.grid, cell_capacity=suggest_cell_capacity(state, cfg)))
        step = tt.make_step(cfg, backend="xla", chunk_size=chunk, device=dev)
        warm, timed = (1, XLA_100K_STEPS) if chunk else (2, REPEATS)
        worst_of = torch.zeros((), dtype=torch.int32, device=dev)
        worst_ao = torch.zeros((), dtype=torch.int32, device=dev)
        events = []
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(warm + timed):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, out = step(state, gen)
            b.record()
            if i >= warm:
                events.append((a, b))
            worst_of = torch.maximum(worst_of, out.overflow)
            worst_ao = torch.maximum(worst_ao, out.alert_overflow)
        torch.cuda.synchronize()
        check_output(out, cfg, torch)
        if int(out.num_alive) != cfg.num_objects:
            raise AssertionError(f"{name}: num_alive {int(out.num_alive)}")
        xla_states[name] = (state, cfg)
        emit(dict(phase="xla_path", config=name, distribution=dist,
                  chunk_size=chunk, cell_capacity=cfg.grid.cell_capacity,
                  ms_per_step=statistics.median(a.elapsed_time(b)
                                                for a, b in events),
                  steps_timed=timed, warmup_steps=warm,
                  num_risks=int(out.num_risks),
                  alerts=int(out.alerts.count),
                  num_pairs_checked=int(out.num_pairs_checked),
                  max_risk=float(out.max_risk),
                  worst_overflow=int(worst_of),
                  worst_alert_overflow=int(worst_ao),
                  peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                  seconds=time.perf_counter() - t_phase, card=smi))

    # ---- fused_vs_xla: both detection paths on the same state ----
    compared = 0
    for name, xla_fn in (
            ("1k_precise_cityskew", detect_and_alerts),
            ("100k_2d_fast_chunked",
             lambda st, c: _chunked_detect_extract(st, c, CHUNK))):
        state, cfg = xla_states[name]
        line = compare_paths(name, state, cfg, xla_fn, 1 << 18, smi, torch)
        compared += line["compared"]
        emit(line)
    if not compared:
        raise AssertionError("fused_vs_xla: no state with zero certificates")

    # ---- burst: make_burst_step(cfg, 8) against 8 single steps ----
    gen = torch.Generator(device=dev).manual_seed(300)
    st0 = generate_fleet(gen, cfg1k_p, "city_skew")
    burst = make_burst_step(cfg1k_p, 8, device=dev)
    sb, _, ob, risks = burst(st0, torch.Generator(device=dev).manual_seed(7))
    step = tt.make_step(cfg1k_p, device=dev)
    g1 = torch.Generator(device=dev).manual_seed(7)
    cur, outs = st0, []
    for _ in range(8):
        cur, o = step(cur, g1)
        outs.append(o)
    same = all(torch.equal(getattr(sb, f), getattr(cur, f))
               for f in ("pos", "vel", "acc", "heading", "size", "otype",
                         "alive", "oid"))
    want_risks = [int(o.num_risks) for o in outs]
    worst = (max(int(o.overflow) for o in outs),
             max(int(o.alert_overflow) for o in outs))
    if not same or risks.tolist() != want_risks \
            or (int(ob.overflow), int(ob.alert_overflow)) != worst:
        raise AssertionError(f"burst: bit-equal states {same}, risks "
                             f"{risks.tolist()} vs {want_risks}, worst "
                             f"{int(ob.overflow), int(ob.alert_overflow)} "
                             f"vs {worst}")
    emit(dict(phase="burst", config="1k_precise_cityskew", steps=8,
              bit_equal=same, risks_per_step=want_risks,
              worst_overflow=worst[0], worst_alert_overflow=worst[1],
              ms_per_burst=median_ms(
                  lambda: burst(st0, torch.Generator(device=dev)
                                .manual_seed(7)), torch, repeats=3),
              card=smi))

    # ---- detect_probe: make_detect on the head-on pair ----
    st = state_from_numpy(
        np.array([[0, 0, 0], [100, 0, 0]], np.float32),
        np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
        np.zeros((2, 3), np.float32), np.array([0.0, np.pi]),
        np.full(2, 2.0), np.zeros(2, np.int32), device=dev)
    cfg2 = tt.SystemConfig(num_objects=2,
                           world=WorldConfig(hi=(200.0, 200.0, 0.0)))
    ttc = float(tt.make_detect(cfg2, device=dev)(st).ttc.min())
    if abs(ttc - 4.7) > 1e-5:
        raise AssertionError(f"detect_probe: ttc {ttc}")
    emit(dict(phase="detect_probe", ttc=ttc))

    # ---- cosort_vs_plain: the co-sort on the cell list's operands ----
    sort_runs = (("1m_3d_uniform", cfg1m), ("100k_2d_uniform", cfg100k))
    sort_ops = {}
    for seed, (name, cfg) in enumerate(sort_runs):
        gen = torch.Generator(device=dev).manual_seed(400 + seed)
        sort_ops[name] = cosort_operands(generate_fleet(gen, cfg, "uniform"),
                                         cfg, torch)
    co_sort.launches = 0
    sorted_ops = {name: co_sort(ops) for name, ops in sort_ops.items()}
    torch.cuda.synchronize()
    n_sort = co_sort.launches
    if n_sort != len(sort_runs):
        raise AssertionError(f"co_sort: {n_sort} launches for "
                             f"{len(sort_runs)} sorts")
    for name, ops in sort_ops.items():
        got = sorted_ops[name]
        want = co_sort_plain(ops)
        bits = lambda x: x.view(torch.int32)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            raise AssertionError(f"cosort_vs_plain {name}: kernel and plain "
                                 "version differ")
        lib = library_sort(ops, torch)
        if not torch.equal(got[0], lib[0]):
            raise AssertionError(f"cosort_vs_plain {name}: keys differ from "
                                 "torch.sort's")
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(
                by_key_oid(got, torch), by_key_oid(lib, torch))):
            raise AssertionError(f"cosort_vs_plain {name}: rows differ "
                                 "from torch.sort's")
        n = ops[0].numel()
        npad = ceil_pow2(n)
        b = bound(2 * len(ops) * 4 * n,
                  npad // 2 * len(network_stages(npad)))
        line = dict(
            kernel_ms=median_ms(lambda: co_sort(ops), torch),
            plain_ms=median_ms(lambda: co_sort_plain(ops), torch, repeats=3),
            library_ms=median_ms(lambda: library_sort(ops, torch), torch),
            **b)
        if name == "1m_3d_uniform":
            sort_ms = line
        emit(dict(phase="cosort_vs_plain", operands=name, n=n,
                  n_operands=len(ops), bit_equal=True,
                  keys_equal_library=True, rows_equal_library=True, **line,
                  card=smi))

    # no single PyTorch call computes a per-object top-k over a
    # data-dependent stencil: library_ms is null for the three fused modes
    kernels = [dict(name=f"fused_topk[{mode}]", route="cuda",
                    source="tpu_collide_torch/csrc/fused_detect.cu",
                    replaces="tpu_collide/kernels/fused_detect.py:144",
                    launches=launches[mode], max_abs_err=err[mode],
                    ms=kernel_ms[cfg_name][0],
                    plain_ms=kernel_ms[cfg_name][1],
                    bound_ms=bounds[cfg_name]["bound_ms"],
                    bound_by=bounds[cfg_name]["bound_by"], library_ms=None)
               for mode, cfg_name in (("hits", "100k_2d_fast"),
                                      ("survivors", "100k_2d_precise"))]
    kernels.append(dict(name="fused_topk[predict]", route="cuda",
                        source="tpu_collide_torch/csrc/fused_predict.cu",
                        replaces="tpu_collide/kernels/fused_detect.py:553",
                        launches=n_pred, max_abs_err=pred_err,
                        ms=pred_ms[0], plain_ms=pred_ms[1],
                        bound_ms=pred_bound["bound_ms"],
                        bound_by=pred_bound["bound_by"], library_ms=None))
    kernels.append(dict(name="co_sort", route="cuda",
                        source="tpu_collide_torch/csrc/block_sort.cu",
                        replaces=".probe/block_sort.py:158",
                        launches=n_sort, max_abs_err=0.0,
                        ms=sort_ms["kernel_ms"], plain_ms=sort_ms["plain_ms"],
                        bound_ms=sort_ms["bound_ms"],
                        bound_by=sort_ms["bound_by"],
                        library_ms=sort_ms["library_ms"]))
    for kr in kernels:
        if kr["launches"] == 0:
            raise AssertionError(f"{kr['name']} never ran on the main path")
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu", kind=card,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
