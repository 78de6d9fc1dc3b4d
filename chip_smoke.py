"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, one JSON line each (any failure raises and exits non-zero):

  device           the card, and nvidia-smi's name and power limit
  build            nvcc builds tpu_collide_torch/csrc into a shared library
  detect_plan      the detection kernel's launch plan (lanes per object,
                   blocks, threads, shared memory) as the library makes it
                   against kernels/fused_detect.launch_plan
  kernel_vs_plain  the CUDA fused_topk against its plain PyTorch version on
                   one cell list, bit for bit, 2D and 3D, both modes: a
                   20k-object city-skew fleet (its blocks span the ends of
                   cell rows and its objects sit in the edge cells of the
                   world in every direction), the same fleet with a fifth of
                   the objects dead, a dense fleet (dense_fleet) at k = 1, 8,
                   16, 17, 24 and 32, whose candidate lists run to thousands
                   and whose rows emit more pairs than they have slots, a
                   50k uniform fleet (with main_path's fleets these take
                   every width of the kernel's launch plan), 5 objects, and
                   100 objects that are all dead
  probe            the head-on pair (ttc 4.70 s) through the fused path
  main_path        make_step(cfg, backend="fused") at the configurations of
                   bench.py's flagship rows, every certificate 0 (a cell
                   whose certificate is not 0 adopts max_alerts_per_object,
                   or survivor_k and the survivor cap, by bench.py's rule,
                   certified); the kernel bit-equal to its
                   plain version on each stepped fleet; at 100k the step's
                   detection also runs through the plain version and must
                   agree
  predict_kernel_vs_plain
                   the CUDA predict kernel against its plain version on one
                   cell list, all 20 offsets, bit for bit: 20k-object 2D and
                   3D fleets, and a dense fleet (dense_fleet) at k = 1, 8
                   and 16 that fills and wraps the kernel's ring of stage-1
                   survivors and evicts slots
  predict_path     trajectory prediction at the size of bench.py's predict
                   row: 100k city-skew objects, 4 fused steps each followed
                   by update_history, then _predict_device_fused (k_slots
                   16, merge_k 32, horizon 10 s at 0.5 s); the kernel
                   against its plain version on the first and last offset
  predict_oracle   fused_predict (the kernel) against predict_collisions
                   (the grid path) on a 20k uniform fleet whose buckets do
                   not truncate
  scene            api.Scene through its public methods (scene_phase):
                   bench.py's serving row (1k precise city skew, backends
                   xla and fused: 1 warm-up, 30 step(), 30 step_pipelined(),
                   pipeline_drain(); ms per call, certificates, alert
                   stats); 100k 2D fast, 12 steps each with overflow and
                   alert_overflow 0 and one detection launch, the kernel
                   bit-equal to its plain version on the last fleet; 100k
                   2D precise, certified by the Scene's own survivor cap and
                   slot self-heal by the third step; prediction at 100k city
                   skew (4 steps and ticks, 3 predict() calls, the last with
                   overflow and slot_oflow 0, the predict kernel launched on
                   each); step_pipelined x5 + drain against step() x5 and
                   step_burst(8) against 8 step() calls (equal risks, alert
                   sets, alert stats, bit-equal states); an async
                   checkpoint at 100k restored bit-equal into a fresh Scene,
                   whose next step equals the saved state's
  service          the service node over HTTP (service_phase): a
                   CollisionSystem at 100k 2D fast (main_path's fleet, 1,024
                   spare slots) behind the stdlib server; 1,000 vehicles of
                   a VehicleSimulator pushed through http_sink (new, then
                   updated), POST /step x10, pipelined x10, one burst of 8,
                   /detect, GET /alerts, /stats, /health,
                   /vehicles/{id}/risks, a checkpoint and a detection task
                   through POST /tasks, the alerts pump() sends received on
                   TOPIC_ALERTS; every request answered 200, overflow and
                   alert_overflow 0 on every step, one detection launch a
                   fused step, the kernel bit-equal to its plain version on
                   the last fleet; ms per request by route, ingest requests
                   per second. Then the 1k precise city-skew service through
                   POST /step, certified after its self-heal, and
                   python -m tpu_collide_torch.system (10k, fused) as a
                   subprocess: /health, 100 locations, /step, /alerts, exit
                   0 on SIGTERM
  scenario         the device movement modes (scenario_phase) on bench.py's
                   100k 2D configuration and a 100 x 100 grid map of 100 m
                   roads: a road fleet (every object on a road drawn by
                   init_scenario) in fast and in precise mode and a
                   destination fleet through make_scenario_step(backend=
                   "fused"), 2 + 10 steps each, every certificate 0 after
                   bench.py's rule (certified) and one detection launch a
                   step; the kernel bit-equal to its plain version on the
                   stepped road fleet in both modes; a 20k road fleet
                   stepped through both backends to equal states, then its
                   fused and reference-shaped alerts equal (compare_paths);
                   scenario_integrate on the card and on the CPU on the
                   same draws for 10 steps, road switches included: equal
                   road, mode and target_ok, positions within 1e-3 m; the
                   road step and its physics under torch.profiler
  sharded          the sharded step (sharded_phase) at
                   tools/big_mesh_dryrun.py's deployment, 100k objects on
                   an 8x2 grid of shards (halo 1024, migration 256), all
                   16 on the card: the fused sharded step in fast and
                   precise mode, certified by bench.py's rule, conserved
                   on every step (dropped 0, num_alive 100k, every oid
                   once), one detection launch per shard a step; one step
                   against the single-device fused step (equal positions,
                   risks and alert sets, flips reported); the kernel
                   bit-equal to its plain version on one shard's cell list
                   of owned rows and marked halo mirrors, both modes; the
                   sharded scenario step on the 20k road fleet on a 4x2
                   grid against the single-device one (roads and modes
                   kept); a 2x2x2 mesh in a 3D world (steps,
                   make_sharded_ingest of 1,000 updates,
                   make_sharded_detect against the single-device
                   detection); ms/step of the 16-shard step, a one-shard
                   mesh and the single-device step in turns, and
                   torch.profiler's launches and idle share
  sharded_serving  balance, sharded prediction and ShardedScene
                   (sharded_serving_phase) at the sharded phase's 100k
                   8x2 deployment: LoadBalancer on a 100k city-skew fleet
                   (occupancy and imbalance under equal and quantile walls,
                   conservation; 3 fused steps at the deployment's halo
                   under both walls, its drops reported; 3 under the new
                   walls at a shard-sized halo, which drop nothing, and
                   their alert_overflow beside the single device's);
                   make_sharded_predict(backend="fused") on the uniform
                   fleet after 4 steps with migrating trajectory rings
                   (one predict launch per shard a call, CUDA-event ms, a
                   profile) against the single-device fused_predict,
                   equal where both certify; the xla backend against the
                   fused one at 20k; the rebalanced city-skew fleet with
                   hops for its narrowest slab; ShardedScene step,
                   step_pipelined, step_burst, detect, record_trajectories
                   and predict (host ms per call, certificates), precise
                   mode at the adopted survivor_k / cap, a checkpoint
                   restored bit for bit and two async saves; the sharded
                   CollisionSystem over HTTP (reports, POST /step, /detect,
                   GET /alerts, every answer 200) and python -m
                   tpu_collide_torch.system --shards 4 --shards-y 2
  bench            the load harness (bench_phase): (a) the reference's
                   measured harness runs (BASELINE.md: 1k city skew
                   precise at 1,000 TPS for 10 s, 5k at 5,000 TPS for 5
                   s) and (b) bench.py's flagship sizes (100k-2D and
                   1M-3D, fast and precise, flat out for 5 s; the precise
                   rows' survivor cap sized by probe, as bench.py does)
                   through PerformanceTester(backend="fused"): each row
                   certified on the harness's own fleet and generators,
                   then timed (req/s, avg / p95 / p99 / max ms, errors,
                   total_risks) through a recording step: every step's
                   certificates 0, one detection launch a step, the first
                   20 steps' risks equal to the certification replay and
                   the last 10 equal to a replay from the recorded state
                   (determinism); then the kernel bit-equal to its plain
                   version on the cell list of the last step; (c) a
                   profiled run whose Chrome trace names fused_topk_kernel
                   once a step, and python -m
                   tpu_collide_torch.bench.harness writing the reference's
                   artifact triplet; (d) python -m
                   tpu_collide_torch.bench.run_benchmark (benchmark.sh's
                   settings, 10 s): no load error, simulator updates, a
                   tenth of the live objects killed, a monitor CSV
  scale            the twins of the JAX package's scale tools
                   (scale_phase): tools/torch_scale_bench.py's 10M-3D rows
                   (20 x 20 x 1 km, 50 m cells) fast (9 steps in chunks of
                   3) and precise (6 in chunks of 2, the survivor cap by
                   probe), each certified by the twin's adopt rule, every
                   timed step's certificates 0, the kernel bit-equal to its
                   plain version on the last state's cell list (ms, device
                   ms, bound); its 1M-3D one-shard sharded row in turns with
                   the unsharded 1M-3D step, conserved and certified, the
                   kernel on the shard's cell list; then
                   tools/torch_big_mesh_dryrun.py at 65,536 objects on 8x2
                   and 8x8 shards, backends xla and fused (--steps 2), each
                   conserved, overflow 0, risks and alert sets equal to the
                   single-device step's, the fused grids under
                   torch.profiler (launches, idle share), and the kernel on
                   an inner 8x8 shard's cell list of owned rows and marked
                   halo mirrors
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
  cosort_vs_plain  the CUDA co-sort against its plain version, bit for
                   bit: at lengths around its tile and past 2^17 and 2^20,
                   with keys full of ties, all equal, and with INT32_MAX,
                   with 0 and 32 payloads; then on the cell-list build's
                   operands (1M-3D: 14 operands, 100k-2D: 11), there also
                   against torch.sort plus gathers; the launches per sort

The line before the last lists the kernels with their launches (the
detection kernels' on main_path, scene, service, scenario, sharded,
sharded_serving, bench and scale, the predict kernel's on predict_path,
scene and sharded_serving, the co-sort's on cosort_vs_plain; the sum, and
each path's in launches_by_path), their times and their bounds;
the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
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
# The predict kernel's ring of stage-1 survivors (QUEUE in
# csrc/fused_predict.cu) and the warp's width: the dense fleet must drive a
# run longer than twice the ring, a ring that still holds survivors after a
# sweep round, and a last round that is not full
PRED_QUEUE, WARP = 64, 32
# dense_fleet on the card: objects in the cluster and spread over the world
DENSE_CLUSTER, DENSE_SPREAD = 3000, 3000
# slot counts the detection kernel is held to on the dense fleet: one, the
# defaults' range, the reference's most (16), and past it up to the port's
DENSE_K = (1, 8, 16, 17, 24, 32)
# bench.py's cap on an adopted survivor_k (bench.py:186)
BENCH_K_MAX = 16

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


def graph_ms(run, torch, launches=10) -> float:
    """Device ms per call of `run`: `launches` calls captured in a CUDA
    graph and replayed (median of REPEATS replays between CUDA events), so
    that the host's share is left out (tools/torch_detect_kernel.py's
    measure)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [run() for _ in range(launches)]
    ms = median_ms(graph.replay, torch) / launches
    del kept, graph
    return ms


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
    """Detection kernel slots against plain slots: compare_pred_slots, the
    checked and qualifying counters exact, and keys and indices equal bit
    for bit on every row, rows that emitted more than k included."""
    if int(got.checked) != int(want.checked):
        raise AssertionError(f"checked {int(got.checked)} != "
                             f"{int(want.checked)}")
    if not torch.equal(got.qual, want.qual):
        raise AssertionError("qual differs")
    res = compare_pred_slots(got, want, k, torch)
    if not res["bit_equal"]:
        raise AssertionError("slots are not bit-equal")
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


def dense_fleet(n_cluster, n_spread, hi, cell_size, seed) -> dict:
    """numpy arrays of a fleet that crowds one cell: n_cluster objects in a
    disc (a ball in a 3D world) of 0.45 cell sizes around a cell's centre,
    heading at the centre at 4-7 m/s, so that a row's run is long, most of
    it passes stage 1 and many pairs hit; n_spread objects uniform over the
    world at 5-20 m/s. Sizes are continuous (every pair has its own safe
    distance), a third of the fleet accelerates at 1-3 m/s^2, and `cls`
    holds random trajectory classes for callers that keep no history.
    Nothing stands still: a pair at rest has the same risk at every offset,
    and which of the tied offsets a merge keeps is not pinned."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = n_cluster + n_spread
    is3d = hi[2] > 0.0
    hi = np.asarray(hi, np.float64)
    centre = (np.floor(hi / (2 * cell_size)) + 0.5) * cell_size
    u = rng.normal(size=(n_cluster, 3))
    u[:, 2] *= is3d
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = 0.45 * cell_size * rng.uniform(0.05, 1.0, n_cluster) ** 0.5
    pos = rng.uniform(0.0, 1.0, (n, 3)) * hi
    pos[:n_cluster] = centre + u * r[:, None]
    heading = rng.uniform(0.0, 2 * np.pi, n)
    speed = rng.uniform(5.0, 20.0, n)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                    rng.normal(0.0, 3.0, n) * is3d], -1)
    vel[:n_cluster] = -u * rng.uniform(4.0, 7.0, (n_cluster, 1))
    acc = np.zeros((n, 3))
    a = rng.uniform(1.0, 3.0, n) * np.sign(rng.normal(size=n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    acc[2::3, 0] = (a * np.cos(ang))[2::3]
    acc[2::3, 1] = (a * np.sin(ang))[2::3]
    if not is3d:
        pos[:, 2] = 0.0
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(pos=f32(pos), vel=f32(vel), acc=f32(acc),
                heading=f32(np.arctan2(vel[:, 1], vel[:, 0])),
                size=f32(rng.uniform(1.0, 5.0, n)),
                otype=rng.integers(0, 4, n).astype(np.int32),
                alive=np.ones(n, bool), oid=np.arange(n, dtype=np.int32),
                cls=rng.integers(0, 3, n).astype(np.int32))


def predict_edges(cl, cfg, offs, torch) -> dict:
    """How hard these rows drive the predict kernel's walk: the longest
    candidate run of any (offset, row), the most stage-1 survivors of one,
    and, at each offset, for the row with the most survivors among those
    that lose a tenth or more of their candidates at stage 1, the ring of
    stage-1 survivors replayed as the kernel fills it (WARP candidates of a
    run at a time, a sweep round of WARP whenever WARP wait): the most that
    ever waited, and the sizes of the last rounds."""
    from tpu_collide_torch.detect.predict import class_advance
    from tpu_collide_torch.kernels.cell_list import (FI, flat_cells,
                                                     stencil_runs)
    from tpu_collide_torch.kernels.fused_detect import _pair_chunks
    fl = cl.fields
    rows = torch.arange(cl.n, device=fl.device)
    r2 = cfg.detect.search_radius ** 2
    inside = lambda own, cand, pred: (own != cand) & (
        ((fl[cand, 0:3] - pred[own]) ** 2).sum(dim=1) <= r2)
    longest_run = most_survivors = most_waiting = 0
    last_rounds = []
    for o in range(offs.numel()):
        pred = class_advance(fl[:, 0:3], fl[:, 3:6], fl[:, 6:9],
                             fl[:, FI["cls"]], offs[o])
        cells = flat_cells(pred, cl.alive, cfg)
        start, end = stencil_runs(cl, rows, cells)
        longest_run = max(longest_run, int((end - start).max()))
        passed = torch.zeros(cl.n, dtype=torch.int64, device=fl.device)
        for own, cand in _pair_chunks(cl, rows, cells):
            passed += torch.bincount(own[inside(own, cand, pred)],
                                     minlength=cl.n)
        most_survivors = max(most_survivors, int(passed.max()))
        mixed = passed * 10 <= (end - start).sum(dim=1) * 9
        if not bool(mixed.any()):
            continue
        i = int((passed * mixed).argmax())
        waiting = 0
        for j0, j1 in zip(start[i].tolist(), end[i].tolist()):
            cand = torch.arange(j0, j1, device=fl.device)
            ok = inside(torch.full_like(cand, i), cand, pred).tolist()
            for b in range(0, j1 - j0, WARP):
                waiting += sum(ok[b:b + WARP])
                most_waiting = max(most_waiting, waiting)
                if waiting >= WARP:
                    waiting -= WARP
        last_rounds.append(waiting)
    return dict(longest_run=longest_run, most_survivors=most_survivors,
                most_waiting=most_waiting, last_rounds=last_rounds)


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
    """The repo's own checks of a step's output: shapes (a sharded step's
    alert buffers one after another, count per shard), finite values,
    counters in range (the callers decide which certificates must be
    0)."""
    a = out.alerts
    size = cfg.alerts.max_scene_alerts * cfg.shard.total_shards
    if a.valid.shape != (size,) or a.col_pos.shape != (size, 3):
        raise AssertionError("alert buffer shape")
    v = a.valid
    if int(a.count.sum()) != int(v.sum()):
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


# cosort_vs_plain's lengths beside the two fleets: around one tile of the
# kernel (4096 pairs) and two, one past 2^17, and one past 2^20 (padded to
# 2^21, where the last merge's global stages no longer fit one pass)
COSORT_EDGE_N = (1, 2, 4095, 4096, 4097, 8192, (1 << 17) + 1, (1 << 20) + 1)


def cosort_edge_operands(n, keys, n_pay, seed, torch, dev) -> list:
    """An int32 key of length n and n_pay payloads (f32 and i32 in turns).
    keys: 'cells' (cell-id-like: about 7 rows a key, so ties everywhere),
    'equal' (every key tied: any deviation from the network moves a row) or
    'max' (a third of the keys INT32_MAX, which tie with the pads)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    small = torch.randint(0, max(2, n // 7), (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    if keys == "equal":
        key = torch.full_like(small, 3)
    elif keys == "max":
        key = torch.where(torch.rand(n, generator=gen, device=dev) < 0.3,
                          torch.full_like(small, 2 ** 31 - 1), small % 5)
    else:
        key = small
    pays = [torch.randn(n, generator=gen, device=dev) if f % 2 == 0
            else torch.randperm(n, generator=gen, device=dev).to(torch.int32)
            for f in range(n_pay)]
    return [key] + pays


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


def certified(cfg, run):
    """bench.py's rule for a cell whose certificate is not 0 (bench.py:199-226,
    adopt_k), at most twice. Fast mode raises max_alerts_per_object by the
    counted shortfall, up to bench.py's cap of 16, and stops when it cannot
    rise; precise mode raises survivor_k the same way and doubles the
    survivor cap alongside (the certificate also counts survivors beyond
    the cap). The fleet comes from a seed and detection never feeds back
    into physics, so every attempt replays the same trajectories. `run(cfg)`
    returns (worst alert_overflow, result). Returns (the configuration
    adopted, its worst alert_overflow, its result, attempts); a cell that
    stays uncertified comes back with its certificate for the caller to
    refuse."""
    worst, res = run(cfg)
    tries = 1
    while worst > 0 and tries <= 2:
        if cfg.detect.mode == "fast":
            k = cfg.alerts.max_alerts_per_object
            if min(BENCH_K_MAX, k + worst) == k:
                break
            cfg = with_slots(cfg, "hits", min(BENCH_K_MAX, k + worst))
        else:
            cfg = cfg.replace(detect=dataclasses.replace(
                cfg.detect,
                survivor_k=min(BENCH_K_MAX, cfg.detect.survivor_k + worst),
                precise_survivor_cap=2 * cfg.survivor_cap))
        worst, res = run(cfg)
        tries += 1
    return cfg, worst, res, tries


# the rule's name from before it took fast cells
certified_precise = certified


def timed_steps(advance, torch) -> tuple:
    """2 + REPEATS calls of advance() -> StepOutput, the last REPEATS timed
    with CUDA events: (worst overflow, worst alert_overflow, last output,
    median ms per step, the detection kernel's launches). Fails unless every
    step launched the kernel once."""
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    worst_of = worst_ao = None
    events = []
    fused_topk.launches = 0
    for i in range(2 + REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = advance()
        b.record()
        if i >= 2:
            events.append((a, b))
        worst_of = out.overflow if worst_of is None \
            else torch.maximum(worst_of, out.overflow)
        worst_ao = out.alert_overflow if worst_ao is None \
            else torch.maximum(worst_ao, out.alert_overflow)
    torch.cuda.synchronize()
    n_launch = fused_topk.launches
    if n_launch != 2 + REPEATS:
        raise AssertionError(f"{n_launch} kernel launches in "
                             f"{2 + REPEATS} fused steps")
    ms = statistics.median(a.elapsed_time(b) for a, b in events)
    return int(worst_of), int(worst_ao), out, ms, n_launch


def fused_steps(cfg, dist, seed, torch, dev):
    """timed_steps of make_step(cfg, backend="fused") on the fleet of
    `seed`: (worst alert_overflow, (state, last output, worst overflow,
    median ms per step, the detection kernel's launches))."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.sim import generate_fleet
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = generate_fleet(gen, cfg, dist)
    step = tt.make_step(cfg, backend="fused", device=dev)
    carry = [state]

    def advance():
        carry[0], out = step(carry[0], gen)
        return out

    worst_of, worst_ao, out, ms, n_launch = timed_steps(advance, torch)
    return worst_ao, (carry[0], out, worst_of, ms, n_launch)


def main_path_runs():
    """(name, cfg, fleet distribution) of main_path: bench.py's flagship
    rows."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import DetectionConfig
    cfg100k, cfg1m = bench_configs()
    return (
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


def bench_configs():
    """(100k-2D, 1M-3D): bench.py:337-342 and :364-373."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import (AlertConfig, DetectionConfig,
                                               GridConfig, WorldConfig)
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
    return cfg100k, cfg1m


def with_slots(cfg, mode, k):
    """cfg with k slots per object in the detection mode `mode`."""
    if mode == "hits":
        return cfg.replace(alerts=dataclasses.replace(
            cfg.alerts, max_alerts_per_object=k))
    return cfg.replace(detect=dataclasses.replace(cfg.detect, survivor_k=k))


def detect_fleets(base, det_mode, torch, dev):
    """The small fleets the detection kernel is held to its plain version
    on, in the world of `base`: yields (name, cfg, cell list). 20k city
    skew; the same fleet with every fifth object dead; dense_fleet; 50k
    uniform (the four get 16, 16, 32 and 8 lanes per object; main_path's
    fleets get 32, 4 and 2); 5 objects; and 100 objects, all dead."""
    from tpu_collide_torch.core.state import conform_fleet, state_from_numpy
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.sim import generate_fleet
    cfg = base.replace(num_objects=20_000, detect=dataclasses.replace(
        base.detect, mode=det_mode, count_checked=True))
    st = generate_fleet(torch.Generator(device=dev).manual_seed(7), cfg,
                        "city_skew")
    yield "cityskew", cfg, build_cell_list(st, cfg)
    st = st.replace(alive=torch.arange(st.n, device=dev) % 5 != 0)
    yield "dead", cfg, build_cell_list(st, cfg)
    d = dense_fleet(DENSE_CLUSTER, DENSE_SPREAD, cfg.world.hi,
                    cfg.grid.cell_size, seed=13)
    cfg = cfg.replace(num_objects=DENSE_CLUSTER + DENSE_SPREAD)
    st = conform_fleet(state_from_numpy(
        d["pos"], d["vel"], d["acc"], d["heading"], d["size"], d["otype"],
        device=dev), cfg)
    yield "dense", cfg, build_cell_list(st, cfg)
    cfg = cfg.replace(num_objects=50_000)
    st = generate_fleet(torch.Generator(device=dev).manual_seed(9), cfg,
                        "uniform")
    yield "uniform50k", cfg, build_cell_list(st, cfg)
    for name, n in (("five", 5), ("alldead", 100)):
        cfg = cfg.replace(num_objects=n)
        st = generate_fleet(torch.Generator(device=dev).manual_seed(3), cfg,
                            "uniform")
        if name == "alldead":
            st = st.replace(alive=torch.zeros_like(st.alive))
        yield name, cfg, build_cell_list(st, cfg)


def walk_edges(cl) -> dict:
    """How hard a cell list drives the detection kernel's walk: the alive
    objects in the first and last cell of each axis (their stencils are cut
    by the world's edge), the blocks whose own objects lie in more than one
    row of cells, the lanes the launch gives an own object, and the longest
    candidate list."""
    import torch
    from tpu_collide_torch.kernels.cell_list import stencil_runs
    from tpu_collide_torch.kernels.fused_detect import launch_plan
    nx, ny, nz = cl.grid_dims
    c = cl.cell[cl.alive].long()
    cx, cy, cz = c % nx, (c // nx) % ny, c // (nx * ny)
    edge = {f"{ax}_{end}": int((v == at).sum())
            for ax, v, n in (("x", cx, nx), ("y", cy, ny), ("z", cz, nz))
            if n > 1 for end, at in (("first", 0), ("last", n - 1))}
    row = torch.where(cl.alive, cl.cell // nx, torch.full_like(cl.cell, -1))
    plan = launch_plan(cl.n, 1)
    span = plan["threads"] // plan["width"]
    row = torch.nn.functional.pad(row, (0, (-cl.n) % span), value=-1)
    row = row.view(-1, span)
    lo = torch.where(row >= 0, row, row.max() + 1).min(dim=1).values
    start, end = stencil_runs(cl, torch.arange(cl.n, device=cl.cell.device))
    return dict(objects_in_edge_cells=edge,
                blocks_across_row_ends=int((row.max(dim=1).values > lo).sum()),
                lanes_per_object=plan["width"],
                longest_candidate_list=int((end - start).sum(dim=1).max()))


def predict_fleets(base, torch, dev):
    """The two small fleets the predict kernel is held to its plain version
    on, in the world of `base`: yields (name, cfg, cell list). 20k city
    skew with random accelerations and classes, so that every class branch
    runs; and dense_fleet."""
    from tpu_collide_torch.core.state import conform_fleet, state_from_numpy
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.sim import generate_fleet
    cfg = base.replace(num_objects=20_000)
    gen = torch.Generator(device=dev).manual_seed(11)
    st = generate_fleet(gen, cfg, "city_skew")
    zmask = torch.tensor([1.0, 1.0, float(cfg.world.is_3d)], device=dev)
    st = st.replace(acc=torch.randn(st.pos.shape, generator=gen,
                                    device=dev) * 0.8 * zmask)
    cls = torch.randint(0, 3, (st.n,), generator=gen, device=dev,
                        dtype=torch.int32)
    yield "cityskew", cfg, build_cell_list(st, cfg, cls=cls)
    d = dense_fleet(DENSE_CLUSTER, DENSE_SPREAD, cfg.world.hi,
                    cfg.grid.cell_size, seed=13)
    cfg = cfg.replace(num_objects=DENSE_CLUSTER + DENSE_SPREAD)
    st = conform_fleet(state_from_numpy(
        d["pos"], d["vel"], d["acc"], d["heading"], d["size"], d["otype"],
        device=dev), cfg)
    yield "dense", cfg, build_cell_list(
        st, cfg, cls=torch.tensor(d["cls"], device=dev))


def predict_path_inputs(cfg, torch, dev):
    """(state, history) of predict_path: a city-skew fleet from seed 5,
    4 fused steps each followed by a history tick (the fleet moves between
    ticks, so that the classes are mixed)."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.detect.predict import (empty_history,
                                                  update_history)
    from tpu_collide_torch.sim import generate_fleet
    gen = torch.Generator(device=dev).manual_seed(5)
    state = generate_fleet(gen, cfg, "city_skew")
    step = tt.make_step(cfg, backend="fused", device=dev)
    hist = empty_history(cfg.num_objects, device=dev)
    clock = 0.0
    for _ in range(4):
        state, _ = step(state, gen)
        clock += cfg.sim.dt
        hist = update_history(hist, state, clock)
    return state, hist


# the scene phase: calls of bench.py's Scene serving row (bench.py:307-321
# times 60; 30 of each mode here), steps of the 100k Scene, predict calls
SCENE_CALLS, SCENE_STEPS, SCENE_PREDICTS = 30, 10, 3
# the survivor_k / cap chip_smoke.certified adopts at 100k precise
CERTIFIED_100K_PRECISE = (12, 400_000)
# where the scene and service phases write their checkpoints (gitignored,
# emptied after)
ROOT = pathlib.Path(__file__).resolve().parent
SCRATCH = ROOT / ".scratch"


def timed_calls(fn, n) -> tuple:
    """(outputs, ms per call) of n calls of fn, each timed on the host
    clock (fn returns after its host wait, as a Scene method does)."""
    outs, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        outs.append(fn())
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def call_stats(ms) -> dict:
    """Average and p95 of ms per call, as bench.py computes them."""
    srt = sorted(ms)
    return dict(avg=sum(srt) / len(srt), p95=srt[int(0.95 * len(srt))])


def worst_certificates(outs) -> dict:
    return dict(worst_overflow=max(int(o.overflow) for o in outs),
                worst_alert_overflow=max(int(o.alert_overflow)
                                         for o in outs))


def states_equal(a, b, torch) -> bool:
    """Every field of two states equal, bit for bit."""
    from tpu_collide_torch.core.state import FIELDS
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def scene_phase(smi, torch, dev) -> dict:
    """The Scene serving surface on the card, through its public methods:
    bench.py's serving row on both backends, the 100k fast and precise
    fleets, prediction at 100k city skew, pipelined and burst stepping
    against plain steps, and a checkpoint round trip. Emits one line per
    part; returns the kernels' launches in the phase by mode."""
    import shutil
    import tempfile
    from tpu_collide_torch.api import Scene
    from tpu_collide_torch.core.state import FIELDS
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        predict_topk)
    from tpu_collide_torch.sim import generate_fleet
    fleet = lambda cfg, dist, seed: generate_fleet(
        torch.Generator(device=dev).manual_seed(seed), cfg, dist)
    launches = {"hits": 0, "survivors": 0, "predict": 0}
    runs = {name: (cfg, dist) for name, cfg, dist in main_path_runs()}
    cfg_p = runs["1k_precise_cityskew"][0]
    cfg_f, cfg_pr = runs["100k_2d_fast"][0], runs["100k_2d_precise"][0]

    # ---- serving at bench.py's serving row, both backends ----
    for backend in ("xla", "fused"):
        t_part = time.perf_counter()
        fused_topk.launches = 0
        sc = Scene(cfg_p, state=fleet(cfg_p, "city_skew", 12),
                   backend=backend, device=dev)
        probe = fused_topk.launches    # the fleet-exact survivor cap's
        warm = sc.step()
        steps, step_ms = timed_calls(sc.step, SCENE_CALLS)
        piped, pipe_ms = timed_calls(sc.step_pipelined, SCENE_CALLS)
        piped = piped[1:] + [sc.pipeline_drain()]
        n_launch = fused_topk.launches - probe
        launches["survivors"] += fused_topk.launches
        want = 1 + 2 * SCENE_CALLS if backend == "fused" else 0
        if n_launch != want:
            raise AssertionError(f"scene serving {backend}: {n_launch} "
                                 f"detection launches in {1 + 2 * SCENE_CALLS}"
                                 " steps")
        for o in steps + piped:
            check_output(o, sc.cfg, torch)
        emit(dict(phase="scene", part="serving",
                  config="1k_precise_cityskew", backend=backend,
                  calls=SCENE_CALLS, step_ms=call_stats(step_ms),
                  step_pipelined_ms=call_stats(pipe_ms),
                  detection_launches=n_launch, probe_launches=probe,
                  warmup_alert_overflow=int(warm.alert_overflow),
                  **worst_certificates(steps + piped),
                  last_alert_overflow=int(piped[-1].alert_overflow),
                  survivor_k=sc.cfg.detect.survivor_k,
                  survivor_cap=sc.cfg.survivor_cap,
                  window_regrows=sc.window_regrows,
                  step_and_copy_avg_ms=sc.stats()["avg_step_ms"],
                  num_alive=sc.stats()["num_alive"],
                  alert_stats=sc.alert_manager.get_stats(),
                  seconds=time.perf_counter() - t_part, card=smi))

    # ---- serving at full width: 100k 2D fast ----
    t_part = time.perf_counter()
    sc = Scene(cfg_f, state=fleet(cfg_f, "uniform", 101), backend="fused",
               device=dev)
    fused_topk.launches = 0
    outs, ms = timed_calls(sc.step, 2 + SCENE_STEPS)
    n_launch = fused_topk.launches
    launches["hits"] += n_launch
    certs = [(int(o.overflow), int(o.alert_overflow)) for o in outs]
    if n_launch != len(outs) or any(c != (0, 0) for c in certs):
        raise AssertionError(f"scene 100k_2d_fast: {n_launch} launches in "
                             f"{len(outs)} steps, certificates {certs}")
    check_output(outs[-1], sc.cfg, torch)
    cl = build_cell_list(sc.state, sc.cfg)
    k = sc.cfg.alerts.max_alerts_per_object
    res = compare_slots(fused_topk(cl, sc.cfg, "hits"),
                        fused_topk_plain(cl, sc.cfg, "hits"), k, torch)
    emit(dict(phase="scene", part="serving", config="100k_2d_fast",
              backend="fused", steps=len(outs), warmup_steps=2,
              step_ms=call_stats(ms[2:]), detection_launches=n_launch,
              step_and_copy_avg_ms=sc.stats()["avg_step_ms"],
              certificates=certs, num_risks=int(outs[-1].num_risks),
              alerts=int(outs[-1].alerts.count), k=k,
              kernel_vs_plain=res, alert_stats=sc.alert_manager.get_stats(),
              seconds=time.perf_counter() - t_part, card=smi))

    # ---- precise at 100k: the Scene's own fleet-exact cap and self-heal --
    t_part = time.perf_counter()
    fused_topk.launches = 0
    sc = Scene(cfg_pr, state=fleet(cfg_pr, "uniform", 102), backend="fused",
               device=dev)
    adopted = (sc.cfg.detect.survivor_k, sc.cfg.survivor_cap)
    outs, ms = timed_calls(sc.step, 3)
    launches["survivors"] += fused_topk.launches
    aos = [int(o.alert_overflow) for o in outs]
    if any(int(o.overflow) for o in outs) or aos[-1] != 0 \
            or fused_topk.launches != 1 + len(outs):
        raise AssertionError(f"scene 100k_2d_precise: alert_overflow {aos}, "
                             f"{fused_topk.launches} launches")
    check_output(outs[-1], sc.cfg, torch)
    emit(dict(phase="scene", part="precise", config="100k_2d_precise",
              backend="fused", alert_overflow_per_step=aos, step_ms=ms,
              adopted_survivor_k_cap=adopted,
              healed_survivor_k_cap=(sc.cfg.detect.survivor_k,
                                     sc.cfg.survivor_cap),
              certified_precise_k_cap=CERTIFIED_100K_PRECISE,
              window_regrows=sc.window_regrows,
              num_risks=int(outs[-1].num_risks),
              seconds=time.perf_counter() - t_part, card=smi))

    # ---- prediction at 100k city skew ----
    t_part = time.perf_counter()
    fused_topk.launches = predict_topk.launches = 0
    sc = Scene(cfg_f, state=fleet(cfg_f, "city_skew", 5), backend="fused",
               device=dev)
    for _ in range(4):
        sc.step()
        sc.record_trajectories()
    calls = []
    for _ in range(SCENE_PREDICTS):
        before = predict_topk.launches
        t0 = time.perf_counter()
        risks = sc.predict()
        ms = (time.perf_counter() - t0) * 1e3
        calls.append(dict(ms=ms, returned=len(risks),
                          launches=predict_topk.launches - before,
                          **sc.last_predict))
    launches["hits"] += fused_topk.launches
    launches["predict"] += predict_topk.launches
    last = calls[-1]
    if fused_topk.launches != 4 or any(c["launches"] != 1 for c in calls) \
            or last["overflow"] != 0 or last["slot_oflow"] != 0 \
            or not last["returned"]:
        raise AssertionError(f"scene predict: {calls}, {fused_topk.launches}"
                             " detection launches in 4 steps")
    emit(dict(phase="scene", part="predict",
              config="100k_2d_cityskew_predict", backend="fused",
              calls=calls, k_slots_reached=sc._predict_slots,
              window_regrows=sc.window_regrows,
              seconds=time.perf_counter() - t_part, card=smi))

    # ---- equalities: pipelined and burst against plain steps ----
    t_part = time.perf_counter()
    fused_topk.launches = 0
    mk = lambda: Scene(cfg_f, state=fleet(cfg_f, "uniform", 103),
                       backend="fused", device=dev)
    a, b = mk(), mk()
    outs_a = [a.step() for _ in range(5)]
    outs_b = [b.step_pipelined() for _ in range(5)][1:] + [b.pipeline_drain()]
    same_risks = [int(x.num_risks) for x in outs_a] == \
        [int(x.num_risks) for x in outs_b]
    same_alerts = all(alert_dict(x.alerts) == alert_dict(y.alerts)
                      for x, y in zip(outs_a, outs_b))
    same_stats = a.alert_manager.get_stats() == b.alert_manager.get_stats()
    same_state = states_equal(a.state, b.state, torch)
    c, d = mk(), mk()
    c.step_burst(8)
    for _ in range(8):
        d.step()
    burst_equal = states_equal(c.state, d.state, torch)
    launches["hits"] += fused_topk.launches
    if not (same_risks and same_alerts and same_stats and same_state
            and burst_equal) or fused_topk.launches != 26:
        raise AssertionError(
            f"scene equalities: pipelined risks {same_risks}, alerts "
            f"{same_alerts}, stats {same_stats}, state {same_state}; burst "
            f"{burst_equal}; {fused_topk.launches} launches")
    emit(dict(phase="scene", part="equalities", config="100k_2d_fast",
              pipelined_vs_step=dict(steps=5, num_risks_equal=True,
                                     alert_sets_equal=True,
                                     alert_stats_equal=True,
                                     states_bit_equal=True),
              burst_vs_steps=dict(steps=8, states_bit_equal=True),
              seconds=time.perf_counter() - t_part, card=smi))

    # ---- checkpoint at 100k ----
    t_part = time.perf_counter()
    fused_topk.launches = 0
    SCRATCH.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="scene_ckpt_", dir=SCRATCH)
    try:
        a = Scene(cfg_f, state=fleet(cfg_f, "uniform", 104), backend="fused",
                  checkpoint_dir=ckpt_dir, device=dev)
        a.step(3)
        snap = a.state.replace(**{f: getattr(a.state, f).clone()
                                  for f in FIELDS})
        t0 = time.perf_counter()
        a.save_checkpoint_async()
        call_ms = (time.perf_counter() - t0) * 1e3
        a.step()                      # serving goes on during the write
        a.ckpt.wait_async()
        save_ms = (time.perf_counter() - t0) * 1e3
        b = Scene(cfg_f, backend="fused", checkpoint_dir=ckpt_dir,
                  device=dev)
        t0 = time.perf_counter()
        at = b.restore_checkpoint()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        restored_equal = states_equal(b.state, snap, torch)
        # one further step from the restored state and from the saved one,
        # each on a Scene with a fresh generator
        c = Scene(cfg_f, state=snap, backend="fused", device=dev)
        ob, oc = b.step(), c.step()
        step_equal = (int(ob.num_risks) == int(oc.num_risks)
                      and alert_dict(ob.alerts) == alert_dict(oc.alerts)
                      and states_equal(b.state, c.state, torch))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches["hits"] += fused_topk.launches
    if not (restored_equal and step_equal and at == 3):
        raise AssertionError(f"scene checkpoint: restored step {at}, state "
                             f"bit-equal {restored_equal}, next step equal "
                             f"{step_equal}")
    emit(dict(phase="scene", part="checkpoint", config="100k_2d_fast",
              restored_step=at, state_bit_equal=True, next_step_equal=True,
              save_async_call_ms=call_ms, save_ms=save_ms,
              restore_ms=restore_ms,
              seconds=time.perf_counter() - t_part, card=smi))
    return launches


# the service phase: vehicles pushed over HTTP (new ids, then one update
# each), spare fleet slots for them, plain and pipelined POST /step
# requests, the steps of one burst request, POST /step on the precise
# service; a detection loop slower than the phase (its first sweep finds no
# fleet, its next comes after the phase), so that it holds no lock through
# the timed requests
SERVICE_VEHICLES, SERVICE_SPARE = 1000, 1024
SERVICE_STEPS, SERVICE_BURST, SERVICE_PRECISE_STEPS = 10, 8, 5
SERVICE_DETECTION_HZ = 0.01
# python -m tpu_collide_torch.system: its fleet capacity, the locations
# posted to it, and how long it may take to answer /health and to stop
ENTRY_OBJECTS, ENTRY_LOCATIONS, ENTRY_WAIT_S = 10_000, 100, 180


def http_call(base, method, path, body=None) -> tuple:
    """(payload, ms on the host clock) of one request; fails unless it is
    answered 200."""
    import urllib.request
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        payload = json.loads(r.read())
        status = r.status
    ms = (time.perf_counter() - t0) * 1e3
    if status != 200 or not payload.get("success"):
        raise AssertionError(f"{method} {path}: {status} {payload}")
    return payload, ms


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServiceNode:
    """A CollisionSystem and a SceneHTTPServer on its Scene, its asyncio
    loop on a thread of its own; `outputs` collects every StepOutput the
    Scene's step methods return, whoever calls them. Stop with stop()."""

    def __init__(self, cfg, dev, ckpt_dir, on_alert=None):
        import asyncio
        import threading
        from tpu_collide_torch.api.stdlib_server import SceneHTTPServer
        from tpu_collide_torch.runtime.messaging import TOPIC_ALERTS
        from tpu_collide_torch.system import CollisionSystem
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = None
        self.system = CollisionSystem(
            cfg, checkpoint_dir=ckpt_dir, detection_hz=SERVICE_DETECTION_HZ,
            checkpoint_every_s=0, backend="fused", device=dev)
        if on_alert is not None:
            self.system.broker.subscribe(TOPIC_ALERTS, on_alert)
        self.started = False
        self.run(self.system.start())
        self.started = True
        self.scene = self.system.scene
        self.outputs = []
        for name in ("step", "step_pipelined", "step_burst",
                     "pipeline_drain"):
            setattr(self.scene, name, self._recording(getattr(self.scene,
                                                              name)))
        self.server = SceneHTTPServer(self.scene, port=0,
                                      scheduler=self.system.scheduler)
        self.base = f"http://127.0.0.1:{self.server.start()}"

    def _recording(self, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            if out is not None:
                self.outputs.append(out)
            return out
        return call

    def run(self, coro, timeout=120):
        import asyncio
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def certificates(self) -> list:
        """(overflow, alert_overflow) of every recorded output."""
        with self.scene._device_lock:
            return [(int(o.overflow), int(o.alert_overflow))
                    for o in self.outputs]

    def stop(self) -> None:
        try:
            if self.server is not None:
                self.server.stop()
            if self.started:
                self.run(self.system.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


def padded_fleet(state, spare, torch):
    """The fleet with `spare` dead slots after it (oids stay the slots)."""
    from tpu_collide_torch.core.state import FIELDS, empty_state
    pad = empty_state(spare, device=state.pos.device)
    out = state.replace(**{f: torch.cat([getattr(state, f), getattr(pad, f)])
                           for f in FIELDS})
    return out.replace(oid=torch.arange(out.n, dtype=torch.int32,
                                        device=state.pos.device))


def entry_point(extra_args=()) -> dict:
    """python -m tpu_collide_torch.system on a free port, as a user starts
    the service: waits for /health, posts ENTRY_LOCATIONS locations (pairs
    closing at 20 m/s), POST /step, GET /alerts, then SIGTERM. Fails unless
    every answer is 200 and the process exits 0."""
    import os
    import shutil
    import sys
    import tempfile
    import urllib.error
    import urllib.request
    SCRATCH.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="entry_", dir=SCRATCH)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    log = pathlib.Path(work) / "system.log"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_collide_torch.system",
             "--objects", str(ENTRY_OBJECTS), "--backend", "fused",
             "--api-port", str(port), "--checkpoint-dir", work,
             "--log-level", "WARNING", *extra_args],
            cwd=ROOT, env=env, stdout=fh, stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"system exited {proc.returncode} "
                                     f"before /health: {log.read_text()}")
            try:
                http_call(base, "GET", "/health")
                with urllib.request.urlopen(base + "/health", timeout=30) as r:
                    server = r.headers.get("Server")
                break
            except (urllib.error.URLError, ConnectionError):
                if time.perf_counter() - t0 > ENTRY_WAIT_S:
                    raise AssertionError(f"no /health in {ENTRY_WAIT_S} s")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        ms = []
        for i in range(ENTRY_LOCATIONS):
            side, row = i % 2, i // 2
            body = {"vehicle_id": f"entry-{i}",
                    "position": {"x": 100.0 + 60.0 * side,
                                 "y": 100.0 + 150.0 * row},
                    "velocity": {"x": 10.0 - 20.0 * side},
                    "heading": 3.14159 * side}
            ms.append(http_call(base, "POST", "/vehicles/location", body)[1])
        step, step_ms = http_call(base, "POST", "/step", {})
        alerts, alerts_ms = http_call(base, "GET", "/alerts")
    except Exception as e:
        raise AssertionError(f"entry point: {e!r}; the system's log: "
                             f"{log.read_text()[-4000:]}") from e
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            rc = proc.wait(timeout=ENTRY_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
    if rc != 0:
        raise AssertionError(f"system exited {rc} after SIGTERM: "
                             f"{log.read_text()}")
    if not alerts["data"]:
        raise AssertionError(f"entry point: no alerts after {step}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(objects=ENTRY_OBJECTS, server=server, seconds_to_health=up_s,
                location_ms=call_stats(ms), step=step["data"],
                step_ms=step_ms, alerts=len(alerts["data"]),
                alerts_ms=alerts_ms, exit_code=rc,
                seconds=time.perf_counter() - t0)


def service_phase(smi, torch, dev) -> dict:
    """The service node on the card, through HTTP: a CollisionSystem on
    main_path's 100k 2D fast fleet (with spare slots) behind the stdlib
    server, vehicles of a VehicleSimulator pushed through http_sink, POST
    /step plain, pipelined and burst, /detect, the queries, two tasks and
    the broker's alerts; a precise 1k service through POST /step; then the
    entry point a user starts. Emits one line per part; returns the
    detection kernel's launches in the phase by mode."""
    import shutil
    import tempfile
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain)
    from tpu_collide_torch.sim import (TrafficMap, VehicleSimulator,
                                       generate_fleet)
    from tpu_collide_torch.sim.traffic import http_sink
    runs = list(main_path_runs())
    seeds = {name: 100 + i for i, (name, _, _) in enumerate(runs)}
    runs = {name: (cfg, dist) for name, cfg, dist in runs}
    launches = {"hits": 0, "survivors": 0}
    SCRATCH.mkdir(exist_ok=True)

    # ---- the 100k fast service ----
    t_part = time.perf_counter()
    cfg0, dist = runs["100k_2d_fast"]
    fleet = generate_fleet(torch.Generator(device=dev).manual_seed(
        seeds["100k_2d_fast"]), cfg0, dist)
    cfg = cfg0.replace(num_objects=cfg0.num_objects + SERVICE_SPARE)
    heard = []

    async def on_alert(msg):
        heard.append(msg)

    ckpt_dir = tempfile.mkdtemp(prefix="service_ckpt_", dir=SCRATCH)
    node = None
    try:
        node = ServiceNode(cfg, dev, ckpt_dir, on_alert)
        sc, base = node.scene, node.base
        sc.adopt_fleet(padded_fleet(fleet, SERVICE_SPARE, torch),
                       ids=[f"fleet-{i}" for i in range(cfg0.num_objects)])
        # a road grid over the configuration's world, a road every cell
        cs = cfg.grid.cell_size
        roads = TrafficMap(seed=7).generate_grid_map(
            *(int(e // cs) for e in cfg.world.extent[:2]), cell_size=cs)
        sim = VehicleSimulator(roads, num_vehicles=SERVICE_VEHICLES, seed=7)
        sim.initialize_vehicles()
        push = http_sink(base)
        ms = {}

        def ingest(route):
            batch = sim.to_location_data()
            t0 = time.perf_counter()
            for loc in batch:
                t1 = time.perf_counter()
                push([loc])
                ms.setdefault(route, []).append(
                    (time.perf_counter() - t1) * 1e3)
            return len(batch) / (time.perf_counter() - t0)

        def request(route, method, path, body=None):
            payload, t = http_call(base, method, path, body)
            ms.setdefault(route, []).append(t)
            return payload["data"]

        ingest_rate = {"new": ingest("POST /vehicles/location (new)")}
        sim.update_vehicles(0.1)
        ingest_rate["update"] = ingest("POST /vehicles/location (update)")

        fused_topk.launches = 0
        node.outputs.clear()
        for _ in range(SERVICE_STEPS):
            step = request("POST /step", "POST", "/step", {})
        for _ in range(SERVICE_STEPS):
            request("POST /step pipelined", "POST", "/step",
                    {"pipelined": True})
        sc.pipeline_drain()        # the last pipelined step's output
        burst = request(f"POST /step burst {SERVICE_BURST}", "POST", "/step",
                        {"burst": True, "steps": SERVICE_BURST})
        detect = request("POST /detect", "POST", "/detect", {})
        n_launch = fused_topk.launches
        certs = node.certificates()
        n_steps = 2 * SERVICE_STEPS + SERVICE_BURST
        if sc.ingested_count != cfg0.num_objects + SERVICE_VEHICLES:
            raise AssertionError(f"service: {sc.ingested_count} vehicles")
        launches["hits"] += n_launch
        if n_launch != n_steps or len(certs) != 2 * SERVICE_STEPS + 1 \
                or any(c != (0, 0) for c in certs):
            raise AssertionError(f"service 100k_2d_fast: {n_launch} launches "
                                 f"in {n_steps} fused steps, certificates "
                                 f"{certs}")
        with sc._device_lock:
            cl = build_cell_list(sc.state, sc.cfg)
            k = sc.cfg.alerts.max_alerts_per_object
            res = compare_slots(fused_topk(cl, sc.cfg, "hits"),
                                fused_topk_plain(cl, sc.cfg, "hits"), k,
                                torch)
        if not res["bit_equal"]:
            raise AssertionError("service 100k_2d_fast: the kernel differs "
                                 "from its plain version")

        alerts = request("GET /alerts", "GET", "/alerts")
        request("GET /stats", "GET", "/stats")
        request("GET /health", "GET", "/health")
        vid = alerts[0]["vehicle_id"]
        risks = request("GET /vehicles/{id}/risks", "GET",
                        f"/vehicles/{vid}/risks")
        done0 = node.system.scheduler.stats["completed"]
        for kind in ("checkpoint", "collision_detection"):
            request("POST /tasks", "POST", "/tasks", {"task_type": kind})
        deadline = time.perf_counter() + 120
        while node.system.scheduler.stats["completed"] < done0 + 2:
            if time.perf_counter() > deadline \
                    or node.system.scheduler.stats["failed"]:
                raise AssertionError(f"service tasks: "
                                     f"{node.system.scheduler.get_stats()}")
            time.sleep(0.05)
        # every alert pump() has sent by now reaches the subscriber (resends
        # come every resend_interval_s, so count alerts, not messages)
        with sc.alert_manager._lock:
            sent = {a.id for a in sc.alert_manager.alerts.values()
                    if a.last_sent > 0}
        deadline = time.perf_counter() + 60
        while sent - {m.value["id"] for m in list(heard)}:
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"broker: {len(sent - {m.value['id'] for m in heard})} "
                    f"of {len(sent)} sent alerts not received, "
                    f"{node.system.broker.get_stats()}")
            time.sleep(0.05)
        dropped = node.system.broker.stats["dropped"]
        if not sent or dropped:
            raise AssertionError(f"broker: {len(sent)} alerts sent, "
                                 f"{dropped} messages dropped")
        emit(dict(
            phase="service", part="fused", config="100k_2d_fast",
            capacity=cfg.num_objects, fleet=cfg0.num_objects,
            http_vehicles=SERVICE_VEHICLES,
            ms_per_request={r: dict(calls=len(v), **call_stats(v))
                            for r, v in ms.items()},
            ingest_requests_per_s=ingest_rate,
            step_and_copy_avg_ms=sc.stats()["avg_step_ms"],
            detection_launches=n_launch, fused_steps=n_steps,
            certificates=certs, last_step=step, burst=burst,
            detect=detect, alerts=len(alerts), risks_of_one_vehicle=len(risks),
            kernel_vs_plain=res, alerts_sent=len(sent),
            messages_received_on_broker=len(heard),
            broker=node.system.broker.get_stats(),
            scheduler=node.system.scheduler.get_stats(),
            alert_stats=sc.alert_manager.get_stats(),
            seconds=time.perf_counter() - t_part, card=smi))
    finally:
        if node is not None:
            node.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- the 1k precise service: the Scene's own self-heal ----
    t_part = time.perf_counter()
    cfg, dist = runs["1k_precise_cityskew"]
    ckpt_dir = tempfile.mkdtemp(prefix="service_ckpt_", dir=SCRATCH)
    node = None
    try:
        node = ServiceNode(cfg, dev, ckpt_dir)
        node.scene.adopt_fleet(generate_fleet(
            torch.Generator(device=dev).manual_seed(12), cfg, dist))
        fused_topk.launches = 0
        ms = [http_call(node.base, "POST", "/step", {})[1]
              for _ in range(SERVICE_PRECISE_STEPS)]
        n_launch = fused_topk.launches
        certs = node.certificates()
        launches["survivors"] += n_launch
        if n_launch != SERVICE_PRECISE_STEPS or certs[-1] != (0, 0) \
                or any(of for of, _ in certs):
            raise AssertionError(f"service 1k_precise_cityskew: {n_launch} "
                                 f"launches, certificates {certs}")
        emit(dict(phase="service", part="precise",
                  config="1k_precise_cityskew", step_ms=call_stats(ms),
                  detection_launches=n_launch, certificates=certs,
                  survivor_k=node.scene.cfg.detect.survivor_k,
                  survivor_cap=node.scene.cfg.survivor_cap,
                  window_regrows=node.scene.window_regrows,
                  seconds=time.perf_counter() - t_part, card=smi))
    finally:
        if node is not None:
            node.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ---- the entry point a user starts ----
    emit(dict(phase="service", part="entry_point",
              command="python -m tpu_collide_torch.system --objects "
                      f"{ENTRY_OBJECTS} --backend fused --api-port PORT",
              **entry_point(("--device", str(dev))), card=smi))
    return launches


# the scenario phase: the road fleet of 20k objects that fused_vs_xla compares
# on, stepped SCENARIO_SMALL_STEPS times through both backends first; the
# steps held card against CPU and the largest position difference allowed
# (libm differs between the two); the steps under the profiler
SCENARIO_SMALL, SCENARIO_SMALL_STEPS = 20_000, 3
SCENARIO_CPU_STEPS, SCENARIO_CPU_TOL = 10, 1e-3
SCENARIO_PROFILE_STEPS = 3


def scenario_setup():
    """(cfg, TrafficMap) of the scenario phase: bench.py's 100k 2D fast
    configuration (bench.py:337-342) and the 100 x 100 grid map of 100 m
    roads and up to 5 cities of tests/test_scenario.py:178, which covers its
    10 km world with 202 roads of 10 km."""
    from tpu_collide_torch.sim import TrafficMap
    return bench_configs()[0], TrafficMap(seed=4).generate_grid_map(
        100, 100, 100.0)


def road_fleet(cfg, roads, seed, torch, dev):
    """generate_fleet (uniform, `seed`) with every object road_constrained:
    init_scenario draws its road, and it is snapped onto the road at a
    fraction U(0.1, 0.9) of its length (tests/test_scenario.py:199-203)."""
    from tpu_collide_torch.sim import generate_fleet, init_scenario
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = generate_fleet(gen, cfg, "uniform")
    scen = init_scenario(cfg.num_objects, "road_constrained", roads, gen,
                         device=dev)
    frac = torch.rand(cfg.num_objects, generator=gen, device=dev) * 0.8 + 0.1
    r = scen.road.long()
    pos = state.pos.clone()
    pos[:, :2] = roads.start[r] + (frac * roads.length[r])[:, None] \
        * roads.dirn[r]
    return state.replace(pos=pos), scen


def dest_fleet(cfg, seed, torch, dev):
    """generate_fleet (uniform, `seed`) with every object
    destination_oriented and no target yet."""
    from tpu_collide_torch.sim import generate_fleet, init_scenario
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (generate_fleet(gen, cfg, "uniform"),
            init_scenario(cfg.num_objects, "destination_oriented",
                          device=dev))


def scenario_steps(cfg, fleet, tables, seed, torch, dev):
    """timed_steps of make_scenario_step(cfg, roads, cities,
    backend="fused") from `fleet` (state, scenario state), its generator
    seeded with `seed`: (worst alert_overflow, (state, scenario state, last
    output, worst overflow, median ms per step, the detection kernel's
    launches))."""
    from tpu_collide_torch.sim import make_scenario_step
    step = make_scenario_step(cfg, *tables, backend="fused", device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    carry = list(fleet)

    def advance():
        carry[0], carry[1], out = step(carry[0], carry[1], gen)
        return out

    worst_of, worst_ao, out, ms, n_launch = timed_steps(advance, torch)
    return worst_ao, (carry[0], carry[1], out, worst_of, ms, n_launch)


def to_device(x, dev):
    """A dataclass of tensors (a state, a scenario state, a table) with
    every tensor moved to `dev`."""
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).to(dev)
                                     for f in dataclasses.fields(x)})


def device_profile(fn, n, torch) -> dict:
    """torch.profiler over n calls of fn, each followed by a synchronise:
    wall and device-busy ms per call, the idle share, the device launches
    per call (copies and fills not counted), and the five device kernels
    with the most busy time (ms and launches per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy, launches, by_name = 0.0, 0, {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy += us
            launches += not ev.name.startswith(("Memcpy", "Memset"))
            t, c = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (t + us, c + 1)
    if busy == 0.0:
        raise AssertionError("the profiler recorded no device time")
    busy_ms = busy / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(wall_ms=wall, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall, launches=launches / n,
                top=[dict(name=name[:80], ms=t / 1e3 / n, launches=c / n)
                     for name, (t, c) in top])


def scenario_phase(smi, torch, dev) -> dict:
    """The device scenario modes on the card (scenario_setup): a 100k road
    fleet in fast and in precise mode and a 100k destination fleet through
    make_scenario_step(backend="fused"), each certified by bench.py's rule
    (certified); the detection kernel against its plain version on the
    stepped road fleet in both modes; fused against reference-shaped alerts
    on a 20k road fleet stepped through both backends; scenario_integrate
    on the card against the CPU on the same draws; a profile of the road
    step. Emits one line per part; returns the detection kernel's launches
    in the phase by mode, and its largest slot error against the plain
    version by mode."""
    from tpu_collide_torch.engine import detect_and_alerts
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        slot_count)
    from tpu_collide_torch.sim import (build_city_table, build_road_table,
                                       make_scenario_step,
                                       scenario_integrate)
    from tpu_collide_torch.sim.scenario import scenario_draws
    cfg0, tmap = scenario_setup()
    roads, _ = build_road_table(tmap, device=dev)
    cities = build_city_table(tmap, device=dev)
    n = cfg0.num_objects
    road = road_fleet(cfg0, roads, 101, torch, dev)
    launches = {"hits": 0, "survivors": 0}
    err = {"hits": 0.0, "survivors": 0.0}
    mode_of = {"fast": "hits", "precise": "survivors"}

    # ---- the 100k fleets through the fused scenario step ----
    precise = cfg0.replace(detect=dataclasses.replace(cfg0.detect,
                                                      mode="precise"))
    cells = (("100k_2d_road", cfg0, road),
             ("100k_2d_road_precise", precise, road),
             ("100k_2d_dest", cfg0, dest_fleet(cfg0, 102, torch, dev)))
    stepped = {}
    for seed, (name, cfg, fleet) in enumerate(cells):
        t_part = time.perf_counter()
        mode = mode_of[cfg.detect.mode]
        tries = []

        def drive(c):
            res = scenario_steps(c, fleet, (roads, cities), 500 + seed,
                                 torch, dev)
            tries.append(dict(k=slot_count(c, mode),
                              survivor_cap=c.survivor_cap,
                              worst_alert_overflow=res[0]))
            return res

        cfg, worst_ao, res, attempts = certified(cfg, drive)
        state, scen, out, worst_of, ms, n_launch = res
        launches[mode] += n_launch
        check_output(out, cfg, torch)
        k = slot_count(cfg, mode)
        if worst_of != 0 or worst_ao != 0:
            raise AssertionError(
                f"{name}: overflow {worst_of}, alert_overflow {worst_ao} at "
                f"k {k}, survivor cap {cfg.survivor_cap}, after {attempts} "
                "attempts")
        if int(out.num_alive) != n:
            raise AssertionError(f"{name}: num_alive {int(out.num_alive)}")
        line = dict(
            phase="scenario", part=name, mode=mode, ms_per_step=ms,
            steps_timed=REPEATS, warmup_steps=2, kernel_launches=n_launch,
            kernel_launches_per_step=n_launch / (2 + REPEATS),
            attempts=attempts, tries=tries, k=k,
            max_alerts_per_object=cfg.alerts.max_alerts_per_object,
            survivor_k=cfg.detect.survivor_k, survivor_cap=cfg.survivor_cap,
            num_risks=int(out.num_risks), alerts=int(out.alerts.count),
            max_risk=float(out.max_risk), worst_overflow=worst_of,
            worst_alert_overflow=worst_ao)
        if fleet is road:
            # every object still on its road's line
            r = scen.road.long()
            rel = state.pos[:, :2] - roads.start[r]
            along = (rel * roads.dirn[r]).sum(dim=1, keepdim=True)
            off = float((rel - along * roads.dirn[r]).abs().max())
            if off > 1e-2:
                raise AssertionError(f"{name}: {off} m off the road line")
            line.update(off_road_m=off, road_switches=int(
                (scen.road != fleet[1].road).sum()))
        else:
            inside = ((state.pos[:, None, :2] - cities.center[None])
                      .norm(dim=2) < cities.radius[None]).any(dim=1)
            line.update(targets_set=int(scen.target_ok.sum()),
                        in_a_city=int(inside.sum()),
                        in_a_city_at_start=int(
                            ((fleet[0].pos[:, None, :2] - cities.center[None])
                             .norm(dim=2) < cities.radius[None])
                            .any(dim=1).sum()))
        line.update(seconds=time.perf_counter() - t_part, card=smi)
        stepped[name] = (cfg, state)
        emit(line)

    # ---- the kernel against its plain version on the stepped road fleet --
    for name in ("100k_2d_road", "100k_2d_road_precise"):
        cfg, state = stepped[name]
        mode = mode_of[cfg.detect.mode]
        cl = build_cell_list(state, cfg)
        k = slot_count(cfg, mode)
        got, want = fused_topk(cl, cfg, mode), fused_topk_plain(cl, cfg, mode)
        torch.cuda.synchronize()
        res = compare_slots(got, want, k, torch)
        err[mode] = max(err[mode], res["max_abs_err"])
        emit(dict(phase="scenario", part="kernel_vs_plain", fleet=name,
                  mode=mode, n=cl.n, k=k, **res,
                  largest_emitted=int(got.emitted.max()), **walk_edges(cl),
                  ms=median_ms(lambda: fused_topk(cl, cfg, mode), torch),
                  device_ms=graph_ms(lambda: fused_topk(cl, cfg, mode),
                                     torch),
                  plain_ms=median_ms(lambda: fused_topk_plain(cl, cfg, mode),
                                     torch, repeats=3),
                  kernel_bound=detect_bound(cl, cfg, mode, got, torch),
                  card=smi))

    # ---- fused against reference-shaped detection on a 20k road fleet ----
    cfg = stepped["100k_2d_road"][0].replace(num_objects=SCENARIO_SMALL)
    fleet = road_fleet(cfg, roads, 103, torch, dev)
    ends = {}
    fused_topk.launches = 0
    for backend in ("xla", "fused"):
        step = make_scenario_step(cfg, roads, cities, backend=backend,
                                  device=dev)
        gen = torch.Generator(device=dev).manual_seed(600)
        st, sc = fleet
        for _ in range(SCENARIO_SMALL_STEPS):
            st, sc, out = step(st, sc, gen)
        check_output(out, cfg, torch)
        ends[backend] = (st, sc, out)
    torch.cuda.synchronize()
    n_launch = fused_topk.launches
    launches["hits"] += n_launch
    if n_launch != SCENARIO_SMALL_STEPS:
        raise AssertionError(f"20k_2d_road: {n_launch} kernel launches in "
                             f"{SCENARIO_SMALL_STEPS} fused steps")
    (sx, cx, ox), (sf, cf, of) = ends["xla"], ends["fused"]
    if not states_equal(sx, sf, torch) or not all(
            torch.equal(getattr(cx, f.name), getattr(cf, f.name))
            for f in dataclasses.fields(cx)):
        raise AssertionError("20k_2d_road: the backends stepped to different "
                             "states")
    line = compare_paths("20k_2d_road", sf, cfg, detect_and_alerts, 1 << 18,
                         smi, torch)
    if not line["compared"]:
        raise AssertionError(f"20k_2d_road: not compared: {line}")
    certs = lambda o: dict(num_risks=int(o.num_risks),
                           overflow=int(o.overflow),
                           alert_overflow=int(o.alert_overflow))
    emit(dict(line, phase="scenario", part="fused_vs_xla",
              steps=SCENARIO_SMALL_STEPS, kernel_launches=n_launch,
              xla_step=certs(ox), fused_step=certs(of)))

    # ---- scenario_integrate on the card against the CPU ----
    # the road fleet with every tenth object moved to within 10 m of its
    # road's end, so that the road switch and the turn at the map's border
    # run inside the steps
    st, sc = road
    gen = torch.Generator(device=dev).manual_seed(700)
    r = sc.road[::10].long()
    back = torch.rand(r.shape, generator=gen, device=dev) * 9.5 + 0.5
    pos = st.pos.clone()
    pos[::10, :2] = roads.start[r] + (roads.length[r] - back)[:, None] \
        * roads.dirn[r]
    vel = st.vel.clone()
    vel[::10, :2] = 13.0 * roads.dirn[r]
    st = st.replace(pos=pos, vel=vel)
    cpu = torch.device("cpu")
    tables_cpu = (to_device(roads, cpu), to_device(cities, cpu))
    st_c, sc_c = to_device(st, cpu), to_device(sc, cpu)
    for _ in range(SCENARIO_CPU_STEPS):
        draws = scenario_draws(n, cities.radius.shape[0], cfg0, gen, dev)
        st, sc = scenario_integrate(st, sc, None, cfg0, roads, cities, draws)
        st_c, sc_c = scenario_integrate(st_c, sc_c, None, cfg0, *tables_cpu,
                                        [d.cpu() for d in draws])
    diff = float((st.pos.cpu() - st_c.pos).abs().max())
    same = {f: torch.equal(getattr(sc, f).cpu(), getattr(sc_c, f))
            for f in ("road", "mode", "target_ok")}
    if not all(same.values()) or diff > SCENARIO_CPU_TOL:
        raise AssertionError(f"card against CPU: discrete state equal "
                             f"{same}, positions {diff} m apart")
    emit(dict(phase="scenario", part="card_vs_cpu", fleet="100k_2d_road",
              steps=SCENARIO_CPU_STEPS, max_pos_diff_m=diff,
              pos_bit_equal=torch.equal(st.pos.cpu(), st_c.pos),
              max_vel_diff=float((st.vel.cpu() - st_c.vel).abs().max()),
              max_heading_diff=float((st.heading.cpu() - st_c.heading)
                                     .abs().max()),
              discrete_equal=same,
              road_switches=int((sc.road != road[1].road).sum()),
              near_end=int(r.numel()), card=smi))

    # ---- profile of the road step, and of its physics alone ----
    cfg = stepped["100k_2d_road"][0]
    step = make_scenario_step(cfg, roads, cities, backend="fused",
                              device=dev)
    gen = torch.Generator(device=dev).manual_seed(800)
    carry = list(road)

    def one_step():
        carry[0], carry[1], _ = step(carry[0], carry[1], gen)

    for _ in range(2):
        one_step()
    whole = device_profile(one_step, SCENARIO_PROFILE_STEPS, torch)
    physics = device_profile(
        lambda: scenario_integrate(carry[0], carry[1], gen, cfg, roads,
                                   cities), SCENARIO_PROFILE_STEPS, torch)
    emit(dict(phase="scenario", part="profile", config="100k_2d_road",
              calls=SCENARIO_PROFILE_STEPS, step=whole,
              scenario_integrate=physics,
              integrate_launch_share=physics["launches"] / whole["launches"],
              card=smi))
    return dict(launches=launches, max_abs_err=err)


# ---- the sharded step ------------------------------------------------------

# the sharded phase's fused steps: warm-ups, then steps timed with CUDA
# events; the three steps of (f) are timed in SHARDED_ROUNDS turns of
# SHARDED_TURN steps each
SHARDED_WARMUP, SHARDED_STEPS = 2, 5
SHARDED_ROUNDS, SHARDED_TURN = 3, 3
# (d): the scenario phase's 20k road fleet at the k adopted for its 100k
# road fleet (16); (e): the 3D mesh of tests/test_mesh3d.py:27-37 at 5,000
# objects, 1,000 updates
SHARDED_ROAD_STEPS, SHARDED_ROAD_K = 3, 16
SHARDED_3D_N, SHARDED_3D_STEPS, SHARDED_INGEST = 5_000, 3, 1_000


def sharded_config(det_mode="fast", shards=(8, 2)):
    """tools/big_mesh_dryrun.py:95-115's deployment at bench.py's 100k
    size: the 10 km 2D world, 100 m cells of capacity 64, k 8,
    count_checked off, 32768 alerts per shard, deterministic physics, a
    shards[0] x shards[1] grid with a halo of 1024 and migration buffers
    of 256."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import (AlertConfig, DetectionConfig,
                                               GridConfig, ShardConfig,
                                               SimConfig, WorldConfig)
    return tt.SystemConfig(
        num_objects=100_000, world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode=det_mode, count_checked=False),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=32768, max_alerts_per_object=8),
        shard=ShardConfig(num_shards=shards[0], num_shards_y=shards[1],
                          halo_capacity=1024, migrate_capacity=256))


def single_shard(cfg, budget):
    """cfg on one device: one shard, a scene budget of `budget`."""
    from tpu_collide_torch.core.config import ShardConfig
    return cfg.replace(shard=ShardConfig(), alerts=dataclasses.replace(
        cfg.alerts, max_scene_alerts=budget))


def conserved(name, states, n, torch):
    """The collected states, after checking that every oid 0 .. n-1 is
    alive in exactly one slot."""
    from tpu_collide_torch.shard import collect_state
    host = collect_state(states)
    oids = host.oid[host.alive].long()
    if oids.numel() != n or bool((torch.bincount(oids, minlength=n)
                                  != 1).any()):
        raise AssertionError(f"{name}: {oids.numel()} alive objects, not "
                             f"each of the {n} oids once")
    return host


def by_oid(state, torch):
    """Row of each oid among the alive rows of `state` ([max oid + 1])."""
    alive = torch.nonzero(state.alive).flatten()
    oids = state.oid[alive].long()
    inv = torch.full((int(oids.max()) + 1,), -1, dtype=torch.int64,
                     device=oids.device)
    inv[oids] = alive
    return inv


def sharded_steps(cfg, fleet, torch, dev):
    """SHARDED_WARMUP + SHARDED_STEPS fused sharded steps of `fleet` on
    cfg's mesh, the last SHARDED_STEPS timed with CUDA events: (worst
    alert_overflow, (states, last output, worst overflow, median ms per
    step, the detection kernel's launches, dropped over all steps, the
    least num_alive, the mesh)). Fails unless every step launched the
    kernel once per shard."""
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    from tpu_collide_torch.shard import (distribute_state, make_mesh,
                                         make_sharded_step,
                                         shard_generators)
    mesh = make_mesh(cfg, device=dev)
    states = distribute_state(fleet, cfg, mesh)
    step = make_sharded_step(cfg, mesh, backend="fused")
    gens = shard_generators(mesh, 1)
    worst_of = worst_ao = dropped = alive = None
    events = []
    fused_topk.launches = 0
    for i in range(SHARDED_WARMUP + SHARDED_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        states, out, drop = step(states, gens)
        b.record()
        if i >= SHARDED_WARMUP:
            events.append((a, b))
        worst_of = out.overflow if worst_of is None \
            else torch.maximum(worst_of, out.overflow)
        worst_ao = out.alert_overflow if worst_ao is None \
            else torch.maximum(worst_ao, out.alert_overflow)
        dropped = drop.sum() if dropped is None else dropped + drop.sum()
        alive = out.num_alive if alive is None \
            else torch.minimum(alive, out.num_alive)
    torch.cuda.synchronize()
    n_launch = fused_topk.launches
    if n_launch != (SHARDED_WARMUP + SHARDED_STEPS) * mesh.size:
        raise AssertionError(f"{n_launch} kernel launches in "
                             f"{SHARDED_WARMUP + SHARDED_STEPS} steps of "
                             f"{mesh.size} shards")
    ms = statistics.median(a.elapsed_time(b) for a, b in events)
    return int(worst_ao), (states, out, int(worst_of), ms, n_launch,
                           int(dropped), int(alive), mesh)


def sharded_vs_single(name, cfg, fleet, smi, torch, dev) -> dict:
    """One sharded fused step of `fleet` against one single-device fused
    step of it (make_step(backend="fused"), a scene budget of 2^20 so that
    it cannot bind): equal positions by oid, equal num_risks, equal
    unordered alert sets (values within ALERT_TOL, priority exact), every
    certificate 0; a pair in one set only is reported with the threshold
    it sits nearest (flip_margins) and allowed within FLIP_MARGIN of it."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.shard import (collect_state, distribute_state,
                                         make_mesh, make_sharded_step,
                                         shard_generators)
    mesh = make_mesh(cfg, device=dev)
    step = make_sharded_step(cfg, mesh, backend="fused")
    states, so, drop = step(distribute_state(fleet, cfg, mesh),
                            shard_generators(mesh, 2))
    # the reference's scene budget, survivor cap and hot top-up as large as
    # the 16 shards' together (none changes a value, only what is kept)
    ref = single_shard(cfg, 1 << 20)
    ref = ref.replace(detect=dataclasses.replace(
        ref.detect, precise_survivor_cap=4 * cfg.num_objects,
        hot_topup=cfg.detect.hot_topup * cfg.shard.total_shards))
    st1, o1 = tt.make_step(ref, backend="fused", device=dev)(
        fleet, torch.Generator(device=dev).manual_seed(2))
    host = collect_state(states)
    rows = by_oid(host, torch)[st1.oid.long()]
    pos_diff = float((host.pos[rows] - st1.pos).abs().max())
    certs = dict(sharded_overflow=int(so.overflow),
                 sharded_alert_overflow=int(so.alert_overflow),
                 single_overflow=int(o1.overflow),
                 single_alert_overflow=int(o1.alert_overflow),
                 dropped=int(drop.sum()))
    per_shard = so.alerts.count
    if any(certs.values()) or int(per_shard.max()) >= \
            cfg.alerts.max_scene_alerts or int(o1.alerts.count) >= (1 << 20):
        raise AssertionError(f"{name}: not comparable: {certs}, per-shard "
                             f"alerts up to {int(per_shard.max())}")
    sm, fm = unordered(so.alerts), unordered(o1.alerts)
    inv = by_oid(st1, torch).cpu()
    flips = []
    for pair in sorted(set(sm) ^ set(fm)):
        risk = (sm.get(pair) or fm.get(pair))[0]
        m = flip_margins(st1, ref, int(inv[pair[0]]), int(inv[pair[1]]),
                         risk)
        near = min(m, key=lambda t: abs(m[t]))
        flips.append(dict(pair=pair, only_in="sharded" if pair in sm
                          else "single", threshold=near, margin=m[near]))
    far = [f for f in flips if abs(f["margin"]) > FLIP_MARGIN]
    common = set(sm) & set(fm)
    d = max((abs(x - y) for key in common
             for x, y in zip(sm[key][:4], fm[key][:4])), default=0.0)
    line = dict(phase="sharded", part="vs_single_device", config=name,
                k=cfg.alerts.max_alerts_per_object,
                survivor_k=cfg.detect.survivor_k, **certs,
                num_risks_sharded=int(so.num_risks),
                num_risks_single=int(o1.num_risks), pairs=len(common),
                alerts_per_shard_max=int(per_shard.max()), flips=flips,
                max_abs_diff=d, max_pos_diff=pos_diff, card=smi)
    if far or not common or pos_diff != 0.0 or d > ALERT_TOL \
            or any(sm[key][4] != fm[key][4] for key in common) \
            or abs(line["num_risks_sharded"] - line["num_risks_single"]) \
            > 2 * len(flips):
        raise AssertionError(f"{name}: sharded and single-device steps "
                             f"differ: {line}")
    return line


def sharded_phase(smi, torch, dev) -> dict:
    """The sharded step on the card (tools/big_mesh_dryrun.py's deployment
    at 100k, 16 shards on the one card): (a) the fused sharded step in fast
    and precise mode, certified by bench.py's rule, conservation on every
    step; (b) one step against the single-device fused step; (c) the
    detection kernel against its plain version on one shard's cell list
    of owned rows and marked halo mirrors, both modes; (d) the sharded
    scenario step on the scenario phase's 20k road fleet on a 4x2 grid
    against the single-device scenario step; (e) a 2x2x2 mesh in a 3D world:
    steps, make_sharded_ingest and make_sharded_detect; (f) ms/step of the
    16-shard step, a one-shard mesh and the single-device step in turns,
    and a torch.profiler pass. Emits one line per part; returns the
    detection kernel's launches on the sharded path by mode, its largest
    slot error against the plain version by mode, and its times on the
    halo-extended cell list."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import (AlertConfig, GridConfig,
                                               ShardConfig, SimConfig,
                                               WorldConfig)
    from tpu_collide_torch.engine import detect_and_alerts
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        slot_count)
    from tpu_collide_torch.shard import (collect_state, distribute_state,
                                         make_mesh, make_sharded_detect,
                                         make_sharded_ingest,
                                         make_sharded_scenario_step,
                                         make_sharded_step, shard_generators,
                                         shard_slots)
    from tpu_collide_torch.shard.step import _default_walls, _halo_extend
    from tpu_collide_torch.sim import (ScenarioState, build_city_table,
                                       build_road_table, generate_fleet,
                                       make_scenario_step)
    mode_of = {"fast": "hits", "precise": "survivors"}
    launches = {"hits": 0, "survivors": 0}
    err = {"hits": 0.0, "survivors": 0.0}
    kernel = {}
    cfg0 = sharded_config()
    n = cfg0.num_objects
    fleet = generate_fleet(torch.Generator(device=dev).manual_seed(0), cfg0,
                           "uniform")
    adopted = {}

    # ---- (a) the 16-shard fused step, certified, and (c) its kernel ----
    for det_mode, mode in mode_of.items():
        t_part = time.perf_counter()
        tries = []

        def drive(c):
            res = sharded_steps(c, fleet, torch, dev)
            tries.append(dict(k=slot_count(c, mode),
                              survivor_cap=c.survivor_cap,
                              worst_alert_overflow=res[0]))
            return res

        cfg, worst_ao, res, attempts = certified(sharded_config(det_mode),
                                                 drive)
        states, out, worst_of, ms, n_launch, dropped, alive, mesh = res
        launches[mode] += n_launch
        check_output(out, cfg, torch)
        if worst_of or worst_ao or dropped or alive != n:
            raise AssertionError(
                f"sharded {det_mode}: overflow {worst_of}, alert_overflow "
                f"{worst_ao}, dropped {dropped}, least num_alive {alive} "
                f"after {attempts} attempts")
        conserved(f"sharded {det_mode}", states, n, torch)
        adopted[det_mode] = cfg
        emit(dict(phase="sharded", part="step", mode=mode,
                  shards=list(mesh.shape), slots=shard_slots(cfg),
                  ms_per_step=ms, steps_timed=SHARDED_STEPS,
                  warmup_steps=SHARDED_WARMUP, kernel_launches=n_launch,
                  kernel_launches_per_step=n_launch
                  / (SHARDED_WARMUP + SHARDED_STEPS),
                  attempts=attempts, tries=tries, k=slot_count(cfg, mode),
                  survivor_cap=cfg.survivor_cap, num_risks=int(out.num_risks),
                  alerts=int(out.alerts.count.sum()),
                  alerts_per_shard_max=int(out.alerts.count.max()),
                  max_risk=float(out.max_risk), worst_overflow=worst_of,
                  worst_alert_overflow=worst_ao, dropped=dropped,
                  num_alive=alive, seconds=time.perf_counter() - t_part,
                  card=smi))

        # (c) the kernel on the shard with the most halo mirrors
        ext, _ = _halo_extend(states, cfg, mesh, _default_walls(cfg, mesh),
                              mark=True)
        lists = [build_cell_list(e, cfg) for e in ext]
        mirrors = [int((cl.alive & ~cl.own).sum()) for cl in lists]
        s = max(range(len(lists)), key=lambda i: mirrors[i])
        cl = lists[s]
        k = slot_count(cfg, mode)
        got, want = fused_topk(cl, cfg, mode), fused_topk_plain(cl, cfg,
                                                               mode)
        torch.cuda.synchronize()
        res = compare_slots(got, want, k, torch)
        err[mode] = max(err[mode], res["max_abs_err"])
        b = detect_bound(cl, cfg, mode, got, torch)
        kernel[mode] = dict(
            ms=median_ms(lambda: fused_topk(cl, cfg, mode), torch),
            device_ms=graph_ms(lambda: fused_topk(cl, cfg, mode), torch),
            plain_ms=median_ms(lambda: fused_topk_plain(cl, cfg, mode),
                               torch, repeats=3),
            bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        emit(dict(phase="sharded", part="kernel_vs_plain", mode=mode,
                  shard=list(mesh.coords(s)), n=cl.n,
                  owned=int(cl.own.sum()), mirrors=mirrors[s], k=k, **res,
                  ms=kernel[mode]["ms"], device_ms=kernel[mode]["device_ms"],
                  plain_ms=kernel[mode]["plain_ms"], kernel_bound=b,
                  card=smi))

    # ---- (b) against the single-device fused step ----
    for det_mode, cfg in adopted.items():
        t_part = time.perf_counter()
        line = sharded_vs_single(f"100k_2d_{det_mode}_8x2", cfg, fleet, smi,
                                 torch, dev)
        emit(dict(line, seconds=time.perf_counter() - t_part))

    # ---- (d) the sharded scenario step, the 20k road fleet, 4x2 ----
    base, tmap = scenario_setup()
    roads, _ = build_road_table(tmap, device=dev)
    cities = build_city_table(tmap, device=dev)
    cfg = base.replace(
        num_objects=SCENARIO_SMALL, sim=SimConfig(accel_change_prob=0.0),
        alerts=dataclasses.replace(base.alerts, max_scene_alerts=1 << 16,
                                   max_alerts_per_object=SHARDED_ROAD_K),
        shard=ShardConfig(num_shards=4, num_shards_y=2, halo_capacity=1024,
                          migrate_capacity=256))
    fleet_r, scen0 = road_fleet(cfg, roads, 103, torch, dev)
    mesh = make_mesh(cfg, device=dev)
    names = [f.name for f in dataclasses.fields(ScenarioState)]
    states, extras = distribute_state(fleet_r, cfg, mesh, extra={
        f: getattr(scen0, f) for f in names})
    scens = tuple(ScenarioState(**x) for x in extras)
    step = make_sharded_scenario_step(cfg, mesh, roads, cities,
                                      backend="fused")
    one = make_scenario_step(single_shard(cfg, 1 << 16), roads, cities,
                             backend="fused", device=dev)
    gens = shard_generators(mesh, 3)
    g1 = torch.Generator(device=dev).manual_seed(3)
    st1, sc1 = fleet_r, scen0
    fused_topk.launches = 0
    for _ in range(SHARDED_ROAD_STEPS):
        states, scens, out, drop = step(states, scens, gens)
        if int(out.num_alive) != SCENARIO_SMALL or int(drop.sum()):
            raise AssertionError(f"sharded road: num_alive "
                                 f"{int(out.num_alive)}, dropped "
                                 f"{int(drop.sum())}")
    torch.cuda.synchronize()
    n_road = fused_topk.launches
    launches["hits"] += n_road
    for _ in range(SHARDED_ROAD_STEPS):
        st1, sc1, o1 = one(st1, sc1, g1)
    host = conserved("sharded road", states, SCENARIO_SMALL, torch)
    hsc = collect_state(scens)
    rows = by_oid(host, torch)[st1.oid.long()]
    same_road = bool(torch.equal(hsc.road[rows], sc1.road)
                     and torch.equal(hsc.road[rows], scen0.road))
    same_mode = bool(torch.equal(hsc.mode[rows], scen0.mode))
    pos_diff = float((host.pos[rows] - st1.pos).abs().max())
    walls_x = torch.tensor([2500.0, 5000.0, 7500.0], device=dev)
    on_walls = int((fleet_r.pos[:, 0:1] == walls_x).any(dim=1).sum())
    pairs_equal = set(unordered(out.alerts)) == set(unordered(o1.alerts))
    line = dict(phase="sharded", part="scenario_road", fleet="20k_2d_road",
                shards=[4, 2], steps=SHARDED_ROAD_STEPS, k=SHARDED_ROAD_K,
                kernel_launches=n_road, num_risks=int(out.num_risks),
                num_risks_single=int(o1.num_risks),
                alert_overflow=int(out.alert_overflow),
                alert_overflow_single=int(o1.alert_overflow),
                pairs=len(unordered(out.alerts)), pairs_equal=pairs_equal,
                road_kept=same_road, mode_kept=same_mode,
                max_pos_diff=pos_diff, objects_on_x_walls=on_walls,
                migrated=int((host.oid != collect_state(distribute_state(
                    fleet_r, cfg, mesh)).oid).sum()), card=smi)
    emit(line)
    if n_road != SHARDED_ROAD_STEPS * mesh.size or not (
            same_road and same_mode and pairs_equal and pos_diff == 0.0
            and line["num_risks"] == line["num_risks_single"]
            and line["alert_overflow"] == 0 and line["migrated"] > 0):
        raise AssertionError(f"sharded road: {line}")

    # ---- (e) a 2x2x2 mesh in a 3D world: steps, ingest, detect ----
    cfg = tt.SystemConfig(
        num_objects=SHARDED_3D_N, world=WorldConfig(hi=(4000.0, 4000.0,
                                                        800.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=2, num_shards_y=2, num_shards_z=2,
                          slot_headroom=2.0))
    gen = torch.Generator(device=dev).manual_seed(4)
    fleet3 = generate_fleet(gen, cfg, "uniform")
    mesh = make_mesh(cfg, device=dev)
    step = make_sharded_step(cfg, mesh, backend="fused")
    states, gens = distribute_state(fleet3, cfg, mesh), \
        shard_generators(mesh, 4)
    fused_topk.launches = 0
    drops = 0
    for _ in range(SHARDED_3D_STEPS):
        states, out, drop = step(states, gens)
        drops += int(drop.sum())
    torch.cuda.synchronize()
    n_3d = fused_topk.launches
    launches[mode_of[cfg.detect.mode]] += n_3d
    conserved("sharded 3d", states, SHARDED_3D_N, torch)
    # 1,000 updates: half move existing objects anywhere, half are new
    b = SHARDED_INGEST
    new_pos = torch.rand((b, 3), generator=gen, device=dev) \
        * torch.tensor(cfg.world.hi, device=dev)
    oid = torch.cat([torch.arange(b // 2, device=dev),
                     SHARDED_3D_N + torch.arange(b - b // 2, device=dev)])
    upd = dict(oid=oid.to(torch.int32), pos=new_pos,
               vel=torch.randn((b, 3), generator=gen, device=dev) * 5.0,
               acc=torch.zeros((b, 3), device=dev),
               heading=torch.zeros(b, device=dev),
               size=torch.full((b,), 2.0, device=dev),
               otype=torch.zeros(b, dtype=torch.int32, device=dev))
    states, drop_i = make_sharded_ingest(cfg, mesh)(
        states, {f: v.cpu().numpy() for f, v in upd.items()})
    host = conserved("sharded ingest", states, SHARDED_3D_N + b - b // 2,
                     torch)
    rows = by_oid(host, torch)[oid.long()]
    placed = bool(torch.equal(host.pos[rows], new_pos))
    det, drop_d = make_sharded_detect(cfg, mesh)(states)
    ref = detect_and_alerts(host, single_shard(cfg, 1 << 16))
    line = dict(phase="sharded", part="mesh3d", shards=[2, 2, 2],
                n=SHARDED_3D_N, steps=SHARDED_3D_STEPS, kernel_launches=n_3d,
                dropped=drops, num_alive=int(out.num_alive),
                num_risks=int(out.num_risks),
                alert_overflow=int(out.alert_overflow),
                ingest_updates=b, ingest_dropped=int(drop_i.sum()),
                updates_placed=placed,
                detect_num_risks=int(det.num_risks),
                detect_num_risks_single=int(ref.num_risks),
                detect_pairs=len(unordered(det.alerts)),
                detect_pairs_equal=set(unordered(det.alerts))
                == set(unordered(ref.alerts)),
                detect_dropped=int(drop_d.sum()),
                detect_overflow=int(det.overflow), card=smi)
    emit(line)
    if n_3d != SHARDED_3D_STEPS * mesh.size or drops or not placed \
            or line["ingest_dropped"] or line["detect_dropped"] \
            or line["num_alive"] != SHARDED_3D_N \
            or not line["detect_pairs_equal"] \
            or line["detect_num_risks"] != line["detect_num_risks_single"] \
            or int(det.alerts.count.max()) >= cfg.alerts.max_scene_alerts:
        raise AssertionError(f"sharded 3d: {line}")

    # ---- (f) ms/step in turns, and a profile ----
    cfg = adopted["fast"]
    variants = {}
    for name, c in (("16_shards", cfg),
                    ("1_shard", cfg.replace(shard=ShardConfig(
                        halo_capacity=1024, migrate_capacity=256)))):
        mesh = make_mesh(c, device=dev)
        fn = make_sharded_step(c, mesh, backend="fused")
        variants[name] = [fn, distribute_state(fleet, c, mesh),
                          shard_generators(mesh, 5)]
    single = tt.make_step(single_shard(cfg, cfg.alerts.max_scene_alerts),
                          backend="fused", device=dev)
    variants["single_device"] = [
        lambda st, g: single(st, g) + (None,), fleet,
        torch.Generator(device=dev).manual_seed(5)]

    def advance(v):
        v[1], _, _ = v[0](v[1], v[2])

    times = {name: [] for name in variants}
    for r in range(SHARDED_ROUNDS):
        for name, v in variants.items():
            if r == 0:
                advance(v)
            events = []
            for _ in range(SHARDED_TURN):
                a = torch.cuda.Event(enable_timing=True)
                b_ = torch.cuda.Event(enable_timing=True)
                a.record()
                advance(v)
                b_.record()
                events.append((a, b_))
            torch.cuda.synchronize()
            times[name].append(statistics.median(
                a.elapsed_time(b_) for a, b_ in events))
    profiles = {name: device_profile(lambda v=v: advance(v),
                                     SCENARIO_PROFILE_STEPS, torch)
                for name, v in variants.items() if name != "1_shard"}
    emit(dict(phase="sharded", part="timing", config="100k_2d_fast",
              k=cfg.alerts.max_alerts_per_object, rounds=SHARDED_ROUNDS,
              steps_per_turn=SHARDED_TURN, ms_per_step=times,
              median_ms_per_step={k: statistics.median(v)
                                  for k, v in times.items()},
              profile=profiles, card=smi))
    return dict(launches=launches, max_abs_err=err, kernel=kernel,
                adopted=adopted)


# ---- sharded serving: balance, sharded prediction, ShardedScene ------------

# bench.py:400-450's prediction settings (horizon 10 s at 0.5 s, merge_k 32,
# a 1 s sub-window); the predict calls timed with CUDA events; the reduced
# fleet of the xla backend's call; the ShardedScene's calls of each kind;
# the reports posted to the sharded node and its POST /step requests
SERVING_HORIZON, SERVING_STEP = 10.0, 0.5
SERVING_PREDICTS, SERVING_XLA_N = 3, 20_000
SERVING_STEPS, SERVING_BURST, SERVING_SCENE_PREDICTS = 5, 4, 3
SERVING_REPORTS, SERVING_HTTP_STEPS = 100, 5


def launch_counts() -> tuple:
    """(detection, predict) kernel launches counted so far."""
    from tpu_collide_torch.kernels.fused_detect import fused_topk, predict_topk
    return fused_topk.launches, predict_topk.launches


def history_steps(cfg, mesh, states, walls, n, torch):
    """n fused sharded steps with the trajectory rings (distribute_history
    of an empty global history, then one record after each step, as
    ShardedScene.record_trajectories does): (states, histories, worst
    overflow, worst alert_overflow, dropped, the least num_alive)."""
    from tpu_collide_torch.detect.predict import (empty_history,
                                                  update_history)
    from tpu_collide_torch.shard import (collect_state, distribute_history,
                                         make_sharded_step, shard_generators)
    host = collect_state(states)
    hists = distribute_history(empty_history(host.n, device=host.device),
                               cfg, mesh, host, *walls)
    step = make_sharded_step(cfg, mesh, backend="fused", with_history=True)
    gens = shard_generators(mesh, 6)
    worst = [0, 0, 0, cfg.num_objects]
    for i in range(n):
        states, hists, out, drop = step(states, hists, gens, *walls)
        hists = tuple(update_history(h, st, (i + 1) * cfg.sim.dt)
                      for h, st in zip(hists, states))
        worst = [max(worst[0], int(out.overflow)),
                 max(worst[1], int(out.alert_overflow)),
                 worst[2] + int(drop.sum()),
                 min(worst[3], int(out.num_alive))]
    return (states, hists, *worst)


def single_device_alert_overflow(cfg, fleet, n, torch, dev) -> int:
    """The worst alert_overflow of n single-device fused steps of `fleet`
    (make_step(cfg, backend="fused")). Its launches are a comparison's and
    stay out of the path's count."""
    import tpu_collide_torch as tt
    step = tt.make_step(cfg, backend="fused", device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    worst = 0
    for _ in range(n):
        fleet, out = step(fleet, gen)
        worst = max(worst, int(out.alert_overflow))
    return worst


def predicted_pairs(rows, row_oid, torch) -> dict:
    """{(own oid, other oid): (risk, ttc, dist)} of the valid entries of
    merged predict rows (other, valid, risk, ttc, dist) whose row i is
    object row_oid[i]."""
    other, valid, risk, ttc, dist = rows
    i, j = torch.nonzero(valid, as_tuple=True)
    cols = to_host_lists([row_oid[i], other[i, j], risk[i, j], ttc[i, j],
                          dist[i, j]])
    return {(a, b): (r, t, d) for a, b, r, t, d in zip(*cols)}


def to_host_lists(tensors) -> list:
    from tpu_collide_torch.core.device import to_host
    return [a.tolist() for a in to_host(tensors)]


def pair_diff(got, want) -> dict:
    """How two predicted pair maps differ: pairs in one only (with their
    values, the first 10) and the largest value difference on the common
    pairs."""
    common = set(got) & set(want)
    d = max((abs(x - y) for k in common for x, y in zip(got[k], want[k])
             if x != y), default=0.0)
    only = lambda a, b: [dict(pair=k, values=a[k])
                         for k in sorted(set(a) - set(b))[:10]]
    return dict(pairs=len(want), common=len(common),
                only_sharded=len(set(got) - set(want)),
                only_single=len(set(want) - set(got)),
                max_abs_diff=d, first_only_sharded=only(got, want),
                first_only_single=only(want, got))


def sharded_vs_single_predict(name, cfg, mesh, states, hists, walls, hops,
                              halo_capacity, smi, torch) -> dict:
    """make_sharded_predict(backend="fused") on the mesh, SERVING_PREDICTS
    calls timed with CUDA events after a warm-up, against the
    single-device fused_predict (k_slots 8) on the collected fleet in oid
    order (oid == row, as fused_predict's scatter assumes), joined on
    row_oid. Equal pair sets and values within ORACLE_TOL are required
    where both sides certify (overflow, slot_oflow and dropped 0);
    otherwise the counters and the differing pairs are reported."""
    from tpu_collide_torch.kernels.refine import fused_predict
    from tpu_collide_torch.shard import collect_state, make_sharded_predict
    pfn = make_sharded_predict(cfg, mesh, horizon=SERVING_HORIZON,
                               step=SERVING_STEP, backend="fused",
                               hops=hops, halo_capacity=halo_capacity)
    run = lambda: pfn(states, hists, *walls)
    d_start, p_start = launch_counts()
    run()
    d0, p0 = launch_counts()
    events, res = [], None
    for _ in range(SERVING_PREDICTS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = run()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    d1, p1 = launch_counts()
    ms = [a.elapsed_time(b) for a, b in events]
    cat = lambda parts: torch.cat(list(parts))
    got = predicted_pairs([cat(c) for c in res[:5]], cat(res[5]), torch)
    dropped, oflow = int(res[6].sum()), int(res[7].sum())
    # the single-device reference, on the fleet in oid order
    host, hh = collect_state(states), collect_state(hists)
    alive = torch.nonzero(host.alive).flatten()
    rows = alive[torch.argsort(host.oid[alive])]
    fleet = host.replace(**{f: getattr(host, f)[rows]
                            for f in ("pos", "vel", "acc", "heading", "size",
                                      "otype", "alive", "oid")})
    hist = type(hh)(**{f: getattr(hh, f)[rows]
                       for f in ("pos", "t", "count", "head")})
    if not bool((fleet.oid == torch.arange(
            fleet.n, dtype=torch.int32, device=fleet.oid.device)).all()):
        raise AssertionError(f"{name}: the fleet's oids are not 0 .. n-1")
    ref = fused_predict(fleet, hist, cfg, horizon=SERVING_HORIZON,
                        step=SERVING_STEP, k_slots=8)
    want = predicted_pairs(ref[:5], fleet.oid, torch)
    single = dict(overflow=int(ref[5]), slot_oflow=int(ref[6]),
                  slot_trunc=int(ref[7]))
    diff = pair_diff(got, want)
    both_certify = dropped == oflow == single["overflow"] \
        == single["slot_oflow"] == 0
    line = dict(fleet=name, hops=hops, halo_capacity=halo_capacity,
                ms=ms, median_ms=statistics.median(ms),
                predict_launches=p1 - p_start,
                predict_launches_per_call=(p1 - p0) / SERVING_PREDICTS,
                detection_launches=d1 - d_start, shards=mesh.size,
                sharded=dict(dropped=dropped, overflow_plus_slot_oflow=oflow,
                             risks=len(got)),
                single=single, both_certify=both_certify,
                equal=diff["only_sharded"] == diff["only_single"] == 0
                and diff["max_abs_diff"] <= ORACLE_TOL, **diff)
    if p1 - p0 != SERVING_PREDICTS * mesh.size or d1 != d_start:
        raise AssertionError(f"{name}: {p1 - p0} predict launches in "
                             f"{SERVING_PREDICTS} calls on {mesh.size} "
                             f"shards")
    if both_certify and not line["equal"]:
        raise AssertionError(f"{name}: sharded and single-device "
                             f"predictions differ: {line}")
    return line, run


def predict_kernel_on_shard(cfg, mesh, states, hists, smi, torch) -> dict:
    """The predict kernel against its plain version on the cell list that
    make_sharded_predict(backend="fused") builds for the shard with the
    most halo mirrors (owned rows, marked mirrors of class 0, the band
    predict_reach wide), all offsets at k 8, bit for bit. The launches made
    here are left out of the path's count. Returns the line's numbers."""
    from tpu_collide_torch.detect.predict import (classify_trajectories,
                                                  predict_offsets,
                                                  sub_window_config)
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (predict_topk,
                                                        predict_topk_plain)
    from tpu_collide_torch.shard import predict_band
    from tpu_collide_torch.shard.step import _default_walls, _halo_extend
    before = predict_topk.launches
    reach, hops, cap = predict_band(cfg, SERVING_HORIZON, SERVING_STEP)
    ext, _ = _halo_extend(states, cfg, mesh, _default_walls(cfg, mesh),
                          True, width=reach, capacity=cap, hops=hops)
    mirrors = [int((e.alive & (e.oid < 0)).sum()) for e in ext]
    s = max(range(len(ext)), key=lambda i: mirrors[i])
    cls = torch.cat([classify_trajectories(hists[s]),
                     torch.zeros(ext[s].n - states[s].n, dtype=torch.int32,
                                 device=ext[s].device)])
    cl = build_cell_list(ext[s], cfg, cls=cls)
    offs = torch.tensor(predict_offsets(SERVING_HORIZON, SERVING_STEP),
                        dtype=torch.float32, device=cl.fields.device)
    sub = sub_window_config(cfg.detect, 1.0).num_time_steps
    pk = lambda: predict_topk(cl, cfg, offs, 8, sub)
    pp = lambda: predict_topk_plain(cl, cfg, offs, 8, sub)
    got, want = pk(), pp()
    torch.cuda.synchronize()
    res = compare_pred_slots(got, want, 8, torch)
    if not res["bit_equal"]:
        raise AssertionError("predict kernel on a halo-extended shard: not "
                             "bit-equal to its plain version")
    line = dict(shard=list(mesh.coords(s)), rows=cl.n,
                owned=int(cl.own.sum()), mirrors=mirrors[s],
                offsets=offs.numel(), k=8, sub_steps=sub, **res,
                ms=median_ms(pk, torch), device_ms=graph_ms(pk, torch),
                plain_ms=median_ms(pp, torch, repeats=3),
                kernel_bound=predict_bound(cl, cfg, offs, got, sub, torch))
    predict_topk.launches = before
    return line


def sharded_serving_phase(smi, torch, dev, adopted) -> dict:
    """Balance, sharded prediction and ShardedScene on the card, at
    sharded_config()'s 100k deployment on 8x2 shards: (a) LoadBalancer on
    a city-skew fleet (rebalance, conservation, 3 fused steps at the
    deployment's halo under the equal and the new walls, 3 under the new
    walls at a shard-sized halo with every object kept in the bands); (b) make_sharded_predict(backend="fused") at 100k against
    the single-device fused_predict, the xla backend at SERVING_XLA_N
    against the fused one, and the rebalanced city-skew fleet with hops
    for its narrowest slab; (c) ShardedScene: step, step_pipelined,
    step_burst, detect, record_trajectories and predict, precise mode at
    the sharded phase's adopted survivor_k / cap, checkpoints; (d) the
    sharded service node over HTTP and `python -m tpu_collide_torch.system
    --shards 4 --shards-y 2`. Emits one line per part; returns the kernels'
    launches on the path by mode."""
    import shutil
    import tempfile
    import numpy as np
    from tpu_collide_torch.api import ShardedScene
    from tpu_collide_torch.kernels.fused_detect import fused_topk, predict_topk
    from tpu_collide_torch.shard import (LoadBalancer, collect_state,
                                         distribute_state,
                                         imbalance, make_mesh,
                                         make_sharded_predict, predict_hops,
                                         predict_reach, shard_occupancy,
                                         shard_slots)
    from tpu_collide_torch.shard.step import _shard_of
    from tpu_collide_torch.sim import generate_fleet
    launches = {"hits": 0, "survivors": 0, "predict": 0}
    fused_topk.launches = predict_topk.launches = 0
    cfg_f, cfg_p = adopted["fast"], adopted["precise"]
    n = cfg_f.num_objects
    sh = cfg_f.shard
    d = sh.total_shards

    # ---- (a) balance: the city-skew fleet on 8x2 ----
    t_part = time.perf_counter()
    skew = generate_fleet(torch.Generator(device=dev).manual_seed(5), cfg_f,
                          "city_skew")
    occ_equal = np.bincount(_shard_of(skew.pos.cpu().numpy(), cfg_f),
                            minlength=d)
    # the least headroom (in steps of 0.25) whose slots hold the busiest
    # equal slab
    headroom = float(np.ceil(occ_equal.max() / (n / d) * 4.0) / 4.0) + 0.25
    cfg_s = cfg_f.replace(shard=dataclasses.replace(sh,
                                                    slot_headroom=headroom))
    mesh = make_mesh(cfg_s, device=dev)
    slots = shard_slots(cfg_s)
    equal = distribute_state(skew, cfg_s, mesh)
    occ0 = shard_occupancy(equal, cfg_s)
    bal = LoadBalancer(cfg_s, slots, check_every=1)
    trigger = bal.should_rebalance(equal)
    t0 = time.perf_counter()
    states, bx, by, _ = bal.rebalance(equal, mesh)
    torch.cuda.synchronize()
    rebalance_ms = (time.perf_counter() - t0) * 1e3
    occ1 = shard_occupancy(states, cfg_s)
    conserved("balance", states, n, torch)
    widths = dict(x=float((bx[1:] - bx[:-1]).min()),
                  y=float((by[1:] - by[:-1]).min()))
    reach = predict_reach(cfg_s, SERVING_HORIZON, SERVING_STEP)
    narrow = min(widths.values())
    walls = (bx, by, None)
    # the deployment's halo of 1,024 on the city cores, under the equal
    # and under the new walls: its drops are reported beside each other
    deployment_halo = {}
    for name, start, w in (("equal_walls", equal, (None, None, None)),
                           ("quantile_walls", states, walls)):
        d0, _ = launch_counts()
        _, _, w_of, w_ao, drops, least = history_steps(cfg_s, mesh, start,
                                                       w, 3, torch)
        launches["hits"] += launch_counts()[0] - d0
        deployment_halo[name] = dict(dropped=drops, worst_overflow=w_of,
                                     worst_alert_overflow=w_ao,
                                     least_num_alive=least)
    # the certificates under the new walls, at a halo as large as a shard
    # (a band never holds more than its neighbour's slots)
    cfg_w = cfg_s.replace(shard=dataclasses.replace(cfg_s.shard,
                                                    halo_capacity=slots))
    d0, _ = launch_counts()
    states, hists, w_of, w_ao, drops, least = history_steps(
        cfg_w, mesh, states, walls, 3, torch)
    n_launch = launch_counts()[0] - d0
    launches["hits"] += n_launch
    conserved("balance, 3 steps", states, n, torch)
    # the slot shortfall at k 8 belongs to the fleet: the single-device
    # step of the same fleet (a hot top-up as large as the 16 shards')
    # has one of the same order
    one = single_shard(cfg_s, 1 << 20)
    one = one.replace(detect=dataclasses.replace(
        one.detect, hot_topup=cfg_s.detect.hot_topup * d))
    single_ao = single_device_alert_overflow(
        one, by_oid_state(collect_state(states), torch), 3, torch, dev)
    line = dict(phase="sharded_serving", part="balance",
                fleet="100k_2d_cityskew", shards=list(mesh.shape),
                slot_headroom=headroom, slots=slots,
                occupancy_equal_walls=occ0.tolist(),
                imbalance_equal_walls=imbalance(occ0),
                should_rebalance=trigger, rebalance_host_ms=rebalance_ms,
                walls_x=bx.tolist(), walls_y=by.tolist(),
                occupancy_after=occ1.tolist(), imbalance_after=imbalance(occ1),
                narrowest_slab_m=widths,
                min_slab_width=bal.min_slab_width(),
                predict_reach_m=reach,
                default_hops=[predict_hops(cfg_s, reach, i) for i in (0, 1)],
                balancer=bal.stats, steps_after=3,
                deployment_halo=dict(halo_capacity=sh.halo_capacity,
                                     **deployment_halo),
                halo_capacity=slots, kernel_launches=n_launch,
                worst_overflow=w_of, dropped=drops, least_num_alive=least,
                k=cfg_s.alerts.max_alerts_per_object,
                worst_alert_overflow=w_ao,
                single_device_worst_alert_overflow=single_ao,
                conserved=True, seconds=time.perf_counter() - t_part,
                card=smi)
    emit(line)
    # walls are kept as f32: a slab may read a few mm under the f64 width.
    # The shard-sized halo must drop nothing; alert_overflow is reported
    # beside the single device's (the fleet's cores hold more qualifying
    # pairs an object than k 8, on one device as on 16 shards)
    if not trigger or imbalance(occ1) >= imbalance(occ0) or least != n \
            or narrow < bal.min_slab_width() - 1e-2 or n_launch != 3 * d \
            or drops or w_of:
        raise AssertionError(f"sharded_serving balance: {line}")
    skew_run = (cfg_s, mesh, states, hists, walls, narrow, reach, slots)
    del equal

    # ---- (b) sharded prediction: uniform 100k on equal walls ----
    t_part = time.perf_counter()
    uniform = generate_fleet(torch.Generator(device=dev).manual_seed(0),
                             cfg_f, "uniform")
    mesh = make_mesh(cfg_f, device=dev)
    states = distribute_state(uniform, cfg_f, mesh)
    d0, _ = launch_counts()
    states, hists, w_of, w_ao, drops, least = history_steps(
        cfg_f, mesh, states, (None, None, None), 4, torch)
    n_steps = launch_counts()[0] - d0
    launches["hits"] += n_steps
    line, run = sharded_vs_single_predict(
        "100k_2d_uniform", cfg_f, mesh, states, hists, (None, None, None),
        None, None, smi, torch)
    launches["predict"] += line["predict_launches"]
    _, p0 = launch_counts()
    profile = device_profile(run, 2, torch)
    launches["predict"] += launch_counts()[1] - p0
    emit(dict(phase="sharded_serving", part="predict", **line,
              steps=dict(n=4, kernel_launches=n_steps, worst_overflow=w_of,
                         worst_alert_overflow=w_ao, dropped=drops),
              profile=profile, seconds=time.perf_counter() - t_part,
              card=smi))
    if drops or n_steps != 4 * d:
        raise AssertionError(f"sharded_serving predict set-up: {n_steps} "
                             f"launches, dropped {drops}")
    t_part = time.perf_counter()
    kernel = predict_kernel_on_shard(cfg_f, mesh, states, hists, smi, torch)
    emit(dict(phase="sharded_serving", part="predict_kernel_vs_plain",
              fleet="100k_2d_uniform", **kernel,
              seconds=time.perf_counter() - t_part, card=smi))

    # the xla backend at SERVING_XLA_N against the fused one
    t_part = time.perf_counter()
    cfg_x = cfg_f.replace(num_objects=SERVING_XLA_N)
    mesh_x = make_mesh(cfg_x, device=dev)
    small = generate_fleet(torch.Generator(device=dev).manual_seed(7),
                           cfg_x, "uniform")
    sx = distribute_state(small, cfg_x, mesh_x)
    d0, _ = launch_counts()
    sx, hx, _, _, drops_x, _ = history_steps(cfg_x, mesh_x, sx,
                                             (None, None, None), 4, torch)
    launches["hits"] += launch_counts()[0] - d0
    outs = {}
    for backend in ("xla", "fused"):
        pfn = make_sharded_predict(cfg_x, mesh_x, horizon=SERVING_HORIZON,
                                   step=SERVING_STEP, backend=backend)
        _, p0 = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pfn(sx, hx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches["predict"] += launch_counts()[1] - p0
        cat = lambda parts: torch.cat(list(parts))
        row_oid = cat(res[5]) if backend == "fused" \
            else cat(s.oid for s in sx)
        outs[backend] = dict(ms=ms, pairs=predicted_pairs(
            [cat(c) for c in res[:5]], row_oid, torch),
            dropped=int(res[-2].sum()), counter=int(res[-1].sum()))
    diff = pair_diff(outs["fused"]["pairs"], outs["xla"]["pairs"])
    certify = outs["xla"]["dropped"] == outs["xla"]["counter"] == \
        outs["fused"]["dropped"] == outs["fused"]["counter"] == 0
    line = dict(phase="sharded_serving", part="predict_xla_vs_fused",
                fleet=f"{SERVING_XLA_N}_2d_uniform",
                shards=list(mesh_x.shape),
                xla=dict(ms=outs["xla"]["ms"], dropped=outs["xla"]["dropped"],
                         grid_overflow=outs["xla"]["counter"]),
                fused=dict(ms=outs["fused"]["ms"],
                           dropped=outs["fused"]["dropped"],
                           overflow_plus_slot_oflow=outs["fused"]["counter"]),
                both_certify=certify, **diff,
                seconds=time.perf_counter() - t_part, card=smi)
    emit(line)
    if certify and (diff["only_sharded"] or diff["only_single"]
                    or diff["max_abs_diff"] > ORACLE_TOL) or drops_x:
        raise AssertionError(f"sharded_serving xla vs fused: {line}")

    # the rebalanced city-skew fleet: hops for its narrowest slab, and a
    # halo buffer as large as a shard, so that no band object drops
    t_part = time.perf_counter()
    cfg_s, mesh, states, hists, walls, narrow, reach, slots = skew_run
    hops = max(1, int(np.ceil(reach / narrow)))
    line, _ = sharded_vs_single_predict(
        "100k_2d_cityskew_rebalanced", cfg_s, mesh, states, hists, walls,
        hops, slots, smi, torch)
    launches["predict"] += line["predict_launches"]
    emit(dict(phase="sharded_serving", part="predict_rebalanced", **line,
              narrowest_slab_m=narrow, predict_reach_m=reach,
              seconds=time.perf_counter() - t_part, card=smi))
    del skew_run, states, hists, sx, hx

    # ---- (c) ShardedScene, fast and precise ----
    t_part = time.perf_counter()
    SCRATCH.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="sharded_ckpt_", dir=SCRATCH)
    d0, p0 = launch_counts()
    sc = ShardedScene(cfg_f, fleet=uniform, backend="fused",
                      checkpoint_dir=ckpt_dir, device=dev)
    calls = {}
    steps, calls["step"] = timed_calls(sc.step, SERVING_STEPS)
    piped, calls["step_pipelined"] = timed_calls(sc.step_pipelined,
                                                 SERVING_STEPS)
    t0 = time.perf_counter()
    piped = piped[1:] + [sc.pipeline_drain()]
    calls["pipeline_drain"] = [(time.perf_counter() - t0) * 1e3]
    burst, calls[f"step_burst({SERVING_BURST})"] = timed_calls(
        lambda: sc.step_burst(SERVING_BURST), 1)
    batch, calls["detect"] = timed_calls(sc.detect, 1)
    ticks = []
    for _ in range(4):
        sc.step()
        t0 = time.perf_counter()
        sc.record_trajectories()
        ticks.append((time.perf_counter() - t0) * 1e3)
    calls["record_trajectories"] = ticks
    d1, p1 = launch_counts()
    preds, calls["predict"] = timed_calls(sc.predict, SERVING_SCENE_PREDICTS)
    d2, p2 = launch_counts()
    outs = steps + piped + burst
    certs = [(int(o.overflow), int(o.alert_overflow)) for o in outs]
    n_steps = 2 * SERVING_STEPS + SERVING_BURST + 4
    launches["hits"] += d2 - d0
    launches["predict"] += p2 - p0
    line = dict(phase="sharded_serving", part="scene", mode="hits",
                config="100k_2d_fast_8x2", fleet="100k_2d_uniform",
                ms_per_call={k: dict(calls=len(v), median=statistics.median(v),
                                     **call_stats(v)) for k, v in calls.items()},
                certificates=certs, detection_launches=d1 - d0,
                fused_steps=n_steps,
                predict_launches=p2 - p1, last_predict=sc.last_predict,
                predicted_risks=[len(p) for p in preds],
                detect_alerts=int(batch[0].count.sum()),
                step_and_copy_avg_ms=sc.stats()["avg_step_ms"],
                stats={k: v for k, v in sc.stats().items()
                       if k not in ("shard_occupancy", "alerts")},
                alert_stats=sc.alert_manager.get_stats(),
                seconds=time.perf_counter() - t_part, card=smi)
    emit(line)
    # the scene heals no slots: a non-zero alert_overflow is reported
    if d1 - d0 != n_steps * d or p2 - p1 != SERVING_SCENE_PREDICTS * d \
            or p1 != p0 or d2 != d1 or any(of for of, _ in certs) \
            or sc.dropped_total or sc.stats()["num_alive"] != n:
        raise AssertionError(f"sharded_serving scene: {line}")

    # checkpoints: save, restore, two async saves back to back
    t_part = time.perf_counter()
    d0, _ = launch_counts()
    try:
        before = by_oid_state(sc.collect(), torch)
        at = sc.step_count
        save_ms = timed_calls(sc.save_checkpoint, 1)[1][0]
        sc.step()
        restore_ms = timed_calls(sc.restore_checkpoint, 1)[1][0]
        after = by_oid_state(sc.collect(), torch)
        restored_equal = states_equal(before, after, torch)
        async_ms = timed_calls(sc.save_checkpoint_async, 2)[1]
        t0 = time.perf_counter()
        sc.ckpt.wait_async()
        wait_ms = (time.perf_counter() - t0) * 1e3
        saved = sc.ckpt.stats
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_launch = launch_counts()[0] - d0
    launches["hits"] += n_launch
    line = dict(phase="sharded_serving", part="checkpoint",
                config="100k_2d_fast_8x2", step=at, save_ms=save_ms,
                detection_launches=n_launch,
                restore_ms=restore_ms, restored_step=sc.step_count,
                state_bit_equal_by_oid=restored_equal,
                async_save_call_ms=async_ms, async_wait_ms=wait_ms,
                checkpoint_stats=saved,
                seconds=time.perf_counter() - t_part, card=smi)
    emit(line)
    # one step between save and restore: one launch a shard
    if not restored_equal or sc.step_count != at \
            or saved["async_saves"] != 2 or n_launch != d:
        raise AssertionError(f"sharded_serving checkpoint: {line}")
    del sc

    # precise mode at the sharded phase's adopted survivor_k / cap
    t_part = time.perf_counter()
    d0, _ = launch_counts()
    sc = ShardedScene(cfg_p, fleet=uniform, backend="fused", device=dev)
    outs, ms = timed_calls(sc.step, SERVING_STEPS)
    n_launch = launch_counts()[0] - d0
    launches["survivors"] += n_launch
    certs = [(int(o.overflow), int(o.alert_overflow)) for o in outs]
    line = dict(phase="sharded_serving", part="scene", mode="survivors",
                config="100k_2d_precise_8x2",
                survivor_k=cfg_p.detect.survivor_k,
                survivor_cap=cfg_p.survivor_cap,
                ms_per_call=dict(step=dict(calls=len(ms),
                                           median=statistics.median(ms),
                                           **call_stats(ms))),
                certificates=certs, detection_launches=n_launch,
                num_risks=int(outs[-1].num_risks),
                seconds=time.perf_counter() - t_part, card=smi)
    emit(line)
    if n_launch != SERVING_STEPS * d or any(of for of, _ in certs):
        raise AssertionError(f"sharded_serving precise: {line}")
    del sc

    # ---- (d) the sharded service node over HTTP ----
    t_part = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="sharded_service_", dir=SCRATCH)
    node = None
    try:
        node = ServiceNode(cfg_f, dev, ckpt_dir)
        sc, base = node.scene, node.base
        if not isinstance(sc, ShardedScene):
            raise AssertionError(f"service: {type(sc).__name__}")
        sc.adopt_fleet(uniform)
        ms = {}

        def request(route, method, path, body=None):
            payload, t = http_call(base, method, path, body)
            ms.setdefault(route, []).append(t)
            return payload["data"]

        # reports number their vehicles from oid 0, as the JAX ShardedScene
        # does: they move fleet objects 0 .. 99 to pairs 30 m apart that
        # straddle the first x wall, closing at 16 m/s
        wall = cfg_f.world.hi[0] / sh.num_shards
        rows = SERVING_REPORTS // 2
        for i in range(SERVING_REPORTS):
            side, row = i % 2, i // 2
            request("POST /vehicles/location", "POST", "/vehicles/location",
                    {"vehicle_id": f"report-{i}",
                     "position": {"x": wall - 10.0 + 30.0 * side,
                                  "y": (row + 0.5) * cfg_f.world.hi[1]
                                  / rows},
                     "velocity": {"x": 8.0 - 16.0 * side},
                     "heading": 3.14159 * side})
        d0, _ = launch_counts()
        node.outputs.clear()
        for _ in range(SERVING_HTTP_STEPS):
            step = request("POST /step", "POST", "/step", {})
        detect = request("POST /detect", "POST", "/detect", {})
        n_launch = launch_counts()[0] - d0
        certs = node.certificates()
        alerts = request("GET /alerts", "GET", "/alerts")
        launches["hits"] += n_launch
        vids = {a["vehicle_id"] for a in alerts}
        line = dict(phase="sharded_serving", part="service",
                    config="100k_2d_fast_8x2", reports=SERVING_REPORTS,
                    ms_per_request={r: dict(calls=len(v),
                                            median=statistics.median(v),
                                            **call_stats(v))
                                    for r, v in ms.items()},
                    last_step=step, detect=detect, alerts=len(alerts),
                    reported_vehicles_alerted=sum(
                        f"report-{i}" in vids
                        for i in range(SERVING_REPORTS)),
                    detection_launches=n_launch, certificates=certs,
                    num_alive=sc.stats()["num_alive"],
                    dropped_total=sc.dropped_total,
                    seconds=time.perf_counter() - t_part, card=smi)
        emit(line)
        if n_launch != SERVING_HTTP_STEPS * d or any(of for of, _ in certs) \
                or line["num_alive"] != n or sc.dropped_total \
                or not line["reported_vehicles_alerted"]:
            raise AssertionError(f"sharded_serving service: {line}")
    finally:
        if node is not None:
            node.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # the entry point a user starts, sharded
    shard_args = ("--shards", "4", "--shards-y", "2")
    emit(dict(phase="sharded_serving", part="entry_point",
              command="python -m tpu_collide_torch.system --objects "
                      f"{ENTRY_OBJECTS} --backend fused "
                      + " ".join(shard_args) + " --api-port PORT",
              **entry_point(("--device", str(dev)) + shard_args), card=smi))
    return launches


# ---- bench: the load harness (tpu_collide_torch/bench/) -------------------

# steps of the harness's schedule (the warm-up and the first measured steps)
# that certified() replays before a row's timed run; the timed run's first
# steps are held to that replay
BENCH_CERT_STEPS = 20
# the timed run's last steps, replayed from the state the run stepped them
# from
BENCH_REPLAY_TAIL = 10
# the reference's records of its two harness runs (BASELINE.md), on a
# single-process CPU: printed beside the rows, not targets
REFERENCE_CPU = {
    "1k_precise_cityskew": dict(
        vehicles=1000, target_tps=1000, seconds=30, avg_ms=99.32,
        steps_per_s=9.44, hardware="single-process CPU",
        source="BASELINE.md"),
    "5k_precise_cityskew": dict(
        vehicles=5000, target_tps=5000, seconds=60, avg_ms=73275.27,
        steps_per_s=0.01, steps=1, hardware="single-process CPU",
        source="BASELINE.md (unoptimized test: no second step)")}
# the profiled harness run: target TPS and seconds
BENCH_PROFILE_TPS, BENCH_PROFILE_S = 50, 0.5
# python -m tpu_collide_torch.bench.harness (the README's run, shorter) and
# python -m tpu_collide_torch.bench.run_benchmark (benchmark.sh's settings
# with a shorter duration)
BENCH_CLI_ARGS = ("--vehicles", "1000", "--tps", "1000", "--duration", "5",
                  "--backend", "fused", "--mode", "fast")
ORCHESTRATED_ARGS = ("--vehicles", "1000", "--tps", "200", "--duration",
                     "10", "--sim-duration", "5", "--mode", "fast",
                     "--inject-failure")
BENCH_SUBPROCESS_S = 300
# the reference's artifact headers (tpu_collide/bench/harness.py:161-168)
LATENCIES_HEADER = "latency_ms"
METRICS_HEADER = ("timestamp,throughput,avg_latency,p95_latency,p99_latency,"
                  "max_latency,error_rate,cpu_usage,memory_usage")


# the bench phase's rows: (name, target TPS, seconds, whether the survivor
# cap is sized by probe first). The four rows of main_path keep its
# configurations; the 5k row is the 1k one at 5,000 objects, the 1M-3D
# precise row bench.py's (bench.py:386-393). bench.py sizes the cap of its
# two flagship precise rows by probe (probe_cap=True, :358 and :393); the
# reference's harness runs step at the default cap, as its make_step does.
BENCH_ROWS = (
    ("1k_precise_cityskew", 1000, 10.0, False),     # BASELINE.md
    ("5k_precise_cityskew", 5000, 5.0, False),      # BASELINE.md
    ("100k_2d_fast", 0, 5.0, False),                # bench.py:337
    ("100k_2d_precise", 0, 5.0, True),              # bench.py:355-358
    ("1m_3d_fast", 0, 5.0, False),                  # bench.py:364
    ("1m_3d_precise", 0, 5.0, True),                # bench.py:386-393
)
# steps of the harness's schedule over which a probed row's survivor need
# is measured (bench.py probes the 45 steps its timed run replays)
BENCH_PROBE_STEPS = 100


def bench_rows():
    """(name, cfg, distribution, target TPS, seconds, probe) of the bench
    phase: the reference's two measured harness runs (BASELINE.md) at the
    harness CLI's configuration, then bench.py's flagship sizes flat out,
    with main_path's configurations where it runs the row."""
    runs = {name: (cfg, dist) for name, cfg, dist in main_path_runs()}
    cfg1k, _ = runs["1k_precise_cityskew"]
    cfg1m, _ = runs["1m_3d_fast"]
    runs["5k_precise_cityskew"] = (cfg1k.replace(num_objects=5000),
                                   "city_skew")
    runs["1m_3d_precise"] = (cfg1m.replace(detect=dataclasses.replace(
        cfg1m.detect, mode="precise")), "uniform")
    return tuple((name, *runs[name], tps, seconds, probe)
                 for name, tps, seconds, probe in BENCH_ROWS)


def harness_replay(cfg, dist, n, torch, dev) -> tuple:
    """The first n steps of the harness's schedule (its fleet from seed 0,
    then the warm-up step and the measured steps from seeds 1, 2, ...)
    through make_step(cfg, backend="fused"): (num_risks of each step, worst
    overflow, worst alert_overflow, the state after the last step)."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.bench.harness import seeded
    from tpu_collide_torch.sim import generate_fleet
    state = generate_fleet(seeded(0, dev), cfg, distribution=dist)
    step = tt.make_step(cfg, backend="fused", device=dev)
    risks = []
    worst_of = torch.zeros((), dtype=torch.int32, device=dev)
    worst_ao = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n):
        state, out = step(state, seeded(1 + i, dev))
        risks.append(out.num_risks)
        worst_of = torch.maximum(worst_of, out.overflow)
        worst_ao = torch.maximum(worst_ao, out.alert_overflow)
    return torch.stack(risks).tolist(), int(worst_of), int(worst_ao), state


def harness_survivor_cap(cfg, dist, n, dev) -> int:
    """bench.py's probe_cap (bench.py:187-196) on the harness's schedule:
    kernels/tune.suggest_survivor_cap of the positions after each of the
    first n steps (the fleet from seed 0, physics from generators seeded
    1, 2, ...), the largest. The rule rounds up, so the largest of the
    suggestions is the suggestion for the largest need."""
    from tpu_collide_torch.bench.harness import seeded
    from tpu_collide_torch.kernels.tune import suggest_survivor_cap
    from tpu_collide_torch.sim import generate_fleet
    from tpu_collide_torch.sim.integrator import integrate
    state = generate_fleet(seeded(0, dev), cfg, distribution=dist)
    cap = 0
    for i in range(n):
        state = integrate(state, cfg, seeded(1 + i, dev))
        cap = max(cap, suggest_survivor_cap(cfg, state))
    return cap


def metrics_line(m, tester) -> dict:
    return dict(throughput_rps=m.throughput, avg_ms=m.avg_latency,
                p95_ms=m.p95_latency, p99_ms=m.p99_latency,
                max_ms=m.max_latency, error_rate_pct=m.error_rate,
                requests=tester.request_count,
                total_risks=tester.total_risks)


class StepRecorder:
    """A stand-in for bench/harness.make_step during a timed run: each step
    function it makes runs the real step and keeps references, with no
    launch and no host read inside the harness's window, to each step's
    overflow, alert_overflow and num_risks (read after the run by
    counters()), the input state of the last BENCH_REPLAY_TAIL steps and
    the last output state, and counts the steps."""

    def __init__(self, real):
        import collections
        self.real = real
        self.outs, self.last, self.calls = [], None, 0
        self.inputs = collections.deque(maxlen=BENCH_REPLAY_TAIL)

    def __call__(self, cfg, **kw):
        stepf = self.real(cfg, **kw)

        def step(state, generator):
            self.inputs.append(state)
            state, out = stepf(state, generator)
            self.outs.append((out.overflow, out.alert_overflow,
                              out.num_risks))
            self.last = state
            self.calls += 1
            return state, out
        return step

    def counters(self, torch) -> tuple:
        """(the worst overflow, the worst alert_overflow, each step's
        num_risks) of the recorded steps, in one host read."""
        rows = torch.stack([torch.stack(o) for o in self.outs]).tolist()
        return (max(r[0] for r in rows), max(r[1] for r in rows),
                [r[2] for r in rows])


def replay_from(cfg, state, first, n, dev) -> list:
    """num_risks of n steps of make_step(cfg, backend="fused") from `state`,
    the step with call index i (0: the warm-up) drawing from a generator
    seeded 1 + i, as the harness's steps do, starting at call `first`."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.bench.harness import seeded
    step = tt.make_step(cfg, backend="fused", device=dev)
    risks = []
    for i in range(first, first + n):
        state, out = step(state, seeded(1 + i, dev))
        risks.append(out.num_risks)
    return [int(r) for r in risks]


def bench_row(name, cfg, dist, tps, seconds, probe, smi, torch,
              dev) -> tuple:
    """One row: the survivor cap sized by probe where `probe`, certified()
    on the harness's fleet and generators (which replays its first
    BENCH_CERT_STEPS steps), the timed PerformanceTester(backend="fused")
    run through a StepRecorder, then the kernel held to its plain version
    on the cell list of the last step. Fails unless every step of the run
    has certificates 0, its first steps' num_risks equal the certification
    replay's and its last BENCH_REPLAY_TAIL steps' equal a replay from the
    recorded state (the run is deterministic), the recorded risks sum to
    total_risks, no step failed, the run launched the detection kernel
    once a step (the warm-up included), and the kernel's slots equal the
    plain version's bit for bit. Returns (the configuration adopted,
    launches, the kernel's largest key error against the plain version)."""
    from tpu_collide_torch.bench import harness
    from tpu_collide_torch.bench.harness import PerformanceTester
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        slot_count)
    t0 = time.perf_counter()
    default_cap = cfg.survivor_cap
    if probe:
        cfg = cfg.replace(detect=dataclasses.replace(
            cfg.detect, precise_survivor_cap=harness_survivor_cap(
                cfg, dist, BENCH_PROBE_STEPS, dev)))

    def drive(c):
        risks, worst_of, worst_ao, _ = harness_replay(c, dist,
                                                      BENCH_CERT_STEPS,
                                                      torch, dev)
        return max(worst_of, worst_ao), risks
    cfg, worst, cert_risks, attempts = certified(cfg, drive)
    if worst:
        raise AssertionError(f"bench {name}: certificate {worst} after "
                             f"{attempts} attempts")
    tester = PerformanceTester(cfg, backend="fused", distribution=dist,
                               device=dev)
    rec = StepRecorder(harness.make_step)
    harness.make_step = rec
    fused_topk.launches = 0
    try:
        m = tester.run_test(tps, seconds, save=False)
    finally:
        harness.make_step = rec.real
    launched = fused_topk.launches
    steps = tester.request_count + 1
    worst_of, worst_ao, risks = rec.counters(torch)
    tail, prefix = len(rec.inputs), min(len(cert_risks), steps)
    replayed = replay_from(cfg, rec.inputs[0], steps - tail, tail, dev)
    # the kernel against its plain version at the row's own shapes: the
    # cell list that the last step's detection saw
    mode = {"fast": "hits", "precise": "survivors"}[cfg.detect.mode]
    cl = build_cell_list(rec.last, cfg)
    got, want = fused_topk(cl, cfg, mode), fused_topk_plain(cl, cfg, mode)
    vs_plain = compare_slots(got, want, slot_count(cfg, mode), torch)
    line = dict(phase="bench", row=name, n=cfg.num_objects,
                distribution=dist, mode=cfg.detect.mode, target_tps=tps,
                seconds=seconds, **metrics_line(m, tester),
                recorded_total_risks=sum(risks[1:]), recorded_steps=steps,
                replayed_prefix_steps=prefix, replayed_tail_steps=tail,
                prefix_equal=risks[:prefix] == cert_risks[:prefix],
                tail_equal=risks[steps - tail:] == replayed,
                worst_overflow=worst_of, worst_alert_overflow=worst_ao,
                kernel_launches=launched, attempts=attempts,
                max_alerts_per_object=cfg.alerts.max_alerts_per_object,
                survivor_k=cfg.detect.survivor_k,
                survivor_cap=cfg.survivor_cap,
                survivor_cap_probed=probe, default_survivor_cap=default_cap,
                kernel_vs_plain=vs_plain,
                reference_cpu_record=REFERENCE_CPU.get(name),
                wall_s=time.perf_counter() - t0, card=smi)
    emit(line)
    if tester.error_count or worst_of or worst_ao \
            or line["recorded_total_risks"] != tester.total_risks \
            or not (line["prefix_equal"] and line["tail_equal"]) \
            or launched != steps or rec.calls != steps:
        raise AssertionError(f"bench {name}: {line}")
    return cfg, launched, vs_plain["max_abs_err"]


def trace_kernels(directory, name) -> tuple:
    """(files, device kernel events whose name holds `name`) of the
    torch.profiler Chrome traces in `directory`."""
    files = sorted(pathlib.Path(directory).glob("*.pt.trace.json"))
    n = 0
    for p in files:
        with open(p) as f:
            n += sum(1 for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel" and name in e.get("name", ""))
    return len(files), n


def bench_subprocess(module, args) -> tuple:
    """python -m `module` *args from the repository's root, on the card
    unless the arguments name another device: (exit code, seconds, its
    standard output, the end of its standard error)."""
    import os
    import sys
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=BENCH_SUBPROCESS_S)
    return (res.returncode, time.perf_counter() - t0, res.stdout,
            res.stderr[-3000:])


def bench_cli(work) -> dict:
    """python -m tpu_collide_torch.bench.harness: exits 0 and writes the
    reference's artifact triplet with its headers and no error."""
    rc, secs, out, err = bench_subprocess(
        "tpu_collide_torch.bench.harness",
        BENCH_CLI_ARGS + ("--output-dir", work))
    if rc != 0:
        raise AssertionError(f"bench harness CLI exited {rc}: {err}")
    triplet = {}
    for suffix in ("latencies.csv", "metrics.csv", "summary.txt"):
        (path,) = pathlib.Path(work).glob(
            f"perf_test_1000vehicles_1000tps_5s_*_{suffix}")
        triplet[suffix] = path.read_text().splitlines()
    summary = dict(ln.strip().split(": ", 1)
                   for ln in triplet["summary.txt"] if ": " in ln)
    if triplet["latencies.csv"][0] != LATENCIES_HEADER \
            or triplet["metrics.csv"][0] != METRICS_HEADER \
            or summary["Total errors"] != "0" \
            or len(triplet["latencies.csv"]) - 1 \
            != int(summary["Total requests"]):
        raise AssertionError(f"bench harness CLI artifacts: {summary}")
    return dict(command="python -m tpu_collide_torch.bench.harness "
                        + " ".join(BENCH_CLI_ARGS),
                exit_code=rc, seconds=secs, printed=out.strip(),
                summary=summary)


def bench_orchestrated(work) -> dict:
    """python -m tpu_collide_torch.bench.run_benchmark: exits 0 with no
    load error, simulator updates, a tenth of the live objects killed (as
    the route rounds it) and a monitor CSV; fails if the monitor reached
    the service in no sample."""
    import csv
    rc, secs, _, err = bench_subprocess(
        "tpu_collide_torch.bench.run_benchmark",
        ORCHESTRATED_ARGS + ("--output-dir", work))
    if rc != 0:
        raise AssertionError(f"run_benchmark exited {rc}: {err}")
    (path,) = pathlib.Path(work).glob("benchmark_*_summary.json")
    summary = json.loads(path.read_text())
    (mon,) = pathlib.Path(work).glob("monitor_*.csv")
    with open(mon) as f:
        samples = list(csv.DictReader(f))
    unreachable = sum(1 for s in samples if s.get("svc_unreachable") == "1")
    killed = summary["fault"]["data"]["killed"]
    live = summary["system"]["num_alive"] + killed
    line = dict(command="python -m tpu_collide_torch.bench.run_benchmark "
                        + " ".join(ORCHESTRATED_ARGS),
                exit_code=rc, seconds=secs, load=summary["load"],
                sim_updates=summary["sim_updates"], killed=killed,
                live_before_fault=live, system=summary["system"],
                avg_detect_ms=summary["system"]["avg_detect_ms"],
                monitor_samples=len(samples),
                monitor_unreachable=unreachable)
    if summary["load"]["errors"] or not summary["sim_updates"] > 0 \
            or killed != int(live * 0.1) or not killed \
            or not samples or unreachable == len(samples):
        raise AssertionError(f"run_benchmark: {line}")
    return line


def bench_phase(smi, torch, dev) -> tuple:
    """The load harness on the card: (a) the reference's measured harness
    runs and (b) bench.py's flagship sizes through
    PerformanceTester(backend="fused"), each certified, timed, replayed and
    held to the plain version (bench_row); (c) a profiled run whose trace names the detection kernel,
    and the harness CLI as a user runs it; (d) the orchestrated run.
    Emits one line per part; returns (the detection kernel's launches on
    the path by mode, its largest key error against the plain version by
    mode)."""
    import shutil
    import tempfile
    from tpu_collide_torch.bench.harness import PerformanceTester
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    t_phase = time.perf_counter()
    mode_of = {"fast": "hits", "precise": "survivors"}
    launches = {"hits": 0, "survivors": 0}
    err = {"hits": 0.0, "survivors": 0.0}
    adopted = {}
    for name, cfg, dist, tps, seconds, probe in bench_rows():
        mode = mode_of[cfg.detect.mode]
        adopted[name], n, e = bench_row(name, cfg, dist, tps, seconds, probe,
                                        smi, torch, dev)
        launches[mode] += n
        err[mode] = max(err[mode], e)

    SCRATCH.mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_", dir=SCRATCH)
    try:
        # (c) the profiler over a harness run, then the CLI
        prof_dir = pathlib.Path(work) / "profile"
        cfg = adopted["1k_precise_cityskew"]
        tester = PerformanceTester(cfg, output_dir=work, backend="fused",
                                   device=dev)
        fused_topk.launches = 0
        m = tester.run_test(BENCH_PROFILE_TPS, BENCH_PROFILE_S, save=False,
                            profile_dir=str(prof_dir))
        n_launch = fused_topk.launches
        launches["survivors"] += n_launch
        files, events = trace_kernels(prof_dir, "fused_topk_kernel")
        line = dict(phase="bench", part="profile", row="1k_precise_cityskew",
                    target_tps=BENCH_PROFILE_TPS, seconds=BENCH_PROFILE_S,
                    **metrics_line(m, tester), kernel_launches=n_launch,
                    trace_files=files, trace_kernel_events=events, card=smi)
        emit(line)
        if tester.error_count or files != 1 \
                or n_launch != tester.request_count + 1 \
                or events != tester.request_count:
            raise AssertionError(f"bench profile: {line}")
        emit(dict(phase="bench", part="cli",
                  **bench_cli(str(pathlib.Path(work) / "cli")), card=smi))
        # (d) the orchestrated run
        emit(dict(phase="bench", part="orchestrated",
                  **bench_orchestrated(str(pathlib.Path(work) / "run")),
                  card=smi))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(dict(phase="bench", part="done", launches=launches,
              max_abs_err=err,
              seconds=time.perf_counter() - t_phase, card=smi))
    return launches, err


# ---- scale: the twins of tools/scale_bench.py and tools/big_mesh_dryrun.py --

# tools/scale_bench.py's fused rows (:133-138): (tag, mode, steps, chunk,
# survivor cap by probe)
SCALE_ROWS = (("10m_3d_fast", "fast", 9, 3, False),
              ("10m_3d_precise", "precise", 6, 2, True))
# steps of each 10M row under torch.profiler
SCALE_PROFILE_STEPS = 2
# run_sharded_1m's steps and chunk (:80), and the rounds in which it runs in
# turns with the unsharded 1M-3D step
SCALE_SHARDED_STEPS, SCALE_SHARDED_CHUNK, SCALE_ROUNDS = 12, 4, 2
# tools/big_mesh_dryrun.py's grids at its default N and --steps 2, both
# backends; the profiled steps of each fused grid
BIG_MESH_GRIDS = ((16, "8x2"), (64, "8x8"))
BIG_MESH_N, BIG_MESH_STEPS, BIG_MESH_PROFILE_STEPS = 65536, 2, 2


def load_tool(name):
    """tools/<name>.py as a module."""
    import importlib.util
    import sys
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def kernel_at(name, cl, cfg, mode, smi, torch, **extra) -> dict:
    """The detection kernel on one cell list of a scale run: bit-equal to
    its plain version (compare_slots), its CUDA-event ms (median of
    REPEATS), its device ms (graph_ms), the plain version's ms and the
    bound; emits the line and returns it."""
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        slot_count)
    k = slot_count(cfg, mode)
    got, want = fused_topk(cl, cfg, mode), fused_topk_plain(cl, cfg, mode)
    torch.cuda.synchronize()
    res = compare_slots(got, want, k, torch)
    b = detect_bound(cl, cfg, mode, got, torch)
    del got, want
    line = dict(phase="scale", part="kernel_vs_plain", cells=name,
                mode=mode, n=cl.n, alive=int(cl.n_alive),
                owned=int((cl.own & cl.alive).sum()), k=k, **res,
                ms=median_ms(lambda: fused_topk(cl, cfg, mode), torch),
                device_ms=graph_ms(lambda: fused_topk(cl, cfg, mode),
                                   torch),
                plain_ms=median_ms(lambda: fused_topk_plain(cl, cfg, mode),
                                   torch, repeats=1),
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                kernel_bound=b, **extra, card=smi)
    emit(line)
    return line


def scale_phase(smi, torch, dev) -> dict:
    """The port's twins of the JAX package's scale tools on the card:
    (a) tools/torch_scale_bench.py's 10M-3D rows, fast and precise (the
    survivor cap by probe), each certified by the twin's adopt rule, its
    kernel bit-equal to the plain version on the last stepped state's cell
    list; (b) its 1M-3D one-shard sharded row in turns with the unsharded
    1M-3D step, conserved and certified, the kernel on the shard's cell
    list; (c) tools/torch_big_mesh_dryrun.py at 64k on 8x2 and 8x8 shards,
    backends xla and fused, each passing the tool's asserts, the fused
    grids profiled, and the kernel on an inner 8x8 shard's halo-extended
    cell list. Emits one line per part; returns the detection kernel's
    launches on the path by mode and its largest key error against the
    plain version by mode."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    from tpu_collide_torch.shard import shard_generators
    from tpu_collide_torch.shard.step import _default_walls, _halo_extend
    tsb = load_tool("torch_scale_bench")
    tbm = load_tool("torch_big_mesh_dryrun")
    t_phase = time.perf_counter()
    mode_of = {"fast": "hits", "precise": "survivors"}
    launches = {"hits": 0, "survivors": 0}
    err = {"hits": 0.0, "survivors": 0.0}

    # ---- (a) 10M-3D, fast and precise ----
    for tag, det_mode, steps, chunk, probe in SCALE_ROWS:
        t0 = time.perf_counter()
        mode = mode_of[det_mode]
        cfg = tsb.cfg_10m(det_mode)
        torch.cuda.reset_peak_memory_stats(dev)
        fused_topk.launches = 0
        res = tsb.fused_scan(cfg, steps=steps, chunk=chunk, probe_cap=probe,
                             device=dev)
        torch.cuda.synchronize()
        n_launch = fused_topk.launches
        _, _, out, worst_of, worst_ao, used, info = res
        row = tsb.fused_row(tag, cfg, res, smi)
        per_try = len(tsb.schedule(steps, chunk)) * chunk + 1
        probed = (per_try - 1) * (info.probed_cap is not None)
        check_output(out, used, torch)
        line = dict(phase="scale", part="scale_bench", **row,
                    kernel_launches=n_launch,
                    kernel_launches_expected=len(info.tries) * per_try
                    + probed, num_alive=int(out.num_alive),
                    peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
                    seconds=time.perf_counter() - t0)
        emit(line)
        if worst_of or worst_ao or line["num_alive"] != cfg.num_objects \
                or n_launch != line["kernel_launches_expected"]:
            raise AssertionError(f"scale {tag}: {line}")
        launches[mode] += n_launch
        cl = build_cell_list(info.state, used)
        err[mode] = max(err[mode], kernel_at(tag, cl, used, mode, smi,
                                             torch)["max_abs_err"])
        del cl
        # where the step's time goes at 10M: one more step from the last
        # state, under torch.profiler
        step = tt.make_step(used, backend="fused", device=dev)
        gen = torch.Generator(device=dev).manual_seed(100)
        fused_topk.launches = 0
        emit(dict(phase="scale", part="step_profile", config=tag,
                  profile=device_profile(lambda: step(info.state, gen),
                                         SCALE_PROFILE_STEPS, torch),
                  card=smi))
        launches[mode] += fused_topk.launches
        del info, res, out

    # ---- (b) 1M-3D on the one-shard mesh, in turns with the unsharded ----
    cfg1 = tsb.sharded_1m_config()
    steps, chunk = SCALE_SHARDED_STEPS, SCALE_SHARDED_CHUNK
    per_run = len(tsb.schedule(steps, chunk)) * chunk
    rounds = []
    for r in range(SCALE_ROUNDS):
        fused_topk.launches = 0
        res, states, mesh = tsb.sharded_scan(cfg1, steps, chunk, device=dev)
        torch.cuda.synchronize()
        n_sh = fused_topk.launches
        row = tsb.sharded_row(cfg1, res, smi)
        fused_topk.launches = 0
        un = tsb.fused_scan(tsb.cfg_1m(), steps=steps, chunk=chunk,
                            device=dev)
        torch.cuda.synchronize()
        n_un = fused_topk.launches
        rounds.append(dict(sharded=row, sharded_launches=n_sh,
                           unsharded=tsb.fused_row("1m_3d_fast", tsb.cfg_1m(),
                                                   un, smi),
                           unsharded_launches=n_un))
        if not row["conserved"] or row["overflow"] or row["aoflow"] \
                or n_sh != per_run or un[3] or un[4] \
                or n_un != len(un[6].tries) * (per_run + 1):
            raise AssertionError(f"scale 1m_sharded_fused_1dev: "
                                 f"{rounds[-1]}")
        launches["hits"] += n_sh + n_un
    emit(dict(phase="scale", part="sharded_1m", rounds=rounds,
              steps=steps, chunk=chunk, card=smi))
    ext, _ = _halo_extend(states, cfg1, mesh, _default_walls(cfg1, mesh),
                          mark=True)
    cl = build_cell_list(ext[0], cfg1)
    err["hits"] = max(err["hits"], kernel_at(
        "1m_sharded_fused_1dev", cl, cfg1, "hits", smi,
        torch)["max_abs_err"])
    del ext, cl, states

    # ---- (c) the big mesh at 64k: 8x2 and 8x8, both backends ----
    for devices, grid in BIG_MESH_GRIDS:
        for backend in ("xla", "fused"):
            t0 = time.perf_counter()
            cfg = tbm.deployment(BIG_MESH_N,
                                 *(int(v) for v in grid.split("x")))
            _, mesh, st, stepf = parts = tbm.setup(cfg, backend, dev)
            fused_topk.launches = 0
            res = tbm.dryrun(devices, grid, BIG_MESH_N, backend,
                             BIG_MESH_STEPS, device=dev, cfg=cfg,
                             parts=parts)
            torch.cuda.synchronize()
            n_launch = fused_topk.launches
            line = dict(phase="scale", part="big_mesh", **res,
                        kernel_launches=n_launch,
                        seconds=time.perf_counter() - t0, card=smi)
            want = (1 + BIG_MESH_STEPS) * devices * (backend == "fused")
            compared = "alert_set_equal" in res
            if backend == "fused":
                gens = lambda: shard_generators(mesh, 1)
                fused_topk.launches = 0
                line["profile"] = device_profile(lambda: stepf(st, gens()),
                                                 BIG_MESH_PROFILE_STEPS,
                                                 torch)
                n_prof = fused_topk.launches
                launches["hits"] += n_launch + n_prof
                if n_prof != BIG_MESH_PROFILE_STEPS * devices:
                    raise AssertionError(f"big mesh {grid}: {n_prof} "
                                         "launches under the profiler")
            emit(line)
            if n_launch != want or not res["conserved"] \
                    or res["alive"] != BIG_MESH_N or res["overflow"] \
                    or not res["risk_parity"] \
                    or (compared and not res["alert_set_equal"]):
                raise AssertionError(f"big mesh {grid} {backend}: {line}")
            if backend == "fused" and grid == "8x8":
                # an inner shard (no edge of the world), the one with the
                # most halo mirrors
                st1, _, _ = stepf(st, gens())
                ext, _ = _halo_extend(st1, cfg, mesh,
                                      _default_walls(cfg, mesh), mark=True)
                inner = [i for i in range(mesh.size)
                         if all(0 < c < n - 1 for c, n in
                                zip(mesh.coords(i), mesh.shape))]
                lists = {i: build_cell_list(ext[i], cfg) for i in inner}
                s = max(inner, key=lambda i: int(
                    (lists[i].alive & ~lists[i].own).sum()))
                cl = lists[s]
                err["hits"] = max(err["hits"], kernel_at(
                    "64k_8x8_shard", cl, cfg, "hits", smi, torch,
                    shard=list(mesh.coords(s)),
                    mirrors=int((cl.alive & ~cl.own).sum()))["max_abs_err"])
    emit(dict(phase="scale", part="done", launches=launches,
              max_abs_err=err, seconds=time.perf_counter() - t_phase,
              card=smi))
    return dict(launches=launches, max_abs_err=err)


def by_oid_state(host, torch):
    """The alive objects of a collected state in oid order."""
    from tpu_collide_torch.core.state import FIELDS
    alive = torch.nonzero(host.alive).flatten()
    rows = alive[torch.argsort(host.oid[alive])]
    return host.replace(**{f: getattr(host, f)[rows] for f in FIELDS})


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.config import DetectionConfig, WorldConfig
    from tpu_collide_torch.core.device import card
    from tpu_collide_torch.core.state import conform_fleet, state_from_numpy
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
    from tpu_collide_torch.kernels.fused_detect import (
        PLAN_FIELDS, fused_topk, fused_topk_plain,
        launch_plan as detect_plan, predict_topk, predict_topk_plain,
        slot_count)
    from tpu_collide_torch.engine import (_chunked_detect_extract,
                                          detect_and_alerts, make_burst_step)
    from tpu_collide_torch.kernels.block_sort import (MAX_PAYLOADS,
                                                      ceil_pow2, co_sort,
                                                      co_sort_plain,
                                                      kernel_launches,
                                                      launch_plan,
                                                      network_stages)
    from tpu_collide_torch.kernels.refine import fused_predict
    from tpu_collide_torch.kernels.tune import suggest_cell_capacity
    from tpu_collide_torch.sim import generate_fleet
    import numpy as np

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- device ----
    smi = card(dev)
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

    cfg100k, cfg1m = bench_configs()
    mode_of = {"fast": "hits", "precise": "survivors"}
    err = {"hits": 0.0, "survivors": 0.0}

    # the launch plan of the detection kernel as the library makes it and as
    # kernels/fused_detect.launch_plan mirrors it
    plans = {}
    for n, k in ((1, 1), (1000, 8), (6000, 32), (20_000, 8), (33_792, 8),
                 (67_584, 8), (100_000, 8), (100_000, 12), (1_000_000, 4),
                 (10_000_000, 8)):
        out = (ctypes.c_int * 5)()
        _build.load_library().tc_fused_topk_plan(n, k, out)
        want = detect_plan(n, k)
        if list(out)[:4] != [want[f] for f in PLAN_FIELDS]:
            raise AssertionError(f"fused_topk plan at n {n}, k {k}: library "
                                 f"{list(out)}, Python {want}")
        plans[f"n{n}_k{k}"] = dict(want, blocks_per_sm=out[4])
    emit(dict(phase="detect_plan", plans=plans))

    # ---- kernel_vs_plain: small fleets, one cell list each ----
    widths = set()     # lanes per own object of every launch held to plain
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        for det_mode, mode in mode_of.items():
            for fleet, cfg0, cl in detect_fleets(base, det_mode, torch, dev):
                edges = walk_edges(cl)
                widths.add(edges["lanes_per_object"])
                if fleet == "cityskew" and (
                        min(edges["objects_in_edge_cells"].values()) == 0
                        or edges["blocks_across_row_ends"] == 0):
                    raise AssertionError(f"{fleet} {dim}: the fleet does not "
                                         f"reach every edge: {edges}")
                if fleet == "dense" \
                        and edges["longest_candidate_list"] < DENSE_CLUSTER:
                    raise AssertionError(f"{fleet} {dim}: no long candidate "
                                         f"list: {edges}")
                dead = cl.n - int(cl.n_alive)
                if (fleet in ("dead", "alldead")) != (dead > 0):
                    raise AssertionError(f"{fleet} {dim}: {dead} dead")
                for k in (DENSE_K if fleet == "dense"
                          else (slot_count(cfg0, mode),)):
                    cfg = with_slots(cfg0, mode, k)
                    got = fused_topk(cl, cfg, mode)
                    want = fused_topk_plain(cl, cfg, mode)
                    torch.cuda.synchronize()
                    res = compare_slots(got, want, k, torch)
                    most = int(got.emitted.max())
                    if fleet == "dense" and most <= k:
                        raise AssertionError(f"dense {dim}, k {k}: largest "
                                             f"emitted {most}")
                    err[mode] = max(err[mode], res["max_abs_err"])
                    emit(dict(
                        phase="kernel_vs_plain", fleet=f"{fleet}_{dim}",
                        n=cl.n, dead=dead, mode=mode, k=k, **res,
                        largest_emitted=most, **edges,
                        ms=median_ms(lambda: fused_topk(cl, cfg, mode),
                                     torch),
                        plain_ms=median_ms(
                            lambda: fused_topk_plain(cl, cfg, mode), torch,
                            repeats=3), card=smi))

    # ---- probe: head-on pair, 100 m apart closing at 20 m/s ----
    for det_mode in mode_of:
        cfg = tt.SystemConfig(num_objects=2,
                              world=WorldConfig(hi=(200.0, 200.0, 0.0)),
                              detect=DetectionConfig(mode=det_mode))
        st = conform_fleet(state_from_numpy(
            np.array([[0, 0, 0], [100, 0, 0]], np.float32),
            np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
            np.zeros((2, 3), np.float32), np.array([0.0, np.pi]),
            np.full(2, 2.0), np.zeros(2, np.int32), device=dev), cfg)
        got = alert_dict(detect_and_alerts_fused(st, cfg).alerts)
        if set(got) != {(0, 1), (1, 0)} or any(
                abs(v[1] - 4.7) > 1e-5 for v in got.values()):
            raise AssertionError(f"head-on probe: {got}")
        emit(dict(phase="probe", mode=det_mode,
                  ttc=[v[1] for v in got.values()]))

    # ---- main_path ----
    runs = main_path_runs()
    launches = {"hits": 0, "survivors": 0}
    kernel_ms, bounds = {}, {}
    for seed, (name, cfg, dist) in enumerate(runs):
        mode = mode_of[cfg.detect.mode]
        drive = lambda c: fused_steps(c, dist, 100 + seed, torch, dev)
        cfg, worst_ao, res, attempts = certified(cfg, drive)
        state, out, worst_of, ms_per_step, n_launch = res
        launches[mode] += n_launch
        check_output(out, cfg, torch)
        if worst_of != 0 or worst_ao != 0:
            raise AssertionError(
                f"{name}: overflow {worst_of}, alert_overflow {worst_ao} at "
                f"k {slot_count(cfg, mode)}, survivor cap "
                f"{cfg.survivor_cap}, after {attempts} attempts")
        if int(out.num_alive) != cfg.num_objects:
            raise AssertionError(f"{name}: num_alive {int(out.num_alive)}")
        line = dict(
            phase="main_path", config=name, distribution=dist,
            ms_per_step=ms_per_step, steps_timed=REPEATS,
            kernel_launches=n_launch, attempts=attempts,
            max_alerts_per_object=cfg.alerts.max_alerts_per_object,
            survivor_k=cfg.detect.survivor_k, survivor_cap=cfg.survivor_cap,
            num_risks=int(out.num_risks), alerts=int(out.alerts.count),
            num_pairs_checked=int(out.num_pairs_checked),
            max_risk=float(out.max_risk),
            worst_overflow=worst_of, worst_alert_overflow=worst_ao,
            card=smi)

        # the kernel alone at this configuration's shapes, with its plain
        # version on the same cell list
        cl = build_cell_list(state, cfg)
        k = slot_count(cfg, mode)
        widths.add(detect_plan(cl.n, k)["width"])
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

    if widths != {2, 4, 8, 16, 32}:
        raise AssertionError(f"detection kernel held to its plain version "
                             f"at {sorted(widths)} lanes per object only")

    # ---- predict_kernel_vs_plain: 20k fleets, one cell list, all offsets --
    offs = torch.tensor(predict_offsets(HORIZON, PRED_STEP),
                        dtype=torch.float32, device=dev)
    pred_err = 0.0
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        fleets = predict_fleets(base, torch, dev)
        _, cfg, cl = next(fleets)
        pk = lambda: predict_topk(cl, cfg, offs, K_SLOTS, SUB_STEPS)
        pp = lambda: predict_topk_plain(cl, cfg, offs, K_SLOTS, SUB_STEPS)
        got, want = pk(), pp()
        torch.cuda.synchronize()
        res = compare_pred_slots(got, want, K_SLOTS, torch)
        if not res["bit_equal"]:
            raise AssertionError(f"predict kernel, 20k {dim}: not bit-equal")
        pred_err = max(pred_err, res["max_abs_err"])
        emit(dict(phase="predict_kernel_vs_plain",
                  fleet=f"20k_{dim}_cityskew", offsets=offs.numel(),
                  k=K_SLOTS, sub_steps=SUB_STEPS, **res,
                  ms=median_ms(pk, torch),
                  plain_ms=median_ms(pp, torch, repeats=3), card=smi))

        # the dense fleet: long runs, a full ring, evicted slots
        _, cfg, cl = next(fleets)
        edges = predict_edges(cl, cfg, offs, torch)
        if edges["longest_run"] <= 2 * PRED_QUEUE \
                or edges["most_waiting"] <= WARP \
                or all(r % WARP == 0 for r in edges["last_rounds"]):
            raise AssertionError(f"dense {dim}: the fleet does not drive the "
                                 f"kernel's ring: {edges}")
        for k in (1, 8, K_SLOTS):
            got = predict_topk(cl, cfg, offs, k, SUB_STEPS)
            want = predict_topk_plain(cl, cfg, offs, k, SUB_STEPS)
            torch.cuda.synchronize()
            res = compare_pred_slots(got, want, k, torch)
            most = int(got.emitted.max())
            if not res["bit_equal"] or most <= k:
                raise AssertionError(
                    f"dense {dim}, k {k}: bit-equal {res['bit_equal']}, "
                    f"largest emitted {most}")
            pred_err = max(pred_err, res["max_abs_err"])
            emit(dict(phase="predict_kernel_vs_plain", fleet=f"dense_{dim}",
                      n=cl.n, offsets=offs.numel(), k=k,
                      sub_steps=SUB_STEPS, **res, largest_emitted=most,
                      **edges, ms=median_ms(
                          lambda: predict_topk(cl, cfg, offs, k, SUB_STEPS),
                          torch), card=smi))

    # ---- predict_path: bench.py's predict row (bench.py:400-450) ----
    t_phase = time.perf_counter()
    cfg = cfg100k
    state, hist = predict_path_inputs(cfg, torch, dev)
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
    if not res["bit_equal"]:
        raise AssertionError("predict kernel, 100k first and last offset: "
                             "not bit-equal")
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
                kernel_device_ms_first_last=graph_ms(
                    lambda: predict_topk(cl, cfg, ends, K_SLOTS, SUB_STEPS),
                    torch),
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

    # ---- scene: the Scene serving surface ----
    scene_launches = scene_phase(smi, torch, dev)

    # ---- service: the service node over HTTP ----
    service_launches = service_phase(smi, torch, dev)

    # ---- scenario: the device movement modes at 100k ----
    scenario = scenario_phase(smi, torch, dev)
    scenario_launches = scenario["launches"]

    # ---- sharded: the sharded step, 16 shards on the card ----
    sharded = sharded_phase(smi, torch, dev)
    sharded_launches = sharded["launches"]

    # ---- sharded_serving: balance, sharded prediction, ShardedScene ----
    serving_launches = sharded_serving_phase(smi, torch, dev,
                                             sharded["adopted"])

    # ---- bench: the load harness ----
    bench_launches, bench_err = bench_phase(smi, torch, dev)

    # ---- scale: 10M-3D, the one-shard 1M mesh, 64k on 16 and 64 shards --
    scale = scale_phase(smi, torch, dev)

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
    cfg2 = tt.SystemConfig(num_objects=2,
                           world=WorldConfig(hi=(200.0, 200.0, 0.0)))
    st = conform_fleet(state_from_numpy(
        np.array([[0, 0, 0], [100, 0, 0]], np.float32),
        np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
        np.zeros((2, 3), np.float32), np.array([0.0, np.pi]),
        np.full(2, 2.0), np.zeros(2, np.int32), device=dev), cfg2)
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
    bits = lambda x: x.view(torch.int32)
    # lengths around the kernel's tile and past 2^17 and 2^20, keys with
    # many ties, all equal, and with INT32_MAX, without payloads and with
    # the most the kernel takes: bit-equal to the plain version
    edge_cases = 0
    for n in COSORT_EDGE_N:
        for keys in ("cells", "equal", "max"):
            for n_pay in (0, MAX_PAYLOADS):
                ops = cosort_edge_operands(n, keys, n_pay, 500 + edge_cases,
                                           torch, dev)
                got, want = co_sort(ops), co_sort_plain(ops)
                torch.cuda.synchronize()
                if not all(torch.equal(bits(a), bits(b))
                           for a, b in zip(got, want)):
                    raise AssertionError(
                        f"cosort_vs_plain: n {n}, {keys} keys, {n_pay} "
                        "payloads: kernel and plain version differ")
                edge_cases += 1
    launches_per_sort = {n: kernel_launches(n) for n in COSORT_EDGE_N}
    for n, count in launches_per_sort.items():
        if count != len(launch_plan(max(2, ceil_pow2(n)))):
            raise AssertionError(f"co_sort: {count} launches at n {n}, the "
                                 "plan has another number")
    emit(dict(phase="cosort_vs_plain", cases=edge_cases, bit_equal=True,
              lengths=list(COSORT_EDGE_N), keys=["cells", "equal", "max"],
              payloads=[0, MAX_PAYLOADS],
              launches_per_sort=launches_per_sort, card=smi))

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
                  keys_equal_library=True, rows_equal_library=True,
                  launches_per_sort=kernel_launches(n), **line,
                  card=smi))

    # no single PyTorch call computes a per-object top-k over a
    # data-dependent stencil: library_ms is null for the three fused modes
    kernels = [dict(name=f"fused_topk[{mode}]", route="cuda",
                    source="tpu_collide_torch/csrc/fused_detect.cu",
                    replaces="tpu_collide/kernels/fused_detect.py:144",
                    launches=(launches[mode] + scene_launches[mode]
                              + service_launches[mode]
                              + scenario_launches[mode]
                              + sharded_launches[mode]
                              + serving_launches[mode]
                              + bench_launches[mode]
                              + scale["launches"][mode]),
                    launches_by_path=dict(
                        main_path=launches[mode], scene=scene_launches[mode],
                        service=service_launches[mode],
                        scenario=scenario_launches[mode],
                        sharded=sharded_launches[mode],
                        sharded_serving=serving_launches[mode],
                        bench=bench_launches[mode],
                        scale=scale["launches"][mode]),
                    max_abs_err=max(err[mode],
                                    scenario["max_abs_err"][mode],
                                    sharded["max_abs_err"][mode],
                                    bench_err[mode],
                                    scale["max_abs_err"][mode]),
                    ms=kernel_ms[cfg_name][0],
                    plain_ms=kernel_ms[cfg_name][1],
                    bound_ms=bounds[cfg_name]["bound_ms"],
                    bound_by=bounds[cfg_name]["bound_by"], library_ms=None)
               for mode, cfg_name in (("hits", "100k_2d_fast"),
                                      ("survivors", "100k_2d_precise"))]
    kernels.append(dict(name="fused_topk[predict]", route="cuda",
                        source="tpu_collide_torch/csrc/fused_predict.cu",
                        replaces="tpu_collide/kernels/fused_detect.py:553",
                        launches=(n_pred + scene_launches["predict"]
                                  + serving_launches["predict"]),
                        launches_by_path=dict(
                            predict_path=n_pred,
                            scene=scene_launches["predict"],
                            sharded_serving=serving_launches["predict"]),
                        max_abs_err=pred_err,
                        ms=pred_ms[0], plain_ms=pred_ms[1],
                        bound_ms=pred_bound["bound_ms"],
                        bound_by=pred_bound["bound_by"], library_ms=None))
    kernels.append(dict(name="co_sort", route="cuda",
                        source="tpu_collide_torch/csrc/block_sort.cu",
                        replaces=".probe/block_sort.py:158",
                        launches=n_sort,
                        launches_by_path=dict(cosort_vs_plain=n_sort),
                        max_abs_err=0.0,
                        ms=sort_ms["kernel_ms"], plain_ms=sort_ms["plain_ms"],
                        bound_ms=sort_ms["bound_ms"],
                        bound_by=sort_ms["bound_by"],
                        library_ms=sort_ms["library_ms"]))
    for kr in kernels:
        for path, n in kr["launches_by_path"].items():
            if n == 0:
                raise AssertionError(f"{kr['name']} never ran on {path}")
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu", kind=card,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
