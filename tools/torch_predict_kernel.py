"""The port's predict kernel on one CUDA card: versions side by side, and a
profile of the predict call.

    python3 tools/torch_predict_kernel.py compare [only=CELLS] NAME=CSRC_DIR [NAME=CSRC_DIR ...]
    python3 tools/torch_predict_kernel.py profile
    python3 tools/torch_predict_kernel.py lanes
    python3 tools/torch_predict_kernel.py samples

compare: every CSRC_DIR is a full copy of tpu_collide_torch/csrc (the
package's own, the parent commit's from `git archive`, an intermediate
state of the source). Each is built into its own library and its
tc_fused_predict runs on the same cell lists as chip_smoke.py's predict
phases: the 20k city-skew fleets (2D, 3D; 20 offsets), the dense fleet
(2D, 3D; k = 1, 8, 16) and the 100k city-skew fleet of predict_path (first
and last offset, and all 20). Per cell list one line: whether each version
equals the plain version bit for bit (20 offsets at 100k are not compared,
the plain version takes too long), and its median time of 10 launches taken
in turns, first in the order given and then in reverse, so that a drift of
the card shows as a difference between the two. only=CELLS keeps the cell
lists whose name holds CELLS. Exits 1 if a version differs. The steps of
the kernel's design are such copies: without the comparisons on squared
distances (sqrtf(q2) <= q.radius at stage 1; d = sqrtf(dd2), d <= safe,
d_hit = d in the sweep), and besides that without the ring (the sweep
called at once, `if (__any_sync(FULL, pass)) sweep(pass, j)`, on the lanes
that passed).

profile: torch.profiler over 3 calls of engine.make_predict's call at
predict_path's configuration (100k city skew, horizon 10 s at 0.5 s,
k_slots 16): wall and device-busy time per call, idle share, launches,
host waits, and the largest device items.

lanes: how full the kernel's warps run at predict_path's configuration, all
20 offsets, counted in plain PyTorch from the cell list: the (offset, row)
warps, the candidates they walk and the 32-wide loads that takes, the pairs
within the radius and the sweep rounds that takes (a round of 32 whenever 32
wait, one more for the rest), and the share of lanes that hold a candidate
in each.

samples: the package's kernel on the same cell list and offsets at
sub_steps = 0, 1, 2, 5, 10 and 20 (sub_steps only sets the length of the
sweep's loop, so the time is a line in it: the intercept is the walk, the
set-up and the prologue, the slope one sample of every pair within the
radius), and the SM clock nvidia-smi reads while the kernel runs.

Every line is JSON and carries nvidia-smi's name and power limit.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def library(lib):
    """predict_topk launches `lib`'s kernel inside this block."""
    from tpu_collide_torch.kernels import _build
    own = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = own


def cell_lists(torch, dev):
    """Yields (name, cell list, cfg, offsets, k, compare with plain)."""
    from tpu_collide_torch.detect.predict import (classify_trajectories,
                                                  predict_offsets)
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    offs = torch.tensor(predict_offsets(cs.HORIZON, cs.PRED_STEP),
                        dtype=torch.float32, device=dev)
    cfg100k, cfg1m = cs.bench_configs()
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        for fleet, cfg, cl in cs.predict_fleets(base, torch, dev):
            for k in ((1, 8, cs.K_SLOTS) if fleet == "dense"
                      else (cs.K_SLOTS,)):
                yield f"{fleet}_{dim}_k{k}", cl, cfg, offs, k, True
    state, hist = cs.predict_path_inputs(cfg100k, torch, dev)
    cl = build_cell_list(state, cfg100k, cls=classify_trajectories(hist))
    yield ("100k_2d_cityskew_first_last", cl, cfg100k,
           offs[[0, -1]].contiguous(), cs.K_SLOTS, True)
    yield "100k_2d_cityskew_20_offsets", cl, cfg100k, offs, cs.K_SLOTS, False


def compare(specs, torch, dev, smi) -> bool:
    from tpu_collide_torch.kernels import _build
    from tpu_collide_torch.kernels.fused_detect import (predict_topk,
                                                        predict_topk_plain)
    libs, only = {}, ""
    for spec in specs:
        name, _, path = spec.partition("=")
        if name == "only":
            only = path
            continue
        csrc = Path(path).resolve()
        t0 = time.perf_counter()
        libs[name] = _build.open_library(csrc)
        log = _build.build_log(csrc).splitlines()
        at = [i for i, ln in enumerate(log) if "fused_predict_kernel" in ln]
        emit(dict(phase="build", version=name, csrc=path,
                  seconds=time.perf_counter() - t0,
                  ptxas=[ln.strip() for i in at for ln in log[i + 1:i + 4]
                         if "registers" in ln or "stack" in ln]))
    ok = True
    for name, cl, cfg, offs, k, check in cell_lists(torch, dev):
        if only not in name:
            continue
        run = lambda: predict_topk(cl, cfg, offs, k, cs.SUB_STEPS)
        want = predict_topk_plain(cl, cfg, offs, k, cs.SUB_STEPS) \
            if check else None
        line = dict(phase="compare", cells=name, n=cl.n,
                    offsets=offs.numel(), k=k, card=smi)
        for version, lib in libs.items():
            with library(lib):
                got = run()
            torch.cuda.synchronize()
            if check:
                same = all(torch.equal(getattr(got, f), getattr(want, f))
                           for f in ("keys", "idx", "emitted"))
                ok &= same
                line[f"{version}_bit_equal"] = same
            line["emitted"] = int(got.emitted.sum())
        for tag, order in (("ms", list(libs)), ("ms_reversed",
                                                list(libs)[::-1])):
            for version in order:
                with library(libs[version]):
                    line[f"{version}_{tag}"] = cs.median_ms(run, torch)
        emit(line)
    return ok


def profile(torch, dev, smi) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from tpu_collide_torch.engine import make_predict
    cfg = cs.bench_configs()[0]
    state, hist = cs.predict_path_inputs(cfg, torch, dev)
    calls = 3
    run = lambda: make_predict(cfg, cs.HORIZON, cs.PRED_STEP,
                               k_slots=cs.K_SLOTS, r_cap=1024,
                               device=dev)(state, hist)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    by_name, launches, waits, busy = {}, 0, 0, 0.0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            busy += us
            name = ev.name[:80]
            by_name[name] = by_name.get(name, 0.0) + us
            launches += not ev.name.startswith(("Memcpy", "Memset"))
        elif ev.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaEventSynchronize"):
            waits += 1
    if busy == 0.0:
        raise SystemExit("the profiler recorded no device time")
    busy_ms = busy / 1e3 / calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(dict(phase="profile", config="100k_2d_cityskew_predict",
              calls=calls, wall_ms_per_call=wall,
              device_busy_ms_per_call=busy_ms,
              idle_share=1.0 - busy_ms / wall,
              launches_per_call=launches / calls,
              host_waits_per_call=(waits - 1) / calls,
              largest_ms_per_call={name: us / 1e3 / calls
                                   for name, us in top}, card=smi))


def lanes(torch, dev, smi) -> None:
    from tpu_collide_torch.detect.predict import (class_advance,
                                                  classify_trajectories,
                                                  predict_offsets)
    from tpu_collide_torch.kernels.cell_list import (FI, build_cell_list,
                                                     flat_cells, stencil_runs)
    from tpu_collide_torch.kernels.fused_detect import _pair_chunks
    cfg = cs.bench_configs()[0]
    state, hist = cs.predict_path_inputs(cfg, torch, dev)
    cl = build_cell_list(state, cfg, cls=classify_trajectories(hist))
    offs = torch.tensor(predict_offsets(cs.HORIZON, cs.PRED_STEP),
                        dtype=torch.float32, device=dev)
    fl = cl.fields
    rows = torch.arange(cl.n, device=dev)
    r2 = cfg.detect.search_radius ** 2
    walked = loads = inside = rounds = warps = idle = 0
    for o in range(offs.numel()):
        pred = class_advance(fl[:, 0:3], fl[:, 3:6], fl[:, 6:9],
                             fl[:, FI["cls"]], offs[o])
        cells = flat_cells(pred, cl.alive, cfg)
        start, end = stencil_runs(cl, rows, cells)
        walked += int((end - start).sum())
        loads += int(((end - start + cs.WARP - 1) // cs.WARP).sum())
        passed = torch.zeros(cl.n, dtype=torch.int64, device=dev)
        for own, cand in _pair_chunks(cl, rows, cells):
            ok = (own != cand) & (
                ((fl[cand, 0:3] - pred[own]) ** 2).sum(dim=1) <= r2)
            passed += torch.bincount(own[ok], minlength=cl.n)
        inside += int(passed.sum())
        rounds += int(((passed + cs.WARP - 1) // cs.WARP).sum())
        warps += cl.n
        idle += int((passed == 0).sum())
    emit(dict(phase="lanes", config="100k_2d_cityskew_predict",
              offsets=offs.numel(), warps=warps, warps_without_a_pair=idle,
              walked=walked, walk_loads=loads,
              walk_lane_share=walked / (cs.WARP * loads),
              within_radius=inside, sweep_rounds=rounds,
              sweep_lane_share=inside / (cs.WARP * rounds), card=smi))


def samples(torch, dev, smi) -> None:
    from tpu_collide_torch.detect.predict import (classify_trajectories,
                                                  predict_offsets)
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import predict_topk
    cfg = cs.bench_configs()[0]
    state, hist = cs.predict_path_inputs(cfg, torch, dev)
    cl = build_cell_list(state, cfg, cls=classify_trajectories(hist))
    offs = torch.tensor(predict_offsets(cs.HORIZON, cs.PRED_STEP),
                        dtype=torch.float32, device=dev)
    ms = {}
    for sub in (0, 1, 2, 5, 10, 20, 10, 5, 2, 1, 0):
        ms.setdefault(sub, []).append(cs.median_ms(
            lambda: predict_topk(cl, cfg, offs, cs.K_SLOTS, sub), torch))
    for _ in range(100):
        predict_topk(cl, cfg, offs, cs.K_SLOTS, cs.SUB_STEPS)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    emit(dict(phase="samples", config="100k_2d_cityskew_predict",
              offsets=offs.numel(), k=cs.K_SLOTS,
              ms_by_sub_steps={str(k): v for k, v in ms.items()},
              clock_under_load=clock, card=smi))


def main() -> None:
    import torch
    if len(sys.argv) < 2 or sys.argv[1] not in ("compare", "profile", "lanes", "samples") \
            or (sys.argv[1] == "compare" and len(sys.argv) < 3):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    if sys.argv[1] == "profile":
        profile(torch, dev, smi)
    elif sys.argv[1] == "lanes":
        lanes(torch, dev, smi)
    elif sys.argv[1] == "samples":
        samples(torch, dev, smi)
    elif not compare(sys.argv[2:], torch, dev, smi):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
