"""The port's detection kernel (fused_topk, modes hits and survivors) on one
CUDA card: versions side by side, how full its lanes run, and a profile of
the fused step.

    python3 tools/torch_detect_kernel.py compare [only=CELLS] NAME=CSRC_DIR [NAME=CSRC_DIR ...]
    python3 tools/torch_detect_kernel.py lanes
    python3 tools/torch_detect_kernel.py profile

compare: every CSRC_DIR is a full copy of tpu_collide_torch/csrc (the
package's own, the parent commit's from `git archive`, a variant of the
source). Each is built into its own library and its tc_fused_topk runs,
through the package's wrapper, on these cell lists: the fleets of
chip_smoke.py's main_path (1k precise city skew; 100k 2D fast, k 8; 100k 2D
precise at survivor_k 12 and 8; 1M 3D fast, k 4), the 20k city-skew fleets
(2D, 3D), the same with dead objects, the dense fleet (2D, 3D; k 16), a 50k
uniform fleet, 5 objects and 100 dead objects, these in both modes.
Per cell list one line: whether each version equals fused_topk_plain bit
for bit (keys, idx, emitted, qual, checked; checked before anything is
timed; exits 1 at the end if a version differs, so that a variant cut down
to find where the time goes can still be timed), then each version's median
time of 10 launches between CUDA events around the wrapper, in turns, first in
the order given and then in reverse, so that a drift of the card shows as a
difference between the two; and the same two orders for 10 launches
replayed from a captured CUDA graph, per launch, which leaves out the
host's share (a measurement only; the port captures no graph). only=CELLS
keeps the cell lists whose name holds CELLS.

Variants that can be made from the package's source with sed, each a copy
of csrc/ with one line of fused_detect.cu changed:

  gN   `int width = WIDTH_MIN;` -> `int width = N; return width;`: N = 1, 2,
       4, 8, 16 or 32 lanes per own object whatever the fleet's size
  u2   `constexpr int UNROLL = 4;` -> 2 candidates a lane and round

lanes: per cell list of `compare`, counted in plain PyTorch from the cell
list: the candidates walked and the pairs within the radius; then, at 2, 4,
8, 16 and 32 lanes per own object, the rounds a warp walks (its objects walk
in step, 4 candidates a lane and round, so a round lasts until the longest
list is done), the share of lanes that hold a candidate, and the least
stage-2 sweeps with the share of lanes they can fill.

profile: the fused step at chip_smoke.py's four main_path configurations
(100k precise at survivor_k 12 and a survivor cap of 400,000, where main_path
certifies it): ms per step between CUDA events, median of 10; then under
torch.profiler over 5 steps the wall and device-busy time per step, idle
share, launches and the detection kernel's device time; and the wrapper
alone: the host's time to enqueue one fused_topk on an idle card and the
time between events around it. It runs on an earlier commit's tree too
(copy this file into its tools/), which is how two commits' steps and
wrappers are compared in one call.

Every line is JSON and carries nvidia-smi's name and power limit.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

MODE_OF = {"fast": "hits", "precise": "survivors"}
UNROLL = 4    # candidates a lane tests per round (csrc/fused_detect.cu)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def library(lib):
    """fused_topk launches `lib`'s kernel inside this block."""
    from tpu_collide_torch.kernels import _build
    own = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = own


def cell_lists(torch, dev):
    """Yields (name, cell list, cfg, mode)."""
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.sim import generate_fleet
    cfg100k, cfg1m = cs.bench_configs()
    for seed, (name, cfg, dist) in enumerate(cs.main_path_runs()):
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        cl = build_cell_list(generate_fleet(gen, cfg, dist), cfg)
        mode = MODE_OF[cfg.detect.mode]
        if name == "100k_2d_precise":
            for k in (12, 8):   # the certified survivor_k and the default
                yield f"{name}_k{k}", cl, cfg.replace(
                    detect=dataclasses.replace(cfg.detect, survivor_k=k)), mode
        else:
            yield name, cl, cfg, mode
    for dim, base in (("2d", cfg100k), ("3d", cfg1m)):
        for det_mode, mode in MODE_OF.items():
            for fleet, cfg, cl in cs.detect_fleets(base, det_mode, torch, dev):
                if fleet == "dense":
                    cfg = cs.with_slots(cfg, mode, 16)
                yield f"{fleet}_{dim}_{mode}", cl, cfg, mode


def compare(specs, torch, dev, smi) -> bool:
    from tpu_collide_torch.kernels import _build
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain)
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
        at = [i for i, ln in enumerate(log) if "fused_topk_kernel" in ln
              and "Compiling entry function" in ln]
        plans = {}
        if hasattr(libs[name], "tc_fused_topk_plan"):
            for n, k in ((1000, 8), (6000, 16), (20_000, 8), (100_000, 8),
                         (1_000_000, 4)):
                out = (ctypes.c_int * 5)()
                libs[name].tc_fused_topk_plan(n, k, out)
                plans[f"n{n}_k{k}"] = dict(zip(
                    ("width", "blocks", "threads", "smem", "blocks_per_sm"),
                    out))
        emit(dict(phase="build", version=name, csrc=path, plans=plans,
                  seconds=time.perf_counter() - t0,
                  ptxas=sorted({ln.strip() for i in at
                                for ln in log[i + 1:i + 4]
                                if "registers" in ln or "stack" in ln})))
    ok = True
    fields = ("keys", "idx", "emitted", "qual", "checked")
    for name, cl, cfg, mode in cell_lists(torch, dev):
        if only not in name:
            continue
        run = lambda: fused_topk(cl, cfg, mode)
        want = fused_topk_plain(cl, cfg, mode)
        k = want.keys.shape[1]
        line = dict(phase="compare", cells=name, n=cl.n, mode=mode, k=k,
                    emitted=int(want.emitted.sum()),
                    rows_over_k=int((want.emitted > k).sum()), card=smi)
        for version, lib in libs.items():
            with library(lib):
                got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(getattr(got, f), getattr(want, f))
                       for f in fields)
            ok &= same
            line[f"{version}_bit_equal"] = same
        for tag, order in (("", list(libs)), ("_reversed", list(libs)[::-1])):
            for version in order:
                with library(libs[version]):
                    line[f"{version}_ms{tag}"] = cs.median_ms(run, torch)
            for version in order:
                with library(libs[version]):
                    line[f"{version}_graph_ms{tag}"] = cs.graph_ms(
                        run, torch)
        emit(line)
    return ok


def lanes(torch, dev, smi) -> None:
    from tpu_collide_torch.kernels.cell_list import stencil_runs
    from tpu_collide_torch.kernels.fused_detect import _pair_chunks
    for name, cl, cfg, mode in cell_lists(torch, dev):
        if mode != "hits" and "precise" not in name:
            continue    # one line per cell list
        rows = torch.arange(cl.n, device=dev)
        start, end = stencil_runs(cl, rows)
        cand = (end - start).sum(dim=1)
        passed = torch.zeros(cl.n, dtype=torch.int64, device=dev)
        r2 = cfg.detect.search_radius ** 2
        for own, c in _pair_chunks(cl, rows):
            d = cl.fields[c, 0:3] - cl.fields[own, 0:3]
            if not cl.is3d:
                d = d[:, :2]
            ok = (own != c) & ((d * d).sum(dim=1) <= r2)
            passed += torch.bincount(own[ok], minlength=cl.n)
        line = dict(phase="lanes", cells=name, n=cl.n,
                    walked=int(cand.sum()), within_radius=int(passed.sum()),
                    card=smi)
        for width in (2, 4, 8, 16, 32):
            per, step = 32 // width, width * UNROLL
            pad = (-cl.n) % per
            # a warp's objects walk in step: its rounds are its longest's
            c = torch.nn.functional.pad(cand, (0, pad)).view(-1, per)
            p = torch.nn.functional.pad(passed, (0, pad)).view(-1, per)
            rounds = ((c + step - 1) // step).max(dim=1).values
            sweeps = ((p + width - 1) // width).max(dim=1).values
            line[f"g{width}"] = dict(
                walk_rounds=int(rounds.sum()),
                walk_lane_share=int(cand.sum())
                / max(1, 32 * UNROLL * int(rounds.sum())),
                sweeps_at_least=int(sweeps.sum()),
                sweep_lane_share_at_most=int(passed.sum())
                / max(1, 32 * int(sweeps.sum())))
        emit(line)


def profile(torch, dev, smi) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    import tpu_collide_torch as tt
    from tpu_collide_torch.kernels.cell_list import build_cell_list
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    from tpu_collide_torch.sim import generate_fleet
    steps = 5
    for seed, (name, cfg, dist) in enumerate(cs.main_path_runs()):
        mode = MODE_OF[cfg.detect.mode]
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        if name == "100k_2d_precise":
            # the point at which main_path certifies this cell
            cfg = cfg.replace(detect=dataclasses.replace(
                cfg.detect, survivor_k=12, precise_survivor_cap=400_000))
        state = generate_fleet(gen, cfg, dist)
        step = tt.make_step(cfg, backend="fused", device=dev)
        for _ in range(3):
            state, out = step(state, gen)
        torch.cuda.synchronize()
        # ms per step as main_path takes it: CUDA events, median of 10
        events = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            state, out = step(state, gen)
            b.record()
            events.append((a, b))
        torch.cuda.synchronize()
        ms_per_step = sorted(a.elapsed_time(b) for a, b in events)[5]
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                state, out = step(state, gen)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        busy = kernel_us = 0.0
        launches = kernel_launches = 0
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                us = ev.time_range.elapsed_us()
                busy += us
                launches += not ev.name.startswith(("Memcpy", "Memset"))
                if "fused_topk_kernel" in ev.name:
                    kernel_us += us
                    kernel_launches += 1
        if busy == 0.0:
            raise SystemExit("the profiler recorded no device time")
        # the wrapper alone: the host's time to enqueue one launch on an
        # idle card, and the time between events around it
        cl = build_cell_list(state, cfg)
        for _ in range(3):
            fused_topk(cl, cfg, mode)
        torch.cuda.synchronize()
        enqueue = []
        for _ in range(20):
            t0 = time.perf_counter()
            fused_topk(cl, cfg, mode)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        emit(dict(phase="profile", config=name, mode=mode, steps=steps,
                  survivor_k=cfg.detect.survivor_k, ms_per_step=ms_per_step,
                  worst_alert_overflow=int(out.alert_overflow),
                  wall_ms_per_step=wall,
                  device_busy_ms_per_step=busy / 1e3 / steps,
                  idle_share=1.0 - busy / 1e3 / steps / wall,
                  launches_per_step=launches / steps,
                  fused_topk_launches_per_step=kernel_launches / steps,
                  fused_topk_device_us=kernel_us / max(1, kernel_launches),
                  host_enqueue_ms=sorted(enqueue)[len(enqueue) // 2],
                  event_ms=cs.median_ms(lambda: fused_topk(cl, cfg, mode),
                                        torch), card=smi))


def main() -> None:
    import torch
    commands = ("compare", "lanes", "profile")
    if len(sys.argv) < 2 or sys.argv[1] not in commands \
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
    if sys.argv[1] == "lanes":
        lanes(torch, dev, smi)
    elif sys.argv[1] == "profile":
        profile(torch, dev, smi)
    elif not compare(sys.argv[2:], torch, dev, smi):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
