"""The port's co-sort kernel on one CUDA card: versions side by side.

    python3 tools/torch_cosort_kernel.py compare NAME=CSRC_DIR [NAME=CSRC_DIR ...]
    python3 tools/torch_cosort_kernel.py profile

Every CSRC_DIR is a full copy of tpu_collide_torch/csrc (the package's own,
an earlier commit's from `git archive`, a variant of the source). Each is
built into its own library and its tc_co_sort runs on the operands of
chip_smoke.py's cosort_vs_plain: the cell-list build's operands of the
1M-object 3D fleet (14 operands) and of the 100k-object 2D fleet (11).
Per fleet one line:

  * whether each version equals co_sort_plain bit for bit (checked before
    anything is timed; exits 1 if one differs), and the launches it makes
    per sort where its library can say;
  * each version's median time of 10 sorts (CUDA events) taken in turns,
    first in the order given and then in reverse, with torch.sort plus one
    gather per payload (chip_smoke.library_sort) as one more entry, so that
    a drift of the card shows as a difference between the two orders;
  * once each, after that: every version on the key alone (the network
    without the payload gather), torch.sort of the key alone, and the
    gathers alone (every payload indexed by a ready permutation).

Variants that can be made from the package's source with sed, each a copy
of csrc/ with one line of block_sort.cu changed:

  tile13   `constexpr int TB = 12;` -> 13: tiles of 8192 pairs, 512
           threads, 64 KB of dynamic shared memory
  tile14   TB -> 14 and `constexpr int EB = 4;` -> 5: tiles of 16384 pairs,
           32 pairs a thread, 128 KB
  noswz    `return slot ^ (((slot >> EB) & 7) << 1);` -> `return slot;`:
           the shared-memory tile without the XOR swizzle

profile: torch.profiler over 20 sorts of the package's kernel on each of
the two fleets' operands: the host's time to enqueue one sort (no wait for
the card), the sort's time between CUDA events, and under the profiler the
host's wall time per sort, the device time
per sort summed over the kernels and for each kernel (launches, mean and
total), so that the share of a sort in which the card waits for the host's
launches shows; the device time of torch.sort plus gathers, taken the
same way; and both replayed from a captured CUDA graph, which leaves out
the host's share.

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
    """co_sort launches `lib`'s kernel inside this block."""
    from tpu_collide_torch.kernels import _build
    own = _build.load_library
    _build.load_library = lambda: lib
    try:
        yield
    finally:
        _build.load_library = own


def compare(specs, torch, dev, smi) -> bool:
    from tpu_collide_torch.kernels import _build
    from tpu_collide_torch.kernels.block_sort import (ceil_pow2, co_sort,
                                                      co_sort_plain)
    from tpu_collide_torch.sim import generate_fleet
    libs = {}
    for spec in specs:
        name, _, path = spec.partition("=")
        csrc = Path(path).resolve()
        t0 = time.perf_counter()
        libs[name] = _build.open_library(csrc)
        log = _build.build_log(csrc).splitlines()
        at = [i for i, ln in enumerate(log)
              if "Compiling entry function" in ln
              and ("cosort" in ln or "bitonic" in ln)]
        emit(dict(phase="build", version=name, csrc=path,
                  seconds=time.perf_counter() - t0,
                  ptxas=[ln.strip() for i in at for ln in log[i:i + 4]
                         if "registers" in ln or "stack" in ln]))
    ok = True
    cfg100k, cfg1m = cs.bench_configs()
    for seed, (name, cfg) in enumerate((("1m_3d_uniform", cfg1m),
                                        ("100k_2d_uniform", cfg100k))):
        gen = torch.Generator(device=dev).manual_seed(400 + seed)
        ops = cs.cosort_operands(generate_fleet(gen, cfg, "uniform"), cfg,
                                 torch)
        want = co_sort_plain(ops)
        bits = lambda x: x.view(torch.int32)
        n = ops[0].numel()
        line = dict(phase="compare", operands=name, n=n,
                    n_operands=len(ops), card=smi)
        for version, lib in libs.items():
            with library(lib):
                got = co_sort(ops)
            torch.cuda.synchronize()
            same = all(torch.equal(bits(a), bits(b))
                       for a, b in zip(got, want))
            ok &= same
            line[f"{version}_bit_equal"] = same
            if hasattr(lib, "tc_co_sort_launches"):
                line[f"{version}_launches"] = lib.tc_co_sort_launches(
                    max(2, ceil_pow2(n)))
        if not ok:
            emit(line)
            continue
        runs = {v: (lambda lib=lib: co_sort(ops)) for v, lib in libs.items()}
        runs["library_sort"] = lambda: cs.library_sort(ops, torch)

        def timed(version, run):
            with library(libs.get(version)) if version in libs \
                    else contextlib.nullcontext():
                return cs.median_ms(run, torch)

        for tag, order in (("ms", list(runs)),
                           ("ms_reversed", list(runs)[::-1])):
            for version in order:
                line[f"{version}_{tag}"] = timed(version, runs[version])
        # the network without the gather, and the gathers alone
        for version in libs:
            line[f"{version}_key_only_ms"] = timed(
                version, lambda: co_sort(ops[:1]))
        line["library_sort_key_only_ms"] = cs.median_ms(
            lambda: torch.sort(ops[0]), torch)
        perm = torch.sort(ops[0]).indices
        line["library_gathers_only_ms"] = cs.median_ms(
            lambda: [x[perm] for x in ops[1:]], torch)
        emit(line)
    return ok


def profile(torch, dev, smi) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from tpu_collide_torch.kernels.block_sort import co_sort
    from tpu_collide_torch.sim import generate_fleet
    cfg100k, cfg1m = cs.bench_configs()
    sorts = 20
    for seed, (name, cfg) in enumerate((("1m_3d_uniform", cfg1m),
                                        ("100k_2d_uniform", cfg100k))):
        gen = torch.Generator(device=dev).manual_seed(400 + seed)
        ops = cs.cosort_operands(generate_fleet(gen, cfg, "uniform"), cfg,
                                 torch)
        for _ in range(3):
            co_sort(ops)
        torch.cuda.synchronize()
        # the host's time to set up and enqueue one sort on an idle card
        enqueue = []
        for _ in range(sorts):
            t0 = time.perf_counter()
            co_sort(ops)
            enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(sorts):
                co_sort(ops)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / sorts
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                us = ev.time_range.elapsed_us()
                at = ev.name.find("cosort_")
                short = ev.name[at:].split("(")[0] if at >= 0 else ev.name
                cnt, tot = by_name.get(short, (0, 0.0))
                by_name[short] = (cnt + 1, tot + us)
        busy = sum(tot for _, tot in by_name.values())
        if busy == 0.0:
            raise SystemExit("the profiler recorded no device time")
        # the yardstick's device time, the same way
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(sorts):
                cs.library_sort(ops, torch)
                torch.cuda.synchronize()
        lib_busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA)
        # both replayed from a CUDA graph: the time without the host's
        # set-up and launches (a measurement only; the port captures none)
        replay = {}
        for tag, fn in (("kernel", lambda: co_sort(ops)),
                        ("library", lambda: cs.library_sort(ops, torch))):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                kept = fn()
            replay[f"{tag}_graph_replay_ms"] = cs.median_ms(graph.replay,
                                                            torch)
            del kept, graph
        emit(dict(phase="profile", operands=name, n=ops[0].numel(), **replay,
                  n_operands=len(ops), sorts=sorts,
                  host_enqueue_ms=sorted(enqueue)[sorts // 2],
                  event_ms=cs.median_ms(lambda: co_sort(ops), torch),
                  wall_ms_per_sort=wall,
                  device_ms_per_sort=busy / 1e3 / sorts,
                  library_device_ms_per_sort=lib_busy / 1e3 / sorts,
                  library_event_ms=cs.median_ms(
                      lambda: cs.library_sort(ops, torch), torch),
                  kernels={k: dict(launches_per_sort=c / sorts,
                                   mean_us=tot / c,
                                   ms_per_sort=tot / 1e3 / sorts)
                           for k, (c, tot) in by_name.items()}, card=smi))


def main() -> None:
    import torch
    if len(sys.argv) < 2 or sys.argv[1] not in ("compare", "profile") \
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
    elif not compare(sys.argv[2:], torch, dev, smi):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
