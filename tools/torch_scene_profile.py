"""Where the time of a call of the port's Scene goes, on one CUDA card.

    python3 tools/torch_scene_profile.py

For the configurations of chip_smoke.py's scene phase (bench.py's serving
row, 1k precise city skew, on both backends; 100k 2D fast on the fused
backend; Scene.predict at 100k city skew after 4 steps and ticks, k_slots
healed to 16 by a first call), after warm-up calls, one JSON line each:

  * per call on the host clock, median and p95 of 20 calls: the whole call;
    the part the Scene times itself (stats_timing: the step and its one
    device-to-host copy; for predict, the device half engine.make_predict
    and its copy, called alone on the same inputs); the rest (flush,
    self-heal checks, the AlertManager's Python); and the engine's step
    alone (make_step, synchronised) on a copy of the fleet;
  * under torch.profiler over 5 calls: device busy ms per call, the idle
    share of the wall time, device launches per call, and the runtime calls
    per call that synchronise or copy (cudaStreamSynchronize,
    cudaDeviceSynchronize, cudaEventSynchronize, cudaMemcpy*; a
    cudaMemcpyAsync from pageable memory or to the host waits, one into
    pinned memory need not);
  * under cProfile over 10 calls: the 12 functions with the most own time.

Every line carries nvidia-smi's name and power limit.
"""
from __future__ import annotations

import cProfile
import json
import pathlib
import pstats
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

CALLS, PROFILED, CPROFILED = 20, 5, 10


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def stats(ms) -> dict:
    srt = sorted(ms)
    return dict(median=srt[len(srt) // 2], p95=srt[int(0.95 * len(srt))])


def device_profile(torch, fn, n) -> dict:
    """Device busy ms, idle share, launches and synchronising or copying
    runtime calls per call of fn under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy, launches, syncs = 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            busy += ev.time_range.elapsed_us()
            launches += not ev.name.startswith(("Memcpy", "Memset"))
        elif ev.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaMemcpy", "cudaEventSynchronize") \
                or ev.name.startswith("cudaMemcpyAsync"):
            syncs += 1
    if busy == 0.0:
        raise SystemExit("the profiler recorded no device time")
    busy_ms = busy / 1e3 / n
    return dict(wall_ms=wall, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall, launches=launches / n,
                sync_or_copy_calls=syncs / n)


def host_profile(fn, n) -> list:
    """The 12 functions with the most own time over n calls of fn under
    cProfile: (function, own ms per call, calls per call)."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    return [(f"{pathlib.Path(f).name}:{line}:{name}", tt * 1e3 / n, nc / n)
            for (f, line, name), (_, nc, tt, _, _) in rows]


def timed(fn, n) -> list:
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def serving(torch, dev, smi) -> None:
    import tpu_collide_torch as tt
    from tpu_collide_torch.api import Scene
    from tpu_collide_torch.sim import generate_fleet
    runs = {name: cfg for name, cfg, _ in cs.main_path_runs()}
    cells = (("1k_precise_cityskew", "xla", "city_skew", 12),
             ("1k_precise_cityskew", "fused", "city_skew", 12),
             ("100k_2d_fast", "fused", "uniform", 101))
    for name, backend, dist, seed in cells:
        cfg = runs[name]
        fleet = lambda: generate_fleet(
            torch.Generator(device=dev).manual_seed(seed), cfg, dist)
        sc = Scene(cfg, state=fleet(), backend=backend, device=dev)
        for _ in range(2):
            sc.step()
        calls, inside = [], []
        for _ in range(CALLS):
            before = sc.stats_timing["total_ms"]
            t0 = time.perf_counter()
            sc.step()
            calls.append((time.perf_counter() - t0) * 1e3)
            inside.append(sc.stats_timing["total_ms"] - before)
        # the engine's step alone, synchronised after each, on a fleet
        # from the same seed
        step = tt.make_step(sc.cfg, backend=backend, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        box = [fleet()]

        def engine_step():
            box[0], _ = step(box[0], gen)
            torch.cuda.synchronize()

        for _ in range(2):
            engine_step()
        engine = timed(engine_step, CALLS)
        emit(dict(config=name, backend=backend, calls=CALLS,
                  call_ms=stats(calls), step_and_copy_ms=stats(inside),
                  rest_ms=stats([c - i for c, i in zip(calls, inside)]),
                  engine_step_ms=stats(engine),
                  alerts_per_call=int(sc.alert_manager.get_stats()["created"]
                                      + sc.alert_manager.get_stats()
                                      ["updated"]) / (2 + CALLS),
                  profile=device_profile(torch, sc.step, PROFILED),
                  engine_profile=device_profile(torch, engine_step,
                                                PROFILED),
                  cprofile=host_profile(sc.step, CPROFILED), card=smi))


def predict(torch, dev, smi) -> None:
    from tpu_collide_torch.api import Scene
    from tpu_collide_torch.engine import make_predict
    from tpu_collide_torch.core.device import to_host
    from tpu_collide_torch.sim import generate_fleet
    cfg = {name: c for name, c, _ in cs.main_path_runs()}["100k_2d_fast"]
    sc = Scene(cfg, state=generate_fleet(
        torch.Generator(device=dev).manual_seed(5), cfg, "city_skew"),
        backend="fused", device=dev)
    for _ in range(4):
        sc.step()
        sc.record_trajectories()
    for _ in range(2):          # the first call heals k_slots to 16
        sc.predict()
    r_cap = min(cfg.alerts.max_scene_alerts, sc.state.n * 32)
    device_half = lambda: to_host(make_predict(
        sc.cfg, 10.0, 0.5, k_slots=sc._predict_slots, r_cap=r_cap,
        device=sc.device)(sc.state, sc._traj))
    calls = timed(sc.predict, CALLS)
    inside = timed(device_half, CALLS)
    emit(dict(config="100k_2d_cityskew_predict", backend="fused",
              calls=CALLS, k_slots=sc._predict_slots,
              last_predict=sc.last_predict, call_ms=stats(calls),
              device_half_and_copy_ms=stats(inside),
              rest_ms=stats(calls)["median"] - stats(inside)["median"],
              profile=device_profile(torch, sc.predict, PROFILED),
              device_half_profile=device_profile(torch, device_half,
                                                 PROFILED),
              cprofile=host_profile(sc.predict, CPROFILED), card=smi))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_scene_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    serving(torch, dev, smi)
    predict(torch, dev, smi)


if __name__ == "__main__":
    main()
