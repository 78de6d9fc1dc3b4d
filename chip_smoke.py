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

The line before the last lists the kernels with their launches on the main
path and their times; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, torch) -> float:
    """Median over REPEATS runs of fn, each bracketed by CUDA events (after
    one warm-up run)."""
    fn()
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare_slots(got, want, k, torch) -> dict:
    """Kernel slots against plain slots: counters exact; slot sets equal
    and keys within KEY_TOL wherever emitted <= k."""
    if int(got.checked) != int(want.checked):
        raise AssertionError(f"checked {int(got.checked)} != "
                             f"{int(want.checked)}")
    for f in ("emitted", "qual"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{f} differs")
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
    return dict(checked=int(got.checked),
                emitted=int(got.emitted.sum()), qual=int(got.qual.sum()),
                rows_over_k=int((~rows).sum()), max_abs_err=err,
                bit_equal=bool(torch.equal(got.keys, want.keys)
                               and torch.equal(got.idx, want.idx)))


def alert_dict(alerts) -> dict:
    """{(vehicle, other): (risk, ttc, distance, rel_speed, priority)}."""
    v = alerts.valid.cpu()
    cols = [getattr(alerts, f).cpu()[v].tolist()
            for f in ("vehicle_oid", "other_oid", "risk", "ttc", "distance",
                      "rel_speed", "priority")]
    return {(a, b): tuple(rest) for a, b, *rest in zip(*cols)}


def check_output(out, cfg, torch) -> None:
    """The repo's own checks of a step's output: shapes, finite values,
    counters in range."""
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
    if int(out.overflow) != 0 or int(out.alert_overflow) < 0:
        raise AssertionError("certificates out of range")


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
    from tpu_collide_torch.kernels.fused_detect import (fused_topk,
                                                        fused_topk_plain,
                                                        slot_count)
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
    kernel_ms = {}
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
        line.update(kernel=mode, kernel_ms=kernel_ms[name][0],
                    plain_ms=kernel_ms[name][1],
                    kernel_max_abs_err=res["max_abs_err"],
                    kernel_bit_equal=res["bit_equal"])

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

    kernels = [dict(name=f"fused_topk[{mode}]", route="cuda",
                    source="tpu_collide_torch/csrc/fused_detect.cu",
                    replaces="tpu_collide/kernels/fused_detect.py:144",
                    launches=launches[mode], max_abs_err=err[mode],
                    ms=kernel_ms[cfg_name][0],
                    plain_ms=kernel_ms[cfg_name][1])
               for mode, cfg_name in (("hits", "100k_2d_fast"),
                                      ("survivors", "100k_2d_precise"))]
    for kr in kernels:
        if kr["launches"] == 0:
            raise AssertionError(f"{kr['name']} never ran on the main path")
    emit(dict(kernels=kernels))
    emit(dict(ok=True, device=dict(platform="gpu", kind=card,
                                   count=torch.cuda.device_count())))


if __name__ == "__main__":
    main()
