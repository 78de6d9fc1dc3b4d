"""The port's load harness (tpu_collide_torch/bench/) on the CPU: the cases
of tests/test_bench_tools.py on the port's Scene and stdlib server (the
profile case asserts that the trace was written); the step-loop tester
against the JAX package's steps from the same fleet on both backends; its
metrics, percentiles and artifacts against the JAX tester's; the
orchestrated run against the JAX one; the entry points refuse to run
without a card unless given the CPU.

Fleets come from the JAX harness's own generator (key 0) through numpy,
and accel_change_prob is 0, so both integrators take the same steps
whatever their generators draw."""
import dataclasses
import glob
import inspect
import json
import os
import re
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.bench import harness as jax_harness
from tpu_collide.bench import run_benchmark as jax_run_benchmark
from tpu_collide.core.config import DetectionConfig, SimConfig
from tpu_collide.sim import generate_fleet as jax_generate_fleet
import tpu_collide_torch as tt
from tpu_collide_torch.api import Scene
from tpu_collide_torch.api.stdlib_server import SceneHTTPServer
from tpu_collide_torch.bench import harness, run_benchmark
from tpu_collide_torch.bench.harness import PerformanceTester, _percentile
from tpu_collide_torch.bench.load_generator import (LoadGenerator,
                                                    FailureInjector,
                                                    PerformanceAnalyzer,
                                                    save_latency_charts)
from tpu_collide_torch.bench.monitor import PerformanceMonitor
from tpu_collide_torch.core.config import WorldConfig
from tpu_collide_torch.core.state import FIELDS, from_jax_numpy
from tests.torch_parity import to_torch_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harness's own configuration (its CLI's: the default 10 km world, city
# skew, precise) at a test size, with deterministic physics
PARITY_N = 400


def small_scene():
    cfg = tt.SystemConfig(num_objects=64,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    return Scene(cfg, device="cpu")


# ---- the cases of tests/test_bench_tools.py ------------------------------

def test_kafka_redis_targets_are_gated():
    for ttype in ("kafka", "redis"):
        with pytest.raises(ImportError, match="not installed"):
            LoadGenerator(target_type=ttype)


def test_scene_target_load_test():
    gen = LoadGenerator(scene=small_scene())
    res = gen.run_load_test(target_tps=200, duration=0.5, num_vehicles=32)
    assert res.requests > 10 and res.errors == 0
    assert res.error_rate == 0.0


def test_failure_injector_client_roundtrip():
    """Every reference fault type against the port's stdlib server; the
    object loss kills half of the fleet the ingests made alive."""
    sc = small_scene()
    gen = LoadGenerator(scene=sc)
    gen.run_load_test(target_tps=200, duration=0.2, num_vehicles=20)
    sc.flush()
    srv = SceneHTTPServer(sc, port=0)
    port = srv.start()
    try:
        inj = FailureInjector(f"http://127.0.0.1:{port}")
        assert inj.inject_node_failure("n1")["success"]
        assert inj.inject_network_partition(["n2"])["success"]
        assert inj.inject_high_load(duration=1)["success"]
        assert inj.inject_slow_response(latency=50, duration=1)["success"]
        assert inj.reset_failures()["success"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=10) as r:
            before = json.loads(r.read())["data"]["num_alive"]
        assert before == 20
        killed = inj.inject_object_loss(0.5)["data"]["killed"]
        assert killed == before // 2
    finally:
        srv.stop()


def test_chart_artifacts(tmp_path):
    pytest.importorskip("matplotlib")
    lats = [float(5 + (i % 7)) for i in range(300)]
    base = str(tmp_path / "run1")
    paths = save_latency_charts(lats, base)
    assert len(paths) == 2
    for p in paths:
        assert os.path.getsize(p) > 5_000
    cpath = PerformanceAnalyzer.comparison_chart(
        {"baseline": lats, "card": [x / 10 for x in lats]},
        str(tmp_path / "cmp.png"))
    assert cpath and os.path.getsize(cpath) > 5_000
    mon = PerformanceMonitor(target=None, interval=0.01,
                             output_dir=str(tmp_path))
    for _ in range(5):
        mon.sample_once()
    csv = mon.save()
    pngs = [f for f in os.listdir(tmp_path) if f.endswith(".png")
            and f.startswith("monitor_")]
    assert os.path.exists(csv) and pngs


def test_load_generator_save_results_includes_charts(tmp_path):
    pytest.importorskip("matplotlib")
    gen = LoadGenerator(scene=small_scene())
    res = gen.run_load_test(target_tps=200, duration=0.3, num_vehicles=16)
    base = gen.save_results(res, output_dir=str(tmp_path))
    assert os.path.exists(base + "_latencies.csv")
    assert os.path.exists(base + "_summary.json")
    assert os.path.exists(base + "_latency_hist.png")


def test_harness_profile_dir(tmp_path):
    """run_test(profile_dir=...) writes a torch.profiler Chrome trace of
    the measured window, with the step's operators in it."""
    cfg = tt.SystemConfig(num_objects=64,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    t = PerformanceTester(cfg, output_dir=str(tmp_path / "out"),
                          device="cpu")
    t.run_test(50, 0.5, save=False, profile_dir=str(tmp_path / "prof"))
    assert t.request_count > 0
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::sort" in names or "aten::argsort" in names


# ---- the step loop against the JAX package's steps ------------------------

@pytest.fixture(scope="module")
def harness_fleet():
    """(JAX config, the port's config, the JAX harness's fleet as numpy):
    generate_fleet(jax.random.key(0), cfg, 'city_skew') as
    tpu_collide/bench/harness.py:110-111 makes it."""
    jcfg = tc.SystemConfig(num_objects=PARITY_N,
                           detect=DetectionConfig(mode="precise"),
                           sim=SimConfig(accel_change_prob=0.0))
    fleet = jax_generate_fleet(jax.random.key(0), jcfg,
                               distribution="city_skew")
    return jcfg, to_torch_cfg(jcfg), {f: np.asarray(getattr(fleet, f))
                                      for f in FIELDS}


def _jax_steps(jcfg, fleet, n):
    """The JAX harness's schedule on the JAX package's make_step: the
    warm-up step on key 1, then n steps on keys 2, 3, ...; per step
    (num_risks, overflow, alert_overflow, alert count)."""
    from tpu_collide.core.state import state_from_numpy
    state = state_from_numpy(fleet["pos"], fleet["vel"], fleet["acc"],
                             fleet["heading"], fleet["size"], fleet["otype"],
                             oid=fleet["oid"], alive=fleet["alive"])
    stepf = tc.make_step(jcfg, donate=False)
    state, _ = stepf(state, jax.random.key(1))
    rows = []
    for i in range(n):
        state, out = stepf(state, jax.random.key(2 + i))
        rows.append(tuple(int(np.asarray(x)) for x in (
            out.num_risks, out.overflow, out.alert_overflow,
            out.alerts.count)))
    return rows


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_total_risks_equal_the_jax_steps(backend, harness_fleet,
                                         monkeypatch):
    """run_test on the JAX harness's fleet: its total_risks is the sum of
    num_risks of the same number of JAX make_step steps after the warm-up,
    exactly, on both backends (fused: the detection kernel's plain version
    on the CPU). Every step of both sides has certificates 0 and fewer
    alerts than the scene budget, so the counts are comparable."""
    jcfg, tcfg, fleet = harness_fleet
    seeds = []

    def fleet_of_jax(generator, cfg, distribution):
        seeds.append(generator.initial_seed())
        assert (cfg, distribution) == (tcfg, "city_skew")
        return from_jax_numpy(fleet, device="cpu")

    outs = []
    real_make_step = harness.make_step

    def recording(cfg, **kw):
        stepf = real_make_step(cfg, **kw)

        def step(state, generator):
            seeds.append(generator.initial_seed())
            state, out = stepf(state, generator)
            outs.append(out)
            return state, out
        return step

    monkeypatch.setattr(harness, "generate_fleet", fleet_of_jax)
    monkeypatch.setattr(harness, "make_step", recording)
    t = PerformanceTester(tcfg, backend=backend, device="cpu")
    t.run_test(0, 0.5, save=False)
    n = t.request_count
    assert n >= 5 and t.error_count == 0 and len(outs) == n + 1
    assert seeds == list(range(n + 2))       # fleet 0, warm-up 1, then 2+i
    port = [tuple(int(x) for x in (o.num_risks, o.overflow,
                                   o.alert_overflow, o.alerts.count))
            for o in outs[1:]]
    want = _jax_steps(jcfg, fleet, n)
    budget = tcfg.alerts.max_scene_alerts
    for rows in (port, want):
        assert all(of == 0 and ao == 0 and cnt < budget
                   for _, of, ao, cnt in rows)
    assert [r[0] for r in port] == [r[0] for r in want]
    assert t.total_risks == sum(r[0] for r in want) > 0


# ---- metrics and artifacts against the JAX tester -------------------------

def _filled(tester, lat):
    """The tester as a run of `lat` would leave it."""
    tester.latencies = list(lat)
    tester.request_count = len(lat)
    tester.error_count = 3
    tester.total_risks = 1234
    tester.start_time, tester.end_time = 10.0, 12.5
    tester.metrics_history = [tester._calculate_metrics() for _ in range(4)]
    return tester


def _latencies():
    return list(np.random.default_rng(3).gamma(2.0, 4.0, 997))


def test_metrics_and_percentiles_equal_the_jax_testers(harness_fleet):
    jcfg, tcfg, _ = harness_fleet
    lat = _latencies()
    srt = sorted(lat)
    for p in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert _percentile(srt, p) == jax_harness._percentile(srt, p)
    assert _percentile([], 0.95) == jax_harness._percentile([], 0.95) == 0.0
    jm = _filled(jax_harness.PerformanceTester(jcfg),
                 lat)._calculate_metrics()
    tm = _filled(PerformanceTester(tcfg, device="cpu"),
                 lat)._calculate_metrics()
    for f in ("throughput", "avg_latency", "p95_latency", "p99_latency",
              "max_latency", "error_rate"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert [f.name for f in dataclasses.fields(tm)] == [
        f.name for f in dataclasses.fields(jm)]


def test_save_results_writes_the_jax_testers_artifacts(harness_fleet,
                                                       tmp_path):
    """The same triplet: equal CSV headers and latency rows, and summary
    lines equal but the sampled CPU and memory shares."""
    jcfg, tcfg, _ = harness_fleet
    lat = _latencies()
    bases = [_filled(cls(cfg, output_dir=str(tmp_path / name), **kw),
                     lat).save_results(1000, 30)
             for name, cls, cfg, kw in (
                 ("jax", jax_harness.PerformanceTester, jcfg, {}),
                 ("port", PerformanceTester, tcfg, {"device": "cpu"}))]
    pattern = r"perf_test_400vehicles_1000tps_30s_\d{8}_\d{6}"
    assert all(re.fullmatch(pattern, os.path.basename(b)) for b in bases)
    read = lambda b, s: open(b + s).read().splitlines()
    jb, tb = bases
    assert read(tb, "_latencies.csv") == read(jb, "_latencies.csv")
    assert read(tb, "_metrics.csv")[0] == read(jb, "_metrics.csv")[0]
    assert len(read(tb, "_metrics.csv")) == 5
    sampled = ("  CPU: ", "  Memory: ")
    keep = lambda lines: [ln for ln in lines if not ln.startswith(sampled)]
    want = read(jb, "_summary.txt")
    assert keep(read(tb, "_summary.txt")) == keep(want)
    assert "Total risks detected: 1234" in want


# ---- the orchestrated run against the JAX one -----------------------------

def _summary(main, out_dir, extra=()):
    main(["--vehicles", "32", "--tps", "50", "--duration", "1.5",
          "--sim-duration", "1.0", "--inject-failure", "--output-dir",
          str(out_dir), *extra])
    (path,) = glob.glob(str(out_dir / "benchmark_*_summary.json"))
    with open(path) as f:
        return json.load(f)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_run_benchmark_summary_has_the_jax_runs_keys(tmp_path):
    got = _summary(run_benchmark.main, tmp_path / "port",
                   ("--device", "cpu"))
    want = _summary(jax_run_benchmark.main, tmp_path / "jax")
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    assert got["load"]["errors"] == 0 and got["sim_updates"] > 0
    # the route kills a tenth of the live objects, rounded down
    killed = got["fault"]["data"]["killed"]
    assert killed == int((got["system"]["num_alive"] + killed) * 0.1) > 0
    assert glob.glob(str(tmp_path / "port" / "monitor_*.csv"))


# ---- surface ---------------------------------------------------------------

def test_entry_points_keep_the_jax_surface_and_need_a_card(monkeypatch,
                                                          tmp_path):
    """The JAX tester's parameters and flags plus the device; naming no
    device goes to the card, and without one the tester and both mains
    raise instead of running on the CPU."""
    jp = list(inspect.signature(jax_harness.PerformanceTester).parameters)
    tp = list(inspect.signature(PerformanceTester).parameters)
    assert tp == jp + ["device"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.SystemConfig(num_objects=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PerformanceTester(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(["--vehicles", "16", "--duration", "0.1",
                      "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark.main(["--vehicles", "8", "--duration", "0.1",
                            "--output-dir", str(tmp_path)])
    assert not glob.glob(str(tmp_path / "perf_test_*"))


def test_bench_imports_neither_jax_nor_the_jax_package():
    code = ("import json, sys; import tpu_collide_torch.bench, "
            "tpu_collide_torch.bench.harness, "
            "tpu_collide_torch.bench.run_benchmark; "
            "print(json.dumps([m for m in ('jax', 'tpu_collide') "
            "if m in sys.modules]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
