"""Whole runs on the CPU at a small size (the port's plain kernels stand in
for the CUDA ones): a cell, a mix and a metric added as files in a copy of
the benchmark; `correct` on sound runs; `correct` false with the timed
path broken underneath, once for each fault a cell can have; the control
failing the committed limits."""
import dataclasses
import json
import shutil
import time

import pytest
import torch

from perfbench import calibrate, harness

N = 1500
CPU = torch.device("cpu")


def small_config(name: str) -> dict:
    """A configuration of the benchmark at N objects, its world shrunk to
    keep the density."""
    conf = json.loads((harness.PKG / "configs" / f"{name}.json").read_text())
    s = conf["system"]
    hi = s["world"]["hi"]
    dim = 3 if hi[2] > 0 else 2
    f = (N / s["num_objects"]) ** (1 / dim)
    s["world"]["hi"] = [hi[0] * f, hi[1] * f, hi[2] * f]
    s["num_objects"] = N
    return conf


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark to which a test adds a configuration, two
    mixes, their limits and a metric, as files and manifest entries only."""
    root = tmp_path_factory.mktemp("bench")
    pkg = root / "perfbench"
    shutil.copytree(harness.PKG, pkg)
    bench = harness.manifest()
    (pkg / "configs" / "tiny_2d.json").write_text(json.dumps(
        small_config("ground_100k_2d")))
    step = json.loads((pkg / "traffic" / "step_uniform.json").read_text())
    step.update(profile_steps=3, work_steps=2)
    serve = json.loads((pkg / "traffic" / "serve_uniform.json").read_text())
    serve.update(report_pool_ticks=16, warmup_ticks=2, profile_ticks=2)
    serve["reports"]["per_tick"] = 150
    for mix, spec, like in (("step_tiny", step, "step_uniform"),
                            ("serve_tiny", serve, "serve_uniform")):
        (pkg / "traffic" / f"{mix}.json").write_text(json.dumps(spec))
        limits = (pkg / "limits" / f"ground_100k_2d.{like}.json").read_text()
        (pkg / "limits" / f"tiny_2d.{mix}.json").write_text(limits)
        bench["workloads"].append(dict(
            name=f"tiny_2d.{mix}", config="tiny_2d", traffic=mix, chips=1,
            why="test cell"))
    bench["configs"].append(dict(name="tiny_2d", source="test",
                                 file="perfbench/configs/tiny_2d.json",
                                 reduced=["num_objects"], why="test"))
    (pkg / "metrics" / "tiny.units.py").write_text(
        "def read(trace):\n    return float(trace['units'])\n")
    bench["per_layer"].append(dict(
        name="tiny.units", unit="steps", better="higher",
        source="device_trace", layer="test", moves="step_ms_p95",
        workloads=["tiny_2d.step_tiny"]))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny_2d.step_tiny")
    # the serve loop's metrics, whose files are in the benchmark already
    serve_cell = ["tiny_2d.serve_tiny"]
    bench["end_to_end"] += [
        dict(name="ticks_per_s", unit="ticks/s", better="higher", bound=0.25,
             source="host_clock", workloads=serve_cell),
        dict(name="tick_ms_p95", unit="ms", better="lower", bound=0.25,
             source="host_clock", workloads=serve_cell)]
    bench["per_layer"] += [
        dict(name=name, unit=unit, better="lower", source=source,
             layer="test", moves=moves, workloads=serve_cell)
        for name, unit, source, moves in (
            ("serve.ingest_ms", "ms", "program_span", "tick_ms_p95"),
            ("serve.alerts_ms", "ms", "program_span", "tick_ms_p95"),
            ("serve.idle_pct", "%", "device_trace", "ticks_per_s"))]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(copy, cell, seed=2 ** 31 + 11, trace=False):
    c = harness.resolve(cell, harness.manifest(copy), pkg=copy / "perfbench")
    return harness.run_cell(c, seed, 0.6, trace, torch, CPU,
                            time.perf_counter(), pkg=copy / "perfbench")


@pytest.mark.parametrize("cell", ["tiny_2d.step_tiny", "tiny_2d.serve_tiny"])
def test_added_cell_runs_correct(copy, cell):
    line = run(copy, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"


def test_added_metric_is_read(copy):
    line = run(copy, "tiny_2d.step_tiny", trace=True)
    assert line["correct"]
    assert line["metrics"]["tiny.units"]["value"] >= 1
    assert set(line["metrics"]) == {"tiny.units"}


def test_serve_metrics_are_read(copy):
    """The serve loop's cell and metrics, added as manifest entries only
    (no profiled device operation on the CPU, so no idle share)."""
    line = run(copy, "tiny_2d.serve_tiny", trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == {"serve.ingest_ms", "serve.alerts_ms"}
    assert line["metrics"]["serve.alerts_ms"]["value"] > 0


def unchanged(real_make):
    def make(cfg, **kw):
        step = real_make(cfg, **kw)
        return lambda st, gen: (st, step(st, gen)[1])
    return make


def half_batch(real_make):
    """Detection over every other object only."""
    from tpu_collide_torch.engine import detect_and_alerts_fused

    def make(cfg, **kw):
        step = real_make(cfg, **kw)

        def f(st, gen):
            new, _ = step(st, gen)
            keep = torch.arange(new.n, device=new.device) % 2 == 0
            return new, detect_and_alerts_fused(
                new.replace(alive=new.alive & keep), cfg)
        return f
    return make


def altered(real_make):
    """One listed alert's risk raised where the step produces it."""
    def make(cfg, **kw):
        step = real_make(cfg, **kw)

        def f(st, gen):
            new, out = step(st, gen)
            risk = out.alerts.risk.clone()
            risk[0] += 0.05
            return new, dataclasses.replace(
                out, alerts=dataclasses.replace(out.alerts, risk=risk))
        return f
    return make


def miscounted(real_make):
    def make(cfg, **kw):
        step = real_make(cfg, **kw)

        def f(st, gen):
            new, out = step(st, gen)
            return new, dataclasses.replace(out,
                                            num_risks=out.num_risks + 7)
        return f
    return make


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   miscounted])
@pytest.mark.parametrize("cell", ["tiny_2d.step_tiny", "tiny_2d.serve_tiny"])
def test_broken_step_is_not_correct(copy, monkeypatch, fault, cell):
    import tpu_collide_torch
    import tpu_collide_torch.api.scene as scene_mod
    monkeypatch.setattr(tpu_collide_torch, "make_step",
                        fault(tpu_collide_torch.make_step))
    monkeypatch.setattr(scene_mod, "make_step", fault(scene_mod.make_step))
    assert not run(copy, cell)["correct"]


@pytest.mark.parametrize("redraw", [False, True])
@pytest.mark.parametrize("cell", ["tiny_2d.step_tiny", "tiny_2d.serve_tiny"])
def test_wrong_redraws_are_not_correct(copy, monkeypatch, cell, redraw):
    """The integrator redrawing no object's acceleration, or every one."""
    import tpu_collide_torch.engine as engine
    real = engine.integrate

    def integrate(state, cfg, generator=None, **kw):
        flags = torch.full((state.n, 1), redraw, device=state.device)
        return real(state, cfg, generator, redraw=flags)
    monkeypatch.setattr(engine, "integrate", integrate)
    line = run(copy, cell)
    assert not line["correct"]
    assert line["checks"]["integ_err"]["value"] > \
        line["checks"]["integ_err"]["limit"]


def test_half_the_reports_left_out_is_not_correct(copy, monkeypatch):
    from tpu_collide_torch.api.scene import Scene
    real = Scene._flush_locked

    def flush(self):
        del self._pending[::2]
        del self._pending_meta[::2]
        return real(self)
    monkeypatch.setattr(Scene, "_flush_locked", flush)
    line = run(copy, "tiny_2d.serve_tiny")
    assert not line["correct"]
    assert line["checks"]["ingest_err"]["value"] > 0


@pytest.mark.parametrize("config,like,mix", [
    ("ground_100k_2d", "step_uniform", "step_tiny"),
    ("ground_100k_2d", "serve_uniform", "serve_tiny"),
    ("drones_10m_3d", "step_uniform", "step_tiny"),
])
def test_control_fails_the_limits(copy, config, like, mix):
    """The reference in bfloat16, in the program's place, at a small size:
    some number exceeds the committed limit of the cell."""
    limits = json.loads(
        (harness.PKG / "limits" / f"{config}.{like}.json").read_text())
    small = harness.resolve(f"tiny_2d.{mix}", harness.manifest(copy),
                            pkg=copy / "perfbench")
    c = dataclasses.replace(small, config=small_config(config),
                            limits=limits)
    driver = harness.load_module(harness.PKG / "drivers"
                                 / (c.traffic["driver"] + ".py"))
    res = driver.run(dict(cell=c, seed=5, seconds=0.5, trace=False,
                          torch=torch, device=CPU,
                          t_start=time.perf_counter()))
    assert harness.verdict(res["checks"], c.limits)[0]
    ctl = calibrate.control(res, c, torch)
    assert not harness.verdict(ctl, c.limits)[0], ctl
