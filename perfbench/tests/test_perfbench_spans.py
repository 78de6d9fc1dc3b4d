"""The span readers (perfbench/spans.py and the metrics that read it) on
synthetic traces, and through a whole traced run of a small step cell on
the CPU."""
import json
import shutil
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.test_perfbench_cells import small_config
from perfbench.trace import merged

BENCH = harness.manifest()
SPAN_METRICS = ("integrate.host_ms", "cell_list.host_ms", "refine.host_ms",
                "step.host_waits", "refine.hot_topup_pct",
                "step.idle_pct.in_step")
DEVICE_METRICS = [m["name"] for m in BENCH["per_layer"]
                  if m["source"] == "device_trace"
                  and not m["name"].startswith("serve.")]


def reader(name: str):
    return harness.load_module(harness.PKG / "metrics" / (name + ".py")).read


def make_trace(device, host, window_s=0.01, units=2) -> dict:
    busy = merged(sorted((s, e) for _, s, e in device))
    return dict(device=sorted(device, key=lambda s: s[1]),
                host=sorted(host, key=lambda s: s[1]),
                busy_s=sum(e - s for s, e in busy) * 1e-6,
                window_s=window_s, units=units, bounds_ms=[0.05, 0.05])


# two steps in a window of 10,000 us; the first has a hot top-up
STEP_SPANS = [
    ("tc.step", 100, 4000),
    ("tc.integrate", 150, 900), ("tc.host_wait", 200, 300),
    ("tc.cell_list", 1000, 1500),
    ("tc.refine", 1600, 3900),
    ("tc.detect_kernel", 1700, 2000), ("tc.host_wait", 1800, 1850),
    ("tc.host_wait", 2100, 2500),
    ("tc.hot_pairs", 2600, 3200), ("tc.host_wait", 2700, 2800),
    ("tc.step", 5000, 8000),
    ("tc.integrate", 5050, 5500),
    ("tc.cell_list", 5600, 6000),
    ("tc.refine", 6100, 7900),
    ("tc.detect_kernel", 6200, 6500), ("tc.host_wait", 6600, 6700),
]
ATEN = [("aten::add", 160, 180), ("cudaLaunchKernel", 165, 170),
        ("aten::sort", 1100, 1400), ("Activity Buffer Request", 8500, 9500)]
DEVICE = [("kernel_a", 300, 1000), ("fused_topk_kernel<true>", 2000, 2100),
          ("Memcpy DtoH", 3000, 4500), ("kernel_b", 5000, 5200),
          ("kernel_c", 7000, 9000)]


@pytest.fixture
def trace():
    return make_trace(DEVICE, STEP_SPANS + ATEN)


def test_self_time_leaves_out_other_layers_and_waits(trace):
    # integrate: 750 - 100 (its wait) + 450 us over 2 steps
    assert reader("integrate.host_ms")(trace) == pytest.approx(0.55)
    assert reader("cell_list.host_ms")(trace) == pytest.approx(0.45)
    # refine: 2300 - 300 (the kernel, a wait inside it) - 400 - 100 (the
    # wait inside the hot pairs, which stay in) + 1800 - 300 - 100
    assert reader("refine.host_ms")(trace) == pytest.approx(1.45)


def test_wait_count_and_hot_topup_share(trace):
    assert reader("step.host_waits")(trace) == pytest.approx(2.5)
    assert reader("refine.hot_topup_pct")(trace) == pytest.approx(50.0)


def test_idle_in_step_lies_within_the_idle_share(trace):
    # step 1: 3900 us less 700 + 100 + 1000 busy; step 2: 3000 less 200 +
    # 1000; of 10,000 us
    got = reader("step.idle_pct.in_step")(trace)
    assert got == pytest.approx(39.0)
    assert got <= reader("step.idle_pct")(trace) == pytest.approx(55.0)


def test_idle_in_step_is_the_idle_share_when_the_step_is_the_window():
    t = make_trace(DEVICE, [("tc.step", 0, 10000)] + ATEN, units=1)
    assert reader("step.idle_pct.in_step")(t) == pytest.approx(
        reader("step.idle_pct")(t))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_twin_reads_as_its_base(trace, name):
    assert reader(name + ".device_bound")(trace) == reader(name)(trace)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_silent_without_spans(trace, name):
    """A program that opens no span (the parent of the spans) gives no
    reading, and no error."""
    bare = make_trace(DEVICE, ATEN)
    assert reader(name)(bare) is None
    assert reader(name + ".device_bound")(bare) is None


@pytest.mark.parametrize("name", DEVICE_METRICS)
def test_device_readers_do_not_see_the_spans(trace, name):
    bare = make_trace(DEVICE, ATEN)
    assert reader(name)(trace) == reader(name)(bare)


def test_entries_of_the_span_metrics():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for name in SPAN_METRICS:
        base, twin = entries[name], entries[name + ".device_bound"]
        assert base["workloads"] == ["ground_100k_2d.step_uniform"]
        assert base["moves"] == "step_ms_p95"
        assert twin["workloads"] == ["drones_10m_3d.step_uniform"]
        assert twin["moves"] == "obj_steps_per_s.device_bound"
        assert {k: v for k, v in base.items()
                if k not in ("name", "moves", "workloads")} == \
            {k: v for k, v in twin.items()
             if k not in ("name", "moves", "workloads")}
        assert base["source"] in ("program_span", "program_counter")
    # the engine and the device are the layers the benchmark named before
    assert {"engine: the eager fused step", "device: one H100"} <= layers


def test_a_traced_run_reads_every_span_metric(tmp_path):
    """A small step cell on the CPU (the plain kernels), traced: the
    program's spans reach the readers through the harness."""
    pkg = tmp_path / "perfbench"
    shutil.copytree(harness.PKG, pkg)
    bench = harness.manifest()
    (pkg / "configs" / "tiny_2d.json").write_text(json.dumps(
        small_config("ground_100k_2d")))
    step = json.loads((pkg / "traffic" / "step_uniform.json").read_text())
    step.update(profile_steps=3, work_steps=1)
    (pkg / "traffic" / "step_tiny.json").write_text(json.dumps(step))
    shutil.copy(pkg / "limits" / "ground_100k_2d.step_uniform.json",
                pkg / "limits" / "tiny_2d.step_tiny.json")
    cell = "tiny_2d.step_tiny"
    bench["configs"].append(dict(name="tiny_2d", source="test",
                                 file="perfbench/configs/tiny_2d.json",
                                 reduced=["num_objects"], why="test"))
    bench["workloads"].append(dict(name=cell, config="tiny_2d",
                                   traffic="step_tiny", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in SPAN_METRICS + ("step_ms_p95",):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = harness.resolve(cell, harness.manifest(tmp_path), pkg=pkg)
    line = harness.run_cell(c, 2 ** 31 + 5, 0.5, True, torch,
                            torch.device("cpu"), time.perf_counter(),
                            pkg=pkg)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    # (no device operation is profiled on the CPU, so the idle inside the
    # step is all of the steps' time)
    assert set(SPAN_METRICS) <= set(got)
    assert got["step.host_waits"]["value"] >= 1
    assert got["refine.host_ms"]["value"] > 0
