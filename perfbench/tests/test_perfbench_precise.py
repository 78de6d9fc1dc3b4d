"""The precise cell (drones_10m_3d_precise.step_precise): its files resolve,
its readers read the right numbers and nothing where the trace lacks
their span, its bounds count what a hand count gives, and whole runs on the
CPU at a small size give `correct` true, and false under each fault of
precise mode."""
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench import harness, roofline_precise
from perfbench.drivers import common, precise_step_loop
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState

CELL = "drones_10m_3d_precise.step_precise"
CPU = torch.device("cpu")
N = 1500


def test_cell_resolves():
    cell = harness.resolve(CELL, harness.manifest())
    assert cell.chips == 1
    assert cell.traffic["driver"] == "precise_step_loop"
    assert set(cell.limits) == {"integ_err", "risks_gap", "alert_miss",
                                "alert_key_gap"}
    assert {m["name"] for m in cell.end_to_end} == {
        "obj_steps_per_s.device_bound", "step_ms_p95.device_bound",
        "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "precise_sweep.device_ms.precise", "survivor_cut.device_ms.precise",
        "precise_sweep.roofline_pct.precise",
        "detect_kernel.roofline_pct.precise"}
    system = cell.config["system"]
    assert system["detect"]["mode"] == "precise"
    assert system["detect"]["precise_survivor_cap"] is None
    fast = json.loads((harness.PKG / "configs" / "drones_10m_3d.json")
                      .read_text())["system"]
    fast["detect"].update(mode="precise", survivor_k=8,
                          precise_survivor_cap=None)
    assert system == fast


def reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py").read


def synthetic(spans=True) -> dict:
    """Two profiled steps: a sweep span launching 1.0 + 0.5 ms, a cut span
    launching 0.25 ms, 4 ms launched by the rest of tc.refine, and the
    detection kernel for 50 us in all."""
    host = [("tc.refine", 5.0, 50.0)]
    if spans:
        host += [("tc.precise_sweep", 10.0, 20.0),
                 ("tc.survivor_cut", 30.0, 40.0)]
    return dict(host=host, units=2,
                device=[("void fused_topk_kernel<false, true, 8>", 100.0,
                         150.0), ("void at::native::sort", 160.0, 410.0)],
                launched=[(12.0, 1000.0), (20.0, 500.0), (30.0, 250.0),
                          (45.0, 4000.0)],
                bounds_ms=[0.01, 0.01], sweep_bounds_ms=[0.3, 0.5])


@pytest.mark.parametrize("name,want", [
    ("precise_sweep.device_ms.precise", 0.75),
    ("survivor_cut.device_ms.precise", 0.125),
    ("precise_sweep.roofline_pct.precise", 100 * 0.4 / 0.75),
    ("detect_kernel.roofline_pct.precise", 100 * 0.01 / 0.025)])
def test_reader_reads_a_synthetic_trace(name, want):
    assert math.isclose(reader(name)(synthetic()), want, rel_tol=1e-12)


@pytest.mark.parametrize("name", ["precise_sweep.device_ms.precise",
                                  "survivor_cut.device_ms.precise",
                                  "precise_sweep.roofline_pct.precise"])
def test_reader_is_silent_without_its_span(name):
    assert reader(name)(synthetic(spans=False)) is None
    unlinked = dict(synthetic(), launched=[])
    assert reader(name)(unlinked) is None


def test_kernel_reader_is_silent_without_the_kernel():
    t = dict(synthetic(), device=[("void at::native::sort", 0.0, 9.0)])
    assert reader("detect_kernel.roofline_pct.precise")(t) is None


def pair_fleet(r, v, a):
    """Two drones of size 2 m (safe 7 m) in a 300 x 300 x 100 m world, the
    second at r, v, a from the first, and a third alone in a far cell."""
    c = [100.0, 100.0, 50.0]
    t = lambda rows: torch.tensor(rows, dtype=torch.float32)
    state = dict(
        pos=t([c, [c[i] + r[i] for i in range(3)], [275.0, 275.0, 50.0]]),
        vel=t([[0.0] * 3, v, [0.0] * 3]), acc=t([[0.0] * 3, a, [0.0] * 3]),
        heading=torch.zeros(3), size=torch.full((3,), 2.0),
        otype=torch.zeros(3, dtype=torch.int32),
        alive=torch.ones(3, dtype=torch.bool),
        oid=torch.arange(3, dtype=torch.int32))
    conf = json.loads((harness.PKG / "configs"
                       / "drones_10m_3d_precise.json").read_text())
    s = conf["system"]
    s["num_objects"] = 3
    s["world"]["hi"] = [300.0, 300.0, 100.0]
    return ObjectState(**state), SystemConfig.from_json(json.dumps(s))


# hand counts, 3D, 6 x 6 x 2 cells of 50 m, survivor_k 8: the two drones
# share a cell and walk 2 candidates each, the third walks itself (5); two
# stage-1 pairs, both survive stage 2.
#   closing head-on at 10 m/s from 20.5 m: inside at t >= 1.35 s, the
#   first sample inside is k = 14, so 15 samples each direction (30)
#   grazing (a pair the sweep misses): all 100 samples each direction (200)
@pytest.mark.parametrize("pair,samples", [
    (((20.5, 0.0, 0.0), (-10.0, 0.0, 0.0), (0.0, 0.0, 0.0)), 30),
    (((7.263, -0.42, -6.229), (-16.137, 7.554, -0.272),
      (-1.498, 1.373, -1.511)), 200)])
def test_bounds_count_by_hand(pair, samples):
    state, cfg = pair_fleet(*pair)
    w = precise_step_loop.work(state, cfg, common.as_system(cfg))
    assert (w["walked"], w["stage1"], w["stage2"], w["samples"]) == \
        (5, 2, 2, samples)
    b2 = roofline_precise.survivors_bound(w)
    assert b2["operations"] == 5 * 9 + 2 * 52
    assert b2["bytes"] == 3 * 48 + 73 * 4 + 3 * 8 * 8 + 3 * 8 + 8
    sw = roofline_precise.sweep_bound(w)
    assert sw["operations"] == samples * 20
    assert sw["bytes"] == 2 * (2 * 48 + 12)


def small_cell():
    cell = harness.resolve(CELL, harness.manifest())
    conf = json.loads(json.dumps(cell.config))
    s = conf["system"]
    f = (N / s["num_objects"]) ** (1 / 3)
    s["world"]["hi"] = [h * f for h in s["world"]["hi"]]
    s["num_objects"] = N
    return dataclasses.replace(cell, config=conf, traffic=dict(
        cell.traffic, profile_steps=3, work_steps=2))


def run(trace=False):
    return harness.run_cell(small_cell(), 2 ** 31 + 11, 0.6, trace, torch,
                            CPU, time.perf_counter())


def test_small_run_is_correct():
    line = run(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    info = line["info"]
    assert info["survivor_need"] > 0 and info["certify_worst"] == 0
    assert info["survivor_cap"] >= info["survivor_need"]
    assert info["survivor_k"] >= 8 and info["certify_tries"] >= 1
    # no device on the CPU: the device readers are silent
    assert line["metrics"] == {}


def unchanged(real_make):
    def make(cfg, **kw):
        step = real_make(cfg, **kw)
        return lambda st, gen: (st, step(st, gen)[1])
    return make


def closed_form(rel_pos, rel_vel, rel_acc, safe, det):
    from tpu_collide_torch.detect.pipeline import _fast_first_crossing
    return _fast_first_crossing(rel_pos, rel_vel, safe, det)


def half_the_samples(rel_pos, rel_vel, rel_acc, safe, det):
    from tpu_collide_torch.detect.pipeline import _precise_sweep
    return _precise_sweep(rel_pos, rel_vel, rel_acc, safe,
                          dataclasses.replace(det,
                                              time_step=2 * det.time_step))


@pytest.mark.parametrize("fault", ["unchanged", "closed_form",
                                   "half_the_samples"])
def test_fault_is_not_correct(monkeypatch, fault):
    import tpu_collide_torch
    from tpu_collide_torch.kernels import refine
    if fault == "unchanged":
        monkeypatch.setattr(tpu_collide_torch, "make_step",
                            unchanged(tpu_collide_torch.make_step))
    else:
        monkeypatch.setattr(refine, "_precise_sweep",
                            closed_form if fault == "closed_form"
                            else half_the_samples)
    assert not run()["correct"]
