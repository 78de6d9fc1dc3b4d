"""The city-skew cell (ground_100k_2d_cityskew.step_cityskew) on the CPU:
it resolves from its files; its episode loop runs at a small size with the
fleet set back to the seeded one every episode_steps steps; its two
readers read a synthetic trace and stay silent without tc.hot_cover; the
reference in bfloat16 fails the committed limits where the program passes
them, and the 'count' rule fails its certificate."""
import dataclasses
import json
import math
import time

import pytest
import torch

from perfbench import calibrate, calibrate_cover, harness
from perfbench.drivers import common

CELL = "ground_100k_2d_cityskew.step_cityskew"
N = 3000
CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
STEPS = 8


def small_cell(**traffic):
    """The cell at N objects: the world and the cities' radii shrunk to
    keep the density, shorter episodes and profile."""
    cell = harness.resolve(CELL, harness.manifest())
    conf = json.loads(json.dumps(cell.config))
    s = conf["system"]
    f = math.sqrt(N / s["num_objects"])
    s["world"]["hi"] = [s["world"]["hi"][0] * f, s["world"]["hi"][1] * f,
                        0.0]
    s["num_objects"] = N
    tr = json.loads(json.dumps(cell.traffic))
    tr["fleet"]["cities"] = [[x, y, r * f] for x, y, r in
                             tr["fleet"]["cities"]]
    tr.update(episode_steps=3, profile_steps=4, work_steps=1, **traffic)
    return dataclasses.replace(cell, config=conf, traffic=tr)


def test_cell_resolves():
    cell = harness.resolve(CELL, harness.manifest())
    s = cell.config["system"]
    assert s["num_objects"] == 100_000 and cell.chips == 1
    assert s["detect"]["hot_cover"] == "cut"
    assert s["detect"]["hot_topup"] == 256
    assert s["alerts"]["max_alerts_per_object"] == 8
    uniform = harness.resolve("ground_100k_2d.step_uniform",
                              harness.manifest())
    want = json.loads(json.dumps(uniform.config["system"]))
    want["detect"].update(hot_cover="cut", hot_topup=256)
    assert s == want
    assert cell.config["guarantees"] == uniform.config["guarantees"]
    assert cell.traffic["driver"] == "episode_loop"
    assert cell.traffic["fleet"]["city_fraction"] == 0.8
    assert len(cell.traffic["fleet"]["cities"]) == 5
    assert set(cell.limits) == set(uniform.limits)
    assert {m["name"] for m in cell.end_to_end} == {"step_ms_p95",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "hot_cover.device_ms.cityskew", "hot_cover.host_waits.cityskew"}
    assert common.system_config(cell).detect.hot_cover == "cut"


def test_episode_loop_resets_the_fleet(monkeypatch):
    """Every episode_steps-th step of the window starts from the seeded
    fleet; the others from the step before; the run is correct and
    certified."""
    import tpu_collide_torch
    cell = small_cell()
    fleet = common.fleet_state(cell, SEED, CPU)
    seen = []
    real = tpu_collide_torch.make_step

    def make(cfg, **kw):
        step = real(cfg, **kw)
        calls = []
        seen.append(calls)

        def f(st, gen):
            new, out = step(st, gen)
            calls.append((st, new))
            return new, out
        return f
    monkeypatch.setattr(tpu_collide_torch, "make_step", make)
    # a window of STEPS steps, however slow the host
    opened = iter([True] * STEPS + [False])
    monkeypatch.setattr(common.Clock, "open", lambda self: next(opened))
    line = harness.run_cell(cell, SEED, 1.0, False, torch, CPU,
                            time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["info"]["certify_worst"] == 0
    window = seen[-1]
    every = cell.traffic["episode_steps"]
    assert len(window) == STEPS
    for i, (st, _) in enumerate(window):
        if i % every == 0:
            assert torch.equal(st.pos, fleet.pos), i
        else:
            assert st is window[i - 1][1], i
    assert line["info"]["episodes"] == -(-len(window) // every)


def test_traced_run_reads_the_cover():
    line = harness.run_cell(small_cell(), SEED, 0.5, True, torch, CPU,
                            time.perf_counter())
    assert line["correct"]
    # no device operation on the CPU: the device reader stays silent
    assert set(line["metrics"]) == {"hot_cover.host_waits.cityskew"}
    assert 1.0 <= line["metrics"]["hot_cover.host_waits.cityskew"][
        "value"] <= 2.0
    cover = line["info"]["cover"]
    assert cover and all(0 < c["covered"] == c["candidates"] <= 256
                         and c["hot_rows"] > 10 * c["candidates"]
                         for c in cover)


def reader(name):
    return harness.load_module(harness.PKG / "metrics" / f"{name}.py").read


def synthetic(spans=True) -> dict:
    """Two profiled steps: hot cover spans launching 0.5 + 0.25 ms and
    holding three host waits, a wait and 2 ms launched outside them."""
    host = [("tc.step", 0.0, 100.0), ("tc.step", 100.0, 200.0),
            ("tc.host_wait", 20.0, 21.0), ("tc.host_wait", 25.0, 26.0),
            ("tc.host_wait", 125.0, 126.0), ("tc.host_wait", 150.0, 151.0)]
    if spans:
        host += [("tc.hot_cover", 10.0, 30.0), ("tc.hot_cover", 110.0,
                                                 130.0)]
    return dict(host=host, units=2, device=[],
                launched=[(12.0, 500.0), (115.0, 250.0), (140.0, 2000.0)])


def test_readers_read_a_synthetic_trace():
    assert math.isclose(reader("hot_cover.device_ms.cityskew")(synthetic()),
                        0.375, rel_tol=1e-12)
    assert reader("hot_cover.host_waits.cityskew")(synthetic()) == 1.5
    for name in ("hot_cover.device_ms.cityskew",
                 "hot_cover.host_waits.cityskew"):
        assert reader(name)(synthetic(spans=False)) is None


def test_controls_fail_the_limits():
    """At a small size: the program within the committed limits, the
    reference in bfloat16 outside them, the 'count' rule uncertified."""
    cell = small_cell(judged=2)
    driver = harness.load_module(harness.PKG / "drivers"
                                 / "episode_loop.py")
    res = driver.run(dict(cell=cell, seed=SEED, seconds=0.5, trace=False,
                          torch=torch, device=CPU,
                          t_start=time.perf_counter()))
    assert harness.verdict(res["checks"], cell.limits)[0], res["checks"]
    ctl = calibrate.control(res, cell, torch)
    assert not harness.verdict(ctl, cell.limits)[0], ctl
    count = calibrate_cover.count_control(res)
    assert count["alert_overflow"] > 0
