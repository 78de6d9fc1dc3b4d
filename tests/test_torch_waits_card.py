"""Every wait of the port's step, ring update and prediction marked, on a
CUDA card. Under torch.profiler with the card's activity, each call of the
CUDA runtime that makes the host wait for the device (a stream, device or
event synchronise, a synchronous cudaMemcpy) and that starts inside a
tc.step, tc.predict or tc.history span lies inside a tc.host_wait span
(core/device.host_wait). The fleets are the warn deployment's drones
(perfbench/configs/drones_1m_3d_warn.json), cut to N at its density: the
fused step in fast mode (hot_cover 'count' and 'cut') and in precise mode,
each at one slot an object so that hot rows are recomputed, the ring's
update, and the prediction at the cell's k_slots and at k_slots 1 (where
the top-up recomputes). The waits of a prediction fall where the CPU test
counts them (tests/test_torch_predict_deployment.py), and the spans inside
tc.predict cover the device time it launches, within 2% a call. Off the
card every test skips. This file imports no JAX, so that it runs on the
card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_waits_card.py
"""
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from perfbench.fleet import make_fleet
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.detect.predict import empty_history, update_history
from tpu_collide_torch.engine import make_predict, make_step

pytestmark = pytest.mark.card

CONF = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                   / "configs" / "drones_1m_3d_warn.json").read_text())
PC = CONF["predict"]
SEED = 2 ** 31 + 93
N = 50_000
CALLS = 2
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cudaMemcpy3D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol"}
OUTER = ("tc.step", "tc.predict", "tc.history")
# the spans inside tc.predict that launch its device work
CHILDREN = ("tc.classify", "tc.cell_list", "tc.host_wait",
            "tc.predict_kernel", "tc.predict_merge", "tc.predict_topup",
            "tc.predict_compact")
# the waits of a prediction by the span that holds them (the CPU test's)
WAITS = {"tc.predict": 1, "tc.cell_list": 3, "tc.predict_merge": 3,
         "tc.predict_topup": 1}


def system(mode="fast", cover="count") -> dict:
    """The deployment's system at N drones in a world shrunk to keep the
    density, at one slot an object."""
    s = json.loads(json.dumps(CONF["system"]))
    f = (N / s["num_objects"]) ** (1 / 3)
    s["world"]["hi"] = [h * f for h in s["world"]["hi"]]
    s["num_objects"] = N
    s["alerts"]["max_alerts_per_object"] = 1
    s["detect"].update(mode=mode, hot_cover=cover, survivor_k=1)
    return s


def config(mode="fast", cover="count") -> SystemConfig:
    return SystemConfig.from_json(json.dumps(system(mode, cover)))


@dataclasses.dataclass
class Run:
    """The profiled calls of one case: [(name, start, end)] of the tc.*
    spans, of the synchronising runtime calls and of every host operation,
    and [(launching operation's start, device us)]."""
    spans: list
    syncs: list
    ops: list
    launched: list


def profiled(card, calls) -> Run:
    """`calls` (each run once first, outside the profiler) CALLS times
    each under torch.profiler with the card's activity."""
    for fn in calls:
        fn()
    torch.cuda.synchronize(card)
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as p:
        for _ in range(CALLS):
            for fn in calls:
                fn()
        torch.cuda.synchronize(card)
    cuda = torch.autograd.DeviceType.CUDA
    ops, launched = [], []
    for e in p.events():
        if e.device_type == cuda:
            continue
        start = float(e.time_range.start)
        ops.append((e.name, start, float(e.time_range.end)))
        launched.extend((start, float(k.duration)) for k in e.kernels)
    ops.sort(key=lambda x: x[1])
    base = lambda name: re.sub(r"_v\d+$", "", name)
    return Run(spans=[o for o in ops if o[0].startswith("tc.")],
               syncs=[o for o in ops if base(o[0]) in SYNCS],
               ops=ops, launched=launched)


def inside(t, s) -> bool:
    return s[1] <= t <= s[2]


def innermost(t, ops) -> str:
    """The name of the shortest of `ops` running at time t."""
    holds = [o for o in ops if inside(t, o)]
    return min(holds, key=lambda o: o[2] - o[1])[0] if holds else "-"


def empty_waits(run: Run) -> list:
    """The tc.host_wait spans that hold no synchronising call."""
    return [w for w in run.spans if w[0] == "tc.host_wait"
            and not any(inside(c[1], w) for c in run.syncs)]


def unmarked(run: Run) -> list:
    """The synchronising calls inside tc.step, tc.predict or tc.history and
    outside every tc.host_wait, each with the innermost tc.* span and host
    operation around it."""
    outer = [s for s in run.spans if s[0] in OUTER]
    waits = [s for s in run.spans if s[0] == "tc.host_wait"]
    return [(c[0], innermost(c[1], run.spans), innermost(
        c[1], [o for o in run.ops if o[0] != c[0]]))
        for c in run.syncs if any(inside(c[1], s) for s in outer)
        and not any(inside(c[1], w) for w in waits)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the synchronising runtime calls "
                    "exist only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def filled(card):
    """(cfg, state, ring) after 12 ticks of the fused step and of a
    16-point ring's update."""
    cfg = config()
    state = ObjectState(**make_fleet(system(), CONF["vehicle_sizes"],
                                     {"speed": [5.0, 20.0]}, SEED, card))
    step = make_step(cfg, backend="fused", device=card)
    gen = torch.Generator(device=card).manual_seed(SEED)
    hist = empty_history(N, 16, device=card)
    for tick in range(1, 13):
        state, _ = step(state, gen)
        hist = update_history(hist, state, tick * cfg.sim.dt)
    return cfg, state, hist


@pytest.mark.parametrize("mode,cover", [("fast", "count"), ("fast", "cut"),
                                        ("precise", "count")])
def test_step_waits_are_marked(card, filled, mode, cover):
    _, state, _ = filled
    cfg = config(mode, cover)
    step = make_step(cfg, backend="fused", device=card)
    gen = torch.Generator(device=card).manual_seed(SEED)
    outs = []
    run = profiled(card, [lambda: outs.append(step(state, gen)[1])])
    assert unmarked(run) == [] and empty_waits(run) == []
    steps = [s for s in run.spans if s[0] == "tc.step"]
    assert len(steps) == CALLS and len(run.syncs) >= CALLS
    if cover == "count":
        # one slot an object: hot rows are recomputed
        assert [s for s in run.spans if s[0] == "tc.hot_pairs"]


def test_ring_update_waits_are_marked(card, filled):
    cfg, state, hist = filled
    run = profiled(card, [lambda: update_history(hist, state, 1.3)])
    assert unmarked(run) == [] and empty_waits(run) == []
    waits = [s for s in run.spans if s[0] == "tc.host_wait"]
    assert len(waits) == CALLS == len(
        [s for s in run.spans if s[0] == "tc.history"])


@pytest.mark.parametrize("k_slots,topup_waits", [(PC["k_slots"], 0),
                                                 (1, 8)])
def test_prediction_waits_are_marked_and_spans_cover_it(card, filled,
                                                        k_slots,
                                                        topup_waits):
    cfg, state, hist = filled
    predict = make_predict(cfg, PC["horizon"], PC["step"],
                           sub_window=PC["sub_window"], merge_k=PC["merge_k"],
                           k_slots=k_slots, r_cap=PC["r_cap"], device=card)
    got = []
    run = profiled(card, [lambda: got.append(predict(state, hist))])
    assert unmarked(run) == [] and empty_waits(run) == []
    assert all(int(g.slot_oflow) == 0 for g in got)
    calls = [s for s in run.spans if s[0] == "tc.predict"]
    assert len(calls) == CALLS
    where = {}
    for w in run.spans:
        if w[0] == "tc.host_wait":
            name = innermost(w[1], [s for s in run.spans
                                    if s[0] != "tc.host_wait"])
            where[name] = where.get(name, 0) + 1
    want = dict(WAITS, **{"tc.predict_topup": 1 + topup_waits})
    assert where == {k: CALLS * v for k, v in want.items()}
    for call in calls:
        kids = sorted(s[1:] for s in run.spans if s[0] in CHILDREN
                      and call[1] <= s[1] and s[2] <= call[2])
        total = sum(us for t, us in run.launched if inside(t, call))
        covered = sum(us for t, us in run.launched
                      if any(a <= t <= b for a, b in kids))
        assert total > 0 and abs(total - covered) <= 0.02 * total, (
            total, covered)
