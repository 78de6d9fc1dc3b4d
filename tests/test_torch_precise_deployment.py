"""The port's precise fused step (detect.mode "precise": the detection kernel
in survivors mode, the survivor compaction and the sampled constant-
acceleration sweep) against the benchmark's plain reference of precise
mode (perfbench/reference/precise.py), on the CPU at the density of the
10M-drone deployment (perfbench/configs/drones_10m_3d_precise.json).

The fleets are cut to N drones in a world shrunk to keep the density, and
every acceleration is redrawn U(-1, 1) per axis, so that stage 3's
acceleration term acts on every pair. The limits are the precise cell's
own (perfbench/limits/drones_10m_3d_precise.step_precise.json).
"""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from perfbench.drivers import common, precise_step_loop
from perfbench.fleet import make_fleet
from perfbench.harness import verdict
from perfbench.reference import compare, precise
from tpu_collide_torch import make_step
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.detect.pipeline import (_fast_first_crossing,
                                               _precise_sweep)
from tpu_collide_torch.engine import detect_and_alerts_fused
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.tune import survivor_cap_for

ROOT = Path(__file__).resolve().parents[1] / "perfbench"
CONF = json.loads((ROOT / "configs" / "drones_10m_3d_precise.json")
                  .read_text())
LIMITS = json.loads((ROOT / "limits"
                     / "drones_10m_3d_precise.step_precise.json").read_text())
DETECT_LIMITS = {k: v for k, v in LIMITS.items() if k != "integ_err"}
CPU = torch.device("cpu")
N = 2000
SEEDS = [3, 2 ** 31 + 5, 987654321]


def small_system(n: int = N) -> dict:
    """The deployment's system at n drones, the world shrunk to keep the
    density."""
    s = json.loads(json.dumps(CONF["system"]))
    f = (n / s["num_objects"]) ** (1 / 3)
    s["world"]["hi"] = [h * f for h in s["world"]["hi"]]
    s["num_objects"] = n
    return s


def config(system: dict) -> SystemConfig:
    return SystemConfig.from_json(json.dumps(system))


def fleet(seed: int, system: dict) -> ObjectState:
    """The benchmark's fleet of the seed with every acceleration redrawn."""
    d = make_fleet(system, CONF["vehicle_sizes"], {"speed": [5.0, 20.0]},
                   seed, CPU)
    g = torch.Generator().manual_seed(seed)
    d["acc"] = torch.rand((system["num_objects"], 3), generator=g) * 2 - 1
    return ObjectState(**d)


@pytest.fixture(scope="module")
def stepped():
    """{seed: (cfg, the state a precise step detected on, its output)}."""
    system = small_system()
    cfg = config(system)
    out = {}
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)
        after, res = make_step(cfg, backend="fused", device=CPU)(
            fleet(seed, system), gen)
        out[seed] = (cfg, after, res)
    return out


def judged(cfg, state, produced) -> dict:
    return precise.judge(common.as_dict(state), produced,
                         common.as_system(cfg))


@pytest.mark.parametrize("seed", SEEDS)
def test_precise_step_matches_reference(stepped, seed):
    cfg, after, out = stepped[seed]
    assert int(out.overflow) == 0 and int(out.alert_overflow) == 0
    assert int(out.num_risks) > 100
    r = judged(cfg, after, common.produced(out))
    assert verdict(r, DETECT_LIMITS)[0], r


# (relative position, velocity, acceleration) of the other object seen from
# its partner; both of size 2 m, so safe = 7 m. Every pair passes stage 2.
SWEEP_ONLY = [((20.0, 15.0, 0.0), (-2.5, 0.0, 0.0), (0.0, -0.4, 0.0)),
              ((-13.123, 13.408, 2.787), (5.753, -2.324, 0.116),
               (-0.981, -0.984, 0.618))]
CLOSED_FORM_ONLY = [((7.263, -0.42, -6.229), (-16.137, 7.554, -0.272),
                     (-1.498, 1.373, -1.511)),
                    ((-11.315, 11.476, -2.483), (13.027, -6.414, -0.046),
                     (-1.319, 1.84, -1.925))]


def pair_state(r, v, a) -> ObjectState:
    c = torch.tensor([200.0, 200.0, 50.0])
    t = lambda x: torch.tensor([[0.0, 0.0, 0.0], list(x)])
    return ObjectState(
        pos=t(r) + c, vel=t(v), acc=t(a), heading=torch.zeros(2),
        size=torch.full((2,), 2.0), otype=torch.zeros(2, dtype=torch.int32),
        alive=torch.ones(2, dtype=torch.bool),
        oid=torch.arange(2, dtype=torch.int32))


def pair_config(mode: str) -> SystemConfig:
    s = json.loads(json.dumps(CONF["system"]))
    s["num_objects"] = 2
    s["world"]["hi"] = [400.0, 400.0, 100.0]
    s["detect"]["mode"] = mode
    return config(s)


@pytest.mark.parametrize("pair,sweep_hits", [
    (p, True) for p in SWEEP_ONLY] + [(p, False) for p in CLOSED_FORM_ONLY])
def test_sweep_and_closed_form_part_on_hand_built_pairs(pair, sweep_hits):
    r, v, a = (torch.tensor([x]) for x in pair)
    safe = torch.tensor([7.0])
    cfg = pair_config("precise")
    want = precise.sweep(r, v, a, safe, common.as_system(cfg)["detect"])
    got = _precise_sweep(r, v, a, safe, cfg.detect)
    assert bool(want[0]) == bool(got[0]) == sweep_hits
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])
    assert bool(_fast_first_crossing(r, v, safe, cfg.detect)[0]) \
        != sweep_hits
    # through the fused step's detection: both directions, or none
    state = pair_state(*pair)
    ref = precise.detect(common.as_dict(state), common.as_system(cfg))
    assert ref["stage2"] == 2 and ref["hits"] == 2 * sweep_hits
    assert int(detect_and_alerts_fused(state, cfg).num_risks) == ref["hits"]
    fast = detect_and_alerts_fused(state, pair_config("fast"))
    assert int(fast.num_risks) == 2 * (not sweep_hits)


def every_other_sample(rel_pos, rel_vel, rel_acc, safe, det):
    return _precise_sweep(rel_pos, rel_vel, rel_acc, safe,
                          dataclasses.replace(det,
                                              time_step=2 * det.time_step))


def closed_form(rel_pos, rel_vel, rel_acc, safe, det):
    return _fast_first_crossing(rel_pos, rel_vel, safe, det)


@pytest.mark.parametrize("fault", ["fast_mode", "every_other_sample",
                                   "closed_form_sweep", "bfloat16"])
def test_faults_exceed_a_limit(stepped, monkeypatch, fault):
    """Each fault, in the program's place on the same fleets, exceeds a
    limit on at least one of them."""
    worst = []
    for seed in SEEDS:
        cfg, after, out = stepped[seed]
        if fault == "bfloat16":
            produced = precise.stand_in(common.as_dict(after),
                                        common.as_system(cfg),
                                        torch.bfloat16)
        else:
            if fault == "fast_mode":
                cfg = dataclasses.replace(cfg, detect=dataclasses.replace(
                    cfg.detect, mode="fast"))
            else:
                monkeypatch.setattr(refine, "_precise_sweep",
                                    every_other_sample
                                    if fault == "every_other_sample"
                                    else closed_form)
            produced = common.produced(detect_and_alerts_fused(after, cfg))
        worst.append(judged(cfg, after, produced))
    assert not verdict(compare.worst(worst), DETECT_LIMITS)[0], worst


def profiled_spans(mode: str) -> list:
    system = small_system(600)
    system["detect"]["mode"] = mode
    cfg = config(system)
    step = make_step(cfg, backend="fused", device=CPU)
    state, gen = fleet(1, system), torch.Generator().manual_seed(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = step(state, gen)
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("tc.")]


def test_precise_spans_sit_once_a_step_inside_refine():
    ev = profiled_spans("precise")
    refines = [(s, e) for n, s, e in ev if n == "tc.refine"]
    assert len(refines) == 2
    for name in ("tc.survivor_cut", "tc.precise_sweep"):
        own = [(s, e) for n, s, e in ev if n == name]
        assert len(own) == 2
        for (s, e), (rs, re) in zip(own, refines):
            assert rs <= s and e <= re


def test_fast_mode_opens_no_precise_span():
    names = {n for n, _, _ in profiled_spans("fast")}
    assert "tc.refine" in names
    assert not names & {"tc.survivor_cut", "tc.precise_sweep"}


def packed_system(box: float) -> dict:
    """500 drones of the deployment packed into box x box x 50 m."""
    system = small_system(500)
    system["world"]["hi"] = [box, box, 50.0]
    return system


def test_hot_rows_are_swept_whole():
    """500 drones in 160 x 160 x 50 m: one row holds 9 stage-2 survivors,
    one past the deployment's 8 slots. The hot top-up sweeps its whole
    stencil neighbourhood, so the step is certified and agrees with the
    reference; without the top-up the 9th survivor counts in
    alert_overflow."""
    system = packed_system(160.0)
    cfg = config(system)
    state = fleet(7, system)
    out = detect_and_alerts_fused(state, cfg)
    assert int(out.alert_overflow) == 0
    r = judged(cfg, state, common.produced(out))
    assert verdict(r, DETECT_LIMITS)[0], r
    cold = dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, hot_topup=0))
    assert int(detect_and_alerts_fused(state, cold).alert_overflow) == 1


def test_certification_raises_slots_and_doubles_cap():
    """500 drones packed into 140 x 140 x 50 m: more rows past the
    deployment's 8 slots than the hot top-up's 8, so the rule raises
    survivor_k by the shortfall and doubles the probed cap, until the
    certificate is 0."""
    system = packed_system(140.0)
    cfg = config(system)
    state = fleet(7, system)
    got, _, _, worst, tries, need = precise_step_loop.certified(
        cfg, state, 2, 7, torch, CPU)
    assert tries >= 2 and worst == 0
    assert got.detect.survivor_k > cfg.detect.survivor_k
    assert got.survivor_cap == survivor_cap_for(need) * 2 ** (tries - 1)
