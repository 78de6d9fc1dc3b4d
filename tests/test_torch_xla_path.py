"""The reference-shaped path of the port on the CPU: detect_pairs /
detect_rows, extract_alerts, make_step(backend='xla') and its chunked
variant against the JAX package on the same numpy-made fleets; burst
stepping and make_detect; the port's XLA alerts against its fused alerts;
and the golden 1000-object snapshot.

Tolerances: counters and pair sets exact; risk, ttc, distance, rel_speed
and col_pos at rtol = atol = 1e-5 (the two packages sum the norms in other
orders, a few ulps)."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.alerts.extract import extract_alerts as jax_extract
from tpu_collide.detect.pipeline import detect_pairs as jax_detect_pairs
from tpu_collide.detect.pipeline import detect_rows as jax_detect_rows
from tpu_collide.index.grid import build_grid as jax_build_grid
import tpu_collide_torch as tt
from tpu_collide_torch.alerts.extract import extract_alerts
from tpu_collide_torch.core.state import FIELDS, from_jax_numpy
from tpu_collide_torch.detect.pipeline import detect_pairs, detect_rows
from tpu_collide_torch.engine import (detect_and_alerts,
                                      detect_and_alerts_fused,
                                      make_burst_step)
from tpu_collide_torch.index.grid import build_grid
from tests.torch_parity import (alert_map, assert_alerts_equal, both_states,
                                jax_cfg, np_fleet, to_torch_cfg)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N = 300


def _fleet(is3d, mode, n=N, seed=5):
    cfg = jax_cfg(n, is3d=is3d, mode=mode)
    d = np_fleet(seed, n, 1000.0 if is3d else 2000.0, is3d=is3d,
                 accel=mode == "precise", dead=4)
    jst, st = both_states(d)
    return cfg, jst, st


def _assert_pairs_equal(jp, tp, min_risks=0):
    valid = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.other.numpy(), np.asarray(jp.other))
    np.testing.assert_array_equal(tp.valid.numpy(), valid)
    for f in ("survivor_overflow", "num_checked"):
        assert int(getattr(tp, f)) == int(getattr(jp, f)), f
    for f in ("risk", "ttc", "distance", "rel_speed", "col_pos"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), err_msg=f,
                                   **TOL)
    assert valid.sum() >= min_risks, "fleet too tame: few detected risks"


@pytest.mark.parametrize("is3d", [False, True])
@pytest.mark.parametrize("convention", ["physical", "reference"])
@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_detect_pairs_and_rows_match_jax(mode, convention, is3d):
    cfg, jst, st = _fleet(is3d, mode)
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 convention=convention))
    tcfg = to_torch_cfg(cfg)
    jidx = jax_build_grid(jst.pos, jst.alive, cfg)
    tidx = build_grid(st.pos, st.alive, tcfg)
    # the reference convention's sign bug leaves few risks
    _assert_pairs_equal(jax_detect_pairs(jst, jidx, cfg),
                        detect_pairs(st, tidx, tcfg),
                        min_risks=20 if convention == "physical" else 1)
    # a row block with a masked tail, as the chunked path forms it
    rows = np.minimum(np.arange(200, 264), N - 1).astype(np.int32)
    valid = np.arange(200, 264) < N - 20
    _assert_pairs_equal(
        jax_detect_rows(jst, jidx, cfg, jax.numpy.asarray(rows),
                        row_valid=jax.numpy.asarray(valid)),
        detect_rows(st, tidx, tcfg, torch.from_numpy(rows),
                    row_valid=torch.from_numpy(valid)))


def test_survivor_cap_overflow_matches_jax():
    """A survivor cap below the stage-2 survivor count: the same first
    survivors (index order) are swept, and the same overflow is counted."""
    cfg, jst, st = _fleet(False, "precise")
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 precise_survivor_cap=48))
    tcfg = to_torch_cfg(cfg)
    jp = jax_detect_pairs(jst, jax_build_grid(jst.pos, jst.alive, cfg), cfg)
    tp = detect_pairs(st, build_grid(st.pos, st.alive, tcfg), tcfg)
    assert int(jp.survivor_overflow) > 0
    _assert_pairs_equal(jp, tp, min_risks=5)


@pytest.mark.parametrize("masked", [False, True])
def test_extract_alerts_matches_jax(masked):
    """The scene top-A of the same pair table, as ORDERED lists (the key
    2*prio + risk has exact ties, broken by the lower index on both
    sides), with and without a query mask."""
    cfg, jst, st = _fleet(False, "fast")
    cfg = cfg.replace(alerts=dataclasses.replace(cfg.alerts,
                                                 max_scene_alerts=16))
    tcfg = to_torch_cfg(cfg)
    jp = jax_detect_pairs(jst, jax_build_grid(jst.pos, jst.alive, cfg), cfg)
    tp = detect_pairs(st, build_grid(st.pos, st.alive, tcfg), tcfg)
    qm = np.arange(N) % 3 != 1 if masked else None
    ja = jax_extract(jst, jp, cfg,
                     None if qm is None else jax.numpy.asarray(qm))
    ta = extract_alerts(st, tp, tcfg,
                        None if qm is None else torch.from_numpy(qm))
    assert int(ta.count) == int(ja.count) == 16     # the budget binds
    for f in ("vehicle_oid", "other_oid", "priority", "valid"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), f)
    for f in ("risk", "ttc", "distance", "rel_speed", "col_pos"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(ja, f)), err_msg=f,
                                   **TOL)


@pytest.mark.parametrize("chunk", [None, 128])
@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_make_step_matches_jax(mode, chunk):
    """One step of make_step(backend='xla') and of its chunked variant
    (chunk 128 over 300 rows: a ragged last block of 44) against the JAX
    package's; accel_change_prob is 0, so both integrators take the same
    step."""
    cfg, jst, st = _fleet(False, mode)
    jst1, jo = tc.make_step(cfg, donate=False, chunk_size=chunk)(
        jst, jax.random.key(1))
    st1, to = tt.make_step(to_torch_cfg(cfg), chunk_size=chunk,
                           device="cpu")(st, torch.Generator())
    for f in FIELDS:
        np.testing.assert_allclose(getattr(st1, f).numpy(),
                                   np.asarray(getattr(jst1, f)), err_msg=f,
                                   **TOL)
    for f in ("num_risks", "num_pairs_checked", "num_alive", "overflow",
              "alert_overflow"):
        assert int(getattr(to, f)) == int(getattr(jo, f)), f
    np.testing.assert_allclose(float(to.max_risk), float(jo.max_risk), **TOL)
    want = alert_map(jo.alerts, unordered=False)
    assert len(want) > 5
    assert_alerts_equal(want, alert_map(to.alerts, unordered=False))


def test_burst_equals_single_steps():
    """make_burst_step(cfg, 3) from a generator state equals 3 single
    steps from the same generator state: bit-equal states, the worst
    certificates, and the per-step risk counts."""
    cfg = to_torch_cfg(jax_cfg(N, mode="fast")).replace(
        sim=tt.SimConfig(accel_change_prob=0.5))
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, cell_capacity=4))
    _, st = both_states(np_fleet(9, N, 2000.0))
    st_b, gen_b, out_b, risks = make_burst_step(cfg, 3, device="cpu")(
        st, torch.Generator().manual_seed(3))
    step = tt.make_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    cur, outs = st, []
    for _ in range(3):
        cur, out = step(cur, gen)
        outs.append(out)
    for f in FIELDS:
        assert torch.equal(getattr(st_b, f), getattr(cur, f)), f
    assert torch.equal(gen_b.get_state(), gen.get_state())
    assert risks.tolist() == [int(o.num_risks) for o in outs]
    assert int(out_b.overflow) == max(int(o.overflow) for o in outs) > 0
    assert int(out_b.alert_overflow) == max(int(o.alert_overflow)
                                            for o in outs)
    assert alert_map(out_b.alerts) == alert_map(outs[-1].alerts)
    with pytest.raises(ValueError):
        make_burst_step(cfg, 0, device="cpu")


def test_make_detect_head_on():
    """Two cars 100 m apart closing at 20 m/s: ttc 4.70 s from both
    sides (the verify recipe)."""
    from tpu_collide_torch.core.state import state_from_numpy
    st = state_from_numpy(
        np.array([[0, 0, 0], [100, 0, 0]], np.float32),
        np.array([[10, 0, 0], [-10, 0, 0]], np.float32),
        np.zeros((2, 3)), np.array([0, np.pi]), np.full(2, 2.0),
        np.zeros(2, np.int32), device="cpu")
    cfg2 = tt.SystemConfig(num_objects=2,
                           world=tt.WorldConfig(hi=(200.0, 200.0, 0.0)))
    pairs = tt.make_detect(cfg2, device="cpu")(st)
    assert abs(float(pairs.ttc.min()) - 4.7) < 1e-5
    assert int(pairs.valid.sum()) == 2


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_xla_alerts_equal_fused_alerts(mode):
    """The port's two paths on one state: equal unordered alert sets and
    risk counts (the fused path counts both directions of a pair)."""
    cfg, _, st = _fleet(False, mode)
    tcfg = to_torch_cfg(cfg)
    xo = detect_and_alerts(st, tcfg)
    fo = detect_and_alerts_fused(st, tcfg)
    for out in (xo, fo):
        assert int(out.overflow) == 0 and int(out.alert_overflow) == 0
    assert int(fo.num_risks) == int(xo.num_risks)
    assert int(fo.num_pairs_checked) == int(xo.num_pairs_checked)
    assert int(fo.alerts.count) < cfg.alerts.max_scene_alerts
    want = alert_map(xo.alerts)
    assert len(want) > 5
    assert_alerts_equal(want, alert_map(fo.alerts))


def test_golden_snapshot():
    """tests/golden/alerts_1000_cityskew.json through the port: the JAX
    package makes the fleet and its first physics step (as
    tests/test_detect_parity.py does), the stepped state crosses over, and
    the port's detect_and_alerts reproduces the snapshot with the same
    tolerances."""
    from tpu_collide.core.config import AlertConfig, DetectionConfig
    from tpu_collide.sim import generate_fleet
    from tpu_collide.sim.integrator import integrate

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "alerts_1000_cityskew.json")
    with open(path) as f:
        golden = json.load(f)
    cfg = tc.SystemConfig(num_objects=1000,
                          detect=DetectionConfig(mode="precise"),
                          alerts=AlertConfig(max_scene_alerts=256))
    jst = integrate(generate_fleet(jax.random.key(42), cfg),
                    jax.random.key(7), cfg)
    st = from_jax_numpy({f: np.asarray(getattr(jst, f)) for f in FIELDS},
                        device="cpu")
    out = detect_and_alerts(st, to_torch_cfg(cfg))
    assert int(out.num_risks) == golden["num_risks"]
    v = out.alerts.valid.numpy()
    got = sorted(
        ({"vehicle": int(a), "other": int(b), "risk": round(float(r), 5),
          "ttc": round(float(t), 4), "priority": int(p)}
         for a, b, r, t, p in zip(
             *(getattr(out.alerts, f).numpy()[v]
               for f in ("vehicle_oid", "other_oid", "risk", "ttc",
                         "priority")))),
        key=lambda x: (x["vehicle"], x["other"]))
    want = golden["alerts"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["vehicle"] == w["vehicle"] and g["other"] == w["other"]
        assert abs(g["risk"] - w["risk"]) < 1e-4
        assert abs(g["ttc"] - w["ttc"]) < 1e-3
        assert g["priority"] == w["priority"]
