"""The port's stage functions (detect/pipeline.py) against the JAX stage
functions and the NumPy oracle of the reference math (tests/oracle.py), in
both sign conventions and both angle forms, and the head-on probe."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_collide.core.config import DetectionConfig as JDet
from tpu_collide.detect import pipeline as jp
from tpu_collide_torch.core.config import (DetectionConfig, SystemConfig,
                                           WorldConfig, GridConfig)
from tpu_collide_torch.core.state import state_from_numpy
from tpu_collide_torch.detect import pipeline as tp
from tpu_collide_torch.engine import detect_and_alerts_fused
from tpu_collide_torch.index.grid import build_grid, gather_candidates
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.refine import refine_pairs
from tests.oracle import oracle_detect_all
from tests.test_detect_parity import make_fleet
from tests.torch_parity import np_fleet

torch.set_num_threads(1)

# Stage functions against JAX: 1e-6, room for libm ulps in sin, cos, atan2
# and sqrt between the two frameworks.
TOL = dict(rtol=1e-6, atol=1e-6)


def _pairs(seed, p=4000):
    """Random relative kinematics of p pairs, most within a few safe
    distances of a crossing."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    rel_pos = f32(rng.uniform(-60.0, 60.0, (p, 3)))
    rel_vel = f32(-rel_pos / rng.uniform(1.0, 12.0, (p, 1))
                  + rng.normal(0.0, 2.0, (p, 3)))
    rel_acc = f32(rng.normal(0.0, 0.8, (p, 3)))
    safe = f32(rng.uniform(5.5, 10.0, p))
    return rel_pos, rel_vel, rel_acc, safe


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def test_safe_distance_and_dist_at_time():
    rel_pos, rel_vel, rel_acc, safe = _pairs(0)
    t = np.linspace(0.0, 9.9, rel_pos.shape[0], dtype=np.float32)
    (jpos, jvel, jacc, jt), (tpos, tvel, tacc, tt_) = _both(
        rel_pos, rel_vel, rel_acc, t)
    np.testing.assert_allclose(
        tp._dist_at_time(tpos, tvel, tacc, tt_).numpy(),
        np.asarray(jp._dist_at_time(jpos, jvel, jacc, jt)), **TOL)
    det = DetectionConfig()
    np.testing.assert_array_equal(
        tp._pair_safe_distance(torch.tensor([2.0, 4.0]),
                               torch.tensor([5.0, 1.0]), det).numpy(),
        np.asarray(jp._pair_safe_distance(jnp.array([2.0, 4.0]),
                                          jnp.array([5.0, 1.0]), JDet())))


@pytest.mark.parametrize("stage", ["precise", "fast"])
def test_stage3_matches_jax(stage):
    rel_pos, rel_vel, rel_acc, safe = _pairs(1)
    (jpos, jvel, jacc, jsafe), (tpos, tvel, tacc, tsafe) = _both(
        rel_pos, rel_vel, rel_acc, safe)
    if stage == "precise":
        want = jp._precise_sweep(jpos, jvel, jacc, jsafe, JDet())
        got = tp._precise_sweep(tpos, tvel, tacc, tsafe, DetectionConfig())
    else:
        want = jp._fast_first_crossing(jpos, jvel, jsafe, JDet())
        got = tp._fast_first_crossing(tpos, tvel, tsafe, DetectionConfig())
    hit_w, hit_g = np.asarray(want[0]), got[0].numpy()
    assert 0.2 < hit_w.mean() < 0.9      # both outcomes are exercised
    np.testing.assert_array_equal(hit_g, hit_w)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("angle_form", ["product", "direct"])
def test_angle_and_risk_match_jax(angle_form):
    rng = np.random.default_rng(2)
    p = 2000
    f32 = lambda a: np.asarray(a, np.float32)
    hi, hj = f32(rng.uniform(-np.pi, np.pi, p)), f32(rng.uniform(0, 7, p))
    d, t = f32(rng.uniform(0, 8, p)), f32(rng.uniform(0, 12, p))
    rs = f32(rng.uniform(0, 70, p))
    ti, tj = f32(rng.integers(0, 4, p)), f32(rng.integers(0, 4, p))
    safe = f32(rng.uniform(5.5, 10.0, p))
    det_j, det_t = JDet(angle_form=angle_form), DetectionConfig(
        angle_form=angle_form)
    ja, ta = _both(hi, hj, d, t, rs, ti, tj, safe)
    np.testing.assert_allclose(
        tp._angle_factor(ta[0], ta[1], det_t).numpy(),
        np.asarray(jp._angle_factor(ja[0], ja[1], det_j)), **TOL)
    np.testing.assert_allclose(
        tp._risk_score(ta[2], ta[3], ta[4], ta[0], ta[1], ta[5], ta[6],
                       ta[7], det_t).numpy(),
        np.asarray(jp._risk_score(ja[2], ja[3], ja[4], ja[0], ja[1], ja[5],
                                  ja[6], ja[7], det_j)), **TOL)


def _small_cfg(n, world=1000.0, **detect):
    return SystemConfig(num_objects=n,
                        world=WorldConfig(hi=(world, world, 0.0)),
                        grid=GridConfig(cell_size=100.0),
                        detect=DetectionConfig(mode="precise", **detect))


def _all_pairs(cfg, arrays, mode="precise"):
    """{(i, j): (risk, ttc, distance)} of every ordered pair's refined
    stages 1-4, keyed by the original object index."""
    st = state_from_numpy(*arrays, device="cpu")
    cl = build_cell_list(st, cfg)
    n = st.n
    own, cand = torch.meshgrid(torch.arange(n), torch.arange(n),
                               indexing="ij")
    own, cand = own.reshape(-1), cand.reshape(-1)
    ref = refine_pairs(cl, own, cand, cfg, mode)
    order = cl.order.numpy()
    h = ref.hit.numpy()
    cols = [x.numpy()[h] for x in (ref.risk, ref.ttc, ref.distance)]
    return {(int(order[i]), int(order[j])): tuple(float(c[q]) for c in cols)
            for q, (i, j) in enumerate(zip(own.numpy()[h], cand.numpy()[h]))}


@pytest.mark.parametrize("convention", ["physical", "reference"])
@pytest.mark.parametrize("angle_form", ["product", "direct"])
def test_refined_stages_match_oracle(convention, angle_form):
    """Stages 1-4 as the refine tail runs them, on every ordered pair of a
    small fleet, against the oracle (tolerances of
    tests/test_detect_parity.py: the oracle is the literal reference
    expression)."""
    fleet = make_fleet(np.random.default_rng(7), n=60, with_accel=True)
    pos, vel, acc, heading, size, otype = fleet
    got = _all_pairs(_small_cfg(60, convention=convention,
                                angle_form=angle_form), fleet)
    want = oracle_detect_all(pos, vel, acc, size, heading, otype,
                             convention=convention)
    assert want or convention == "reference"
    assert set(got) == set(want)
    for key, (r0, t0, d0) in want.items():
        r1, t1, d1 = got[key]
        assert abs(t1 - t0) < 1e-5, (key, t0, t1)
        assert abs(r1 - r0) < 2e-3, (key, r0, r1)
        assert abs(d1 - d0) < 1e-2, (key, d0, d1)


@pytest.mark.parametrize("is3d", [False, True])
@pytest.mark.parametrize("convention", ["physical", "reference"])
@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_detect_rows_equals_refine_rows(mode, convention, is3d):
    """The reference-shaped path (detect_rows, [N, K] tables) and the fused
    tail's recompute (refine_rows, [P] record lists) give the same bits on
    the same (own, candidate) pairs: the grid candidates' valid entries,
    mapped to sorted rows through the cell list's order. In precise mode
    every stage-2 survivor fits the cap, so detect_rows sweeps them all."""
    n = 300
    hi = (300.0, 300.0, 30.0) if is3d else (600.0, 600.0, 0.0)
    d = np_fleet(11, n, hi[0], is3d=is3d, accel=True, dead=7)
    d["pos"][:, 2] *= 0.1       # 3D: a 30 m deep world, pairs in reach
    st = state_from_numpy(d["pos"], d["vel"], d["acc"], d["heading"],
                          d["size"], d["otype"], alive=d["alive"],
                          device="cpu")
    cfg = SystemConfig(num_objects=n, world=WorldConfig(hi=hi),
                       grid=GridConfig(cell_size=100.0, cell_capacity=64),
                       detect=DetectionConfig(mode=mode,
                                              convention=convention))
    index = build_grid(st.pos, st.alive, cfg)
    rows = torch.arange(n)
    cand, ok = gather_candidates(index, index.cell3, cfg)
    ok = ok & (cand != rows[:, None])
    at = ok.nonzero(as_tuple=True)
    # a cap of one record a pair: every stage-2 survivor is swept
    cfg = cfg.replace(detect=dataclasses.replace(
        cfg.detect, precise_survivor_cap=at[0].numel()))
    table = tp.detect_rows(st, index, cfg, rows)
    assert int(table.survivor_overflow) == 0
    cl = build_cell_list(st, cfg)
    inv = torch.empty_like(cl.order)
    inv[cl.order] = torch.arange(n)
    own = inv[at[0]]
    other = inv[cand[at].to(torch.int64)]
    ref = refine_pairs(cl, own, other, cfg, mode)
    assert int(ref.hit.sum()) > 20       # not vacuous
    assert torch.equal(table.valid[at], ref.hit)
    for f in ("risk", "ttc", "distance", "rel_speed", "col_pos"):
        assert torch.equal(getattr(table, f)[at], getattr(ref, f)), f


def _head_on():
    pos = np.array([[0, 0, 0], [100, 0, 0]], np.float32)
    vel = np.array([[10, 0, 0], [-10, 0, 0]], np.float32)
    return (pos, vel, np.zeros((2, 3), np.float32),
            np.array([0.0, np.pi], np.float32), np.full(2, 2.0, np.float32),
            np.zeros(2, np.int32))


@pytest.mark.parametrize("mode", ["precise", "fast"])
def test_head_on_probe(mode):
    """Two cars 100 m apart closing at 20 m/s: safe = 7 m, first crossing at
    4.65 s, first lattice sample inside at 4.70 s, from both sides."""
    cfg = _small_cfg(2, world=200.0).replace(
        detect=DetectionConfig(mode=mode))
    got = _all_pairs(cfg, _head_on(), mode)
    assert set(got) == {(0, 1), (1, 0)}
    assert abs(got[(0, 1)][1] - 4.7) < 1e-5 and got[(0, 1)][0] > 0.3
    out = detect_and_alerts_fused(
        state_from_numpy(*_head_on(), device="cpu"), cfg)
    v = out.alerts.valid.numpy()
    pairs = set(zip(out.alerts.vehicle_oid.numpy()[v].tolist(),
                    out.alerts.other_oid.numpy()[v].tolist()))
    assert pairs == {(0, 1), (1, 0)}
    np.testing.assert_allclose(out.alerts.ttc.numpy()[v], 4.7, atol=1e-5)
    assert int(out.num_risks) == 2 and int(out.num_pairs_checked) == 2
