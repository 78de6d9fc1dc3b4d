"""Repairs of the port against the reference, on the CPU:

  * every selection of the fused tail (hot rows, scene top-A, survivor
    compaction) takes ties by the lower index, as jax.lax.top_k does
    (core/ops.topk_low_index), so a cap that binds on equal keys keeps the
    same entries whatever torch.topk does with ties;
  * conform_fleet zeroes z, vz, az of a 2D fleet as the JAX function does;
  * oids past 2^24 come through the fused step intact;
  * the fused step's num_pairs_checked is int32, as the JAX step's;
  * chip_smoke.certified raises survivor_k and the survivor cap (precise),
    or max_alerts_per_object (fast), the way bench.py's adopt_k does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core.state import conform_fleet as jax_conform_fleet
from tpu_collide.engine import make_detect
from tpu_collide.kernels import refine as jax_refine
from tpu_collide.kernels.cell_list import build_cell_list as jax_build
import tpu_collide_torch as tt
from tpu_collide_torch.core.ops import stable_topk, topk_low_index
from tpu_collide_torch.core.state import FIELDS, conform_fleet
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tests.torch_parity import (alert_map, assert_alerts_equal, both_states,
                                jax_cfg, np_fleet, to_torch_cfg)

torch.set_num_threads(1)


# ---- the tie rule ---------------------------------------------------------

def _np_topk(x, k):
    """The k largest by (value descending, index ascending), in numpy."""
    a = x.numpy().astype(np.float64)
    order = np.lexsort((np.arange(a.size), -a))[:k].copy()
    idx = torch.from_numpy(order)
    return x[idx], idx


def _high_index_topk(x, k):
    """What torch.topk is free to return: ties by the HIGHER index."""
    v, i = stable_topk(x.flip(-1), k)
    return v, x.shape[-1] - 1 - i


@pytest.mark.parametrize("n,k", [(1, 1), (17, 5), (1000, 1000), (4096, 64),
                                 (70000, 4096)])
def test_topk_low_index_equals_numpy(n, k):
    """Many exact ties, both zeros, infinities, denormals and the slot
    sentinels: values and indices equal the numpy rule and stable_topk."""
    rng = np.random.default_rng(n)
    pool = np.array([-3.0, -1.0, -0.0, 0.0, 0.5, 1.0, 7.0, np.inf, -np.inf,
                     1e-40, -1e-40, 2.9999998, 3.0], np.float32)
    x = torch.from_numpy(rng.choice(pool, n))
    v, i = topk_low_index(x, k)
    wv, wi = _np_topk(x, k)
    assert torch.equal(i, wi) and torch.equal(v, wv)
    sv, si = stable_topk(x, k)
    assert torch.equal(i, si) and torch.equal(v, sv)
    with pytest.raises(ValueError):
        topk_low_index(x.to(torch.float64), k)


def _polygons(n, sides, centres, seed=8):
    """A sparse uniform fleet whose first sides * len(centres) objects form
    regular polygons closing on their centres at 10 m/s from 30 m, every
    other object moved at least 250 m away from them and parked: each
    polygon row holds sides - 1 qualifying pairs."""
    d = np_fleet(seed, n, 2000.0, clustered=0.0)
    c = np.asarray(centres, np.float32)
    stars = sides * len(centres)
    near = np.linalg.norm(d["pos"][:, None, :2] - c[None],
                          axis=-1).min(axis=1) < 250.0
    near[:stars] = False
    d["pos"][near, :2] = (50.0, 1950.0)
    d["vel"][near] = 0.0
    ang = np.arange(sides) * (2 * np.pi / sides) + 0.3
    for s, (cx, cy) in enumerate(centres):
        sl = slice(sides * s, sides * (s + 1))
        d["pos"][sl] = np.stack([cx + 30 * np.cos(ang), cy + 30 * np.sin(ang),
                                 np.zeros(sides)], -1)
        d["vel"][sl] = np.stack([-10 * np.cos(ang), -10 * np.sin(ang),
                                 np.zeros(sides)], -1)
        d["heading"][sl] = np.mod(ang + np.pi, 2 * np.pi)
    return d


def _k1_cfg(n):
    cfg = jax_cfg(n, mode="fast")
    return cfg.replace(alerts=dataclasses.replace(
        cfg.alerts, max_alerts_per_object=1))


def _xla_qual(cfg, jst):
    """Per-object qualifying pair counts of the reference-shaped path."""
    pairs = make_detect(cfg)(jst)
    return (np.asarray(pairs.valid)
            & (np.asarray(pairs.risk) >= cfg.alerts.risk_low)).sum(axis=1)


def test_hot_rows_beyond_the_topup_against_jax():
    """18 hot rows of equal qual (six triangles, k = 1) against hot_topup =
    8: the port covers the 8 hot rows of lowest sorted index, the JAX
    package (its two-stage scan, in its own layout) covers the same
    objects, and the fused scenes of both sides (the JAX one through the
    Pallas kernel in interpret mode) agree on every counter."""
    n, k, H = 300, 1, 8
    centres = [(350, 350), (1000, 350), (1650, 350), (350, 1000),
               (1000, 1000), (1650, 1000)]
    cfg = _k1_cfg(n)
    assert cfg.detect.hot_topup == H
    jst, st = both_states(_polygons(n, 3, centres))
    qual = _xla_qual(cfg, jst)
    assert (qual[:18] == 2).all() and (qual[18:] <= k).all()

    tcfg = to_torch_cfg(cfg)
    cl = build_cell_list(st, tcfg)
    s = fused_topk(cl, tcfg, "hits")
    covered = refine._hot_topup(cl, tcfg, s.qual, k)[0].numpy()
    hot_rows = np.flatnonzero(s.qual.numpy() > k)
    assert hot_rows.size == 18
    np.testing.assert_array_equal(np.flatnonzero(covered), hot_rows[:H])
    to = refine.fused_scene_fast(cl, tcfg)

    jcl = jax_build(jst, cfg)
    joid, jown = np.asarray(jcl.oid_flat), np.asarray(jcl.own_flat)
    jqual = np.where(jown, qual[np.clip(joid, 0, n - 1)], 0).astype(np.int32)
    jcov = np.asarray(jax_refine._hot_topup(jcl, cfg, jax.numpy.asarray(jqual),
                                            k)[0])
    assert set(joid[jcov].tolist()) == set(cl.oid.numpy()[covered].tolist())
    jo = jax_refine.fused_scene_fast(jcl, cfg, interpret=True)
    assert int(jo.alert_overflow) == int(to.alert_overflow) == (18 - H) * 1
    for f in ("num_risks", "num_checked"):
        assert int(getattr(jo, f)) == int(getattr(to, f)), f
    assert to.num_checked.dtype == torch.int32
    assert np.asarray(jo.num_checked).dtype == np.int32
    assert int(jo.alerts.count) == int(to.alerts.count)


def test_hot_rows_of_mixed_qual_follow_the_ports_rule():
    """Three pentagons (rows of 4 and of 3 qualifying pairs, k = 1): nine
    rows tie at qual 4 for hot_topup = 8 places. The port covers by (qual
    descending, sorted row ascending); alert_overflow counts the rest."""
    n, k, H = 300, 1, 8
    cfg = _k1_cfg(n)
    jst, st = both_states(_polygons(
        n, 5, [(400, 400), (1000, 1000), (1600, 500)]))
    tcfg = to_torch_cfg(cfg)
    cl = build_cell_list(st, tcfg)
    q = fused_topk(cl, tcfg, "hits").qual
    np.testing.assert_array_equal(np.sort(q.numpy()[q.numpy() > k]),
                                  np.sort(_xla_qual(cfg, jst)[:15]))
    assert int((q == 4).sum()) > H > int((q > 4).sum())
    covered = refine._hot_topup(cl, tcfg, q, k)[0].numpy()
    want = np.lexsort((np.arange(cl.n), -q.numpy()))[:H]
    np.testing.assert_array_equal(np.flatnonzero(covered), np.sort(want))
    to = refine.fused_scene_fast(cl, tcfg)
    assert int(to.alert_overflow) == int(
        np.maximum(q.numpy() - k, 0)[~covered].sum()) > 0


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_scene_budget_binding_on_tied_keys(mode, monkeypatch):
    """Weights that clip most risks at exactly 1.0 and a scene budget of 16:
    the budget binds inside a run of equal keys. Two runs give the same
    ordered alert list; so does the run whose selections are made in numpy
    by (key descending, index ascending); a selection that takes ties by
    the higher index keeps other pairs, so the fleet does discriminate."""
    n = 400
    cfg = jax_cfg(n, mode=mode, alerts=16, weight_speed=2.0,
                  max_relative_speed=1.0)
    _, st = both_states(np_fleet(5, n, 2000.0, accel=mode == "precise"))
    tcfg = to_torch_cfg(cfg)

    def run():
        out = tt.engine.detect_and_alerts_fused(st, tcfg)
        a = out.alerts
        assert int(a.count) == 16 < int(out.num_risks)
        assert int((a.risk == 1.0).sum()) >= 15
        return [a.vehicle_oid.tolist(), a.other_oid.tolist(),
                a.risk.tolist(), a.ttc.tolist(), a.priority.tolist()]

    first = run()
    assert run() == first
    monkeypatch.setattr(refine, "topk_low_index", _np_topk)
    assert run() == first
    monkeypatch.setattr(refine, "topk_low_index", _high_index_topk)
    other = run()
    assert set(zip(*other[:2])) != set(zip(*first[:2]))


# ---- conform_fleet, wide oids, the stage-1 counter ------------------------

def test_conform_fleet_equals_jax():
    """A 2D fleet with non-zero z, vz, az through both conform_fleets:
    every field equal, the three z columns zero; a 3D fleet is returned
    as it is."""
    d = np_fleet(2, 200, 2000.0, accel=True)
    rng = np.random.default_rng(3)
    for f in ("pos", "vel", "acc"):
        d[f][:, 2] = rng.normal(1.0, 5.0, 200).astype(np.float32)
    jst, st = both_states(d)
    cfg = jax_cfg(200)
    want = jax_conform_fleet(jst, cfg)
    got = conform_fleet(st, to_torch_cfg(cfg))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert not got.pos[:, 2].any() and st.pos[:, 2].any()
    cfg3 = to_torch_cfg(jax_cfg(200, is3d=True))
    assert conform_fleet(st, cfg3) is st


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_wide_oids_and_counter_through_the_fused_step(mode):
    """Oids past 2^24 (tests/test_wide_oid.py's BASE) and a 2D fleet that
    arrives with non-zero z columns, conformed on both sides: the port's
    fused step names the JAX step's alert pairs by their true ids, with
    equal counters, and num_pairs_checked is int32 on both sides."""
    base = 3 * (1 << 24) + 11
    n = 300
    cfg = jax_cfg(n, mode=mode)
    cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, wide_oid=True))
    d = np_fleet(5, n, 2000.0, accel=mode == "precise")
    d["oid"] = d["oid"] + base
    d["pos"][:, 2] = 40.0
    d["vel"][:, 2] = 3.0
    jst, st = both_states(d)
    tcfg = to_torch_cfg(cfg)
    _, jo = tc.make_step(cfg, donate=False)(jax_conform_fleet(jst, cfg),
                                            jax.random.key(1))
    _, to = tt.make_step(tcfg, backend="fused", device="cpu")(
        conform_fleet(st, tcfg), torch.Generator().manual_seed(0))
    assert int(jo.alert_overflow) == 0 and int(to.alert_overflow) == 0
    for f in ("num_risks", "num_pairs_checked", "num_alive"):
        assert int(getattr(to, f)) == int(getattr(jo, f)), f
    assert to.num_pairs_checked.dtype == torch.int32
    assert np.asarray(jo.num_pairs_checked).dtype == np.int32
    want, got = alert_map(jo.alerts), alert_map(to.alerts)
    assert len(want) > 10 and all(a >= base for a, _ in got)
    assert_alerts_equal(want, got)


# ---- chip_smoke's certificate rule ----------------------------------------

def test_certified_precise_adopts_k_and_cap():
    """chip_smoke.certified_precise against a scripted run: survivor_k
    rises by the counted shortfall up to K_MAX, the survivor cap doubles
    alongside, at most twice; a cell that stays uncertified is returned
    with its certificate for the caller to refuse."""
    import chip_smoke as cs
    cfg = tt.SystemConfig(num_objects=1000, detect=tt.DetectionConfig(
        mode="precise"))
    seen = []

    def run_with(worst):
        it = iter(worst)

        def run(c):
            seen.append((c.detect.survivor_k, c.survivor_cap))
            return next(it), "out"
        return run

    got, ao, out, tries = cs.certified_precise(cfg, run_with([4, 0]))
    assert (ao, out, tries) == (0, "out", 2)
    assert seen == [(8, 4096), (12, 8192)]
    assert got.detect.survivor_k == 12 and got.survivor_cap == 8192
    seen.clear()
    got, ao, _, tries = cs.certified_precise(cfg, run_with([0]))
    assert got is cfg and ao == 0 and tries == 1
    seen.clear()
    got, ao, _, tries = cs.certified_precise(cfg, run_with([100, 7, 3]))
    assert seen == [(8, 4096), (16, 8192), (16, 16384)]
    assert (ao, tries) == (3, 3) and got.detect.survivor_k == 16


def test_certified_adopts_k_in_fast_mode():
    """chip_smoke.certified on a fast cell (bench.py:201-209):
    max_alerts_per_object rises by the counted shortfall up to 16, at most
    twice, and the rule stops when k cannot rise; the survivor settings
    stay as they were."""
    import chip_smoke as cs
    cfg = tt.SystemConfig(num_objects=1000,
                          detect=tt.DetectionConfig(mode="fast"),
                          alerts=tt.AlertConfig(max_alerts_per_object=8))
    seen = []

    def run_with(worst):
        it = iter(worst)

        def run(c):
            seen.append((c.alerts.max_alerts_per_object, c.detect.survivor_k,
                         c.survivor_cap))
            return next(it), "out"
        return run

    got, ao, out, tries = cs.certified(cfg, run_with([5, 0]))
    assert (ao, out, tries) == (0, "out", 2)
    assert seen == [(8, 8, 4096), (13, 8, 4096)]
    assert got.alerts.max_alerts_per_object == 13
    seen.clear()
    got, ao, _, tries = cs.certified(cfg, run_with([0]))
    assert got is cfg and ao == 0 and tries == 1
    seen.clear()
    got, ao, _, tries = cs.certified(cfg, run_with([3, 2, 1]))
    assert [s[0] for s in seen] == [8, 11, 13]
    assert (ao, tries) == (1, 3)
    seen.clear()
    got, ao, _, tries = cs.certified(cfg, run_with([100, 7, 3]))
    assert [s[0] for s in seen] == [8, 16]
    assert (ao, tries) == (7, 2) and got.alerts.max_alerts_per_object == 16
