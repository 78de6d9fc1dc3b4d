"""The port's trajectory prediction against the JAX package, on the same
numpy fleets and history ticks.

  * the history ring, trajectory classes, the merge and the grid path
    (predict_collisions) against the JAX functions of the same names;
  * the port's fused_predict, through the predict kernel's plain version
    (the CPU takes it), against the JAX package's predict_collisions on the
    fixtures of tests/test_fused_predict.py made with numpy.

History and classes are exact. Predicted risks and ttcs agree within
rtol = atol = 1e-5 (the port's and JAX's CPU reductions may sum the norms
in another order); the sets of (object, other) pairs are equal. The CUDA
kernel is held against its plain version on the card by chip_smoke.py; its
dense fleet (chip_smoke.dense_fleet) is pinned to the JAX package here at a
small size, and the bound that lets the kernel compare squared distances is
checked in numpy."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, SystemConfig, WorldConfig)
from tpu_collide.detect import predict as jpred
from tpu_collide.index.grid import build_grid as jax_build_grid
from tpu_collide_torch.api.scene import _predict_device
from tpu_collide_torch.engine import make_predict
from tpu_collide_torch.core.ops import stable_topk
from tpu_collide_torch.detect import predict as tpred
from tpu_collide_torch.engine import grid_overflow
from tpu_collide_torch.index.grid import (build_grid, cell_coords,
                                          gather_candidates)
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.cell_list import FI, build_cell_list
from tpu_collide_torch.kernels.fused_detect import (predict_topk,
                                                    predict_topk_plain)
from tpu_collide_torch.kernels.refine import fused_predict
from chip_smoke import PRED_QUEUE, WARP, dense_fleet, predict_edges
from tpu_collide_torch.shard.halo import XCHG_FIELDS, extend_with_halo
from tests.torch_parity import both_states, np_fleet, to_torch_cfg
from predict_merge_cases import adversarial_slots, assert_bits_equal

torch.set_num_threads(1)
TOL = 1e-5
# one compiled program per shape instead of one per eager op
_jax_update = jax.jit(jpred.update_history)
_jax_merge = jax.jit(jpred.merge_pair_risks, static_argnums=(5, 6))
_jax_classify = jax.jit(jpred.classify_trajectories)
_jax_predict_collisions = jax.jit(
    jpred.predict_collisions,
    static_argnames=("cfg", "horizon", "step", "merge_k"))


# ---- fleets and history ticks, made with numpy --------------------------

def _state_dict(pos, vel, acc=None, seed=0, otype=None):
    n = pos.shape[0]
    rng = np.random.default_rng(seed)
    heading = np.arctan2(vel[:, 1], vel[:, 0]).astype(np.float32)
    otype = rng.integers(0, 4, n) if otype is None else otype
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(pos=f32(pos), vel=f32(vel),
                acc=f32(np.zeros((n, 3)) if acc is None else acc),
                heading=heading,
                size=np.array([2.0, 4.0, 5.0, 1.0], np.float32)[otype],
                otype=otype.astype(np.int32), alive=np.ones(n, bool),
                oid=np.arange(n, dtype=np.int32))


def _with_classes(d, seed):
    """A third of the fleet stationary, a third accelerating (|a| >= 1 m/s^2,
    far from the 0.1 threshold), the rest at constant velocity."""
    d = dict(d)
    n = d["pos"].shape[0]
    rng = np.random.default_rng(seed + 100)
    vel, acc = d["vel"].copy(), d["acc"].copy()
    vel[0::3] = 0.0
    a = rng.uniform(1.0, 3.0, n) * np.sign(rng.normal(size=n))
    ang = rng.uniform(0, 2 * np.pi, n)
    acc[2::3, 0] = (a * np.cos(ang))[2::3]
    acc[2::3, 1] = (a * np.sin(ang))[2::3]
    d["vel"], d["acc"] = vel.astype(np.float32), acc.astype(np.float32)
    return d


def _advance(d, dt):
    """The fleet after dt under constant acceleration (numpy f32)."""
    d = dict(d)
    f = np.float32(dt)
    d["pos"] = (d["pos"] + d["vel"] * f
                + np.float32(0.5) * d["acc"] * f * f).astype(np.float32)
    d["vel"] = (d["vel"] + d["acc"] * f).astype(np.float32)
    return d


def _ticks(d, ticks=4, dt=0.1, capacity=16):
    """(fleet after the ticks, JAX history, port history): each tick
    records the fleet in both packages, then the fleet moves by dt (the
    fixture of tests/test_fused_predict.py)."""
    n = d["pos"].shape[0]
    jh = jpred.empty_history(n, capacity)
    th = tpred.empty_history(n, capacity, device="cpu")
    t = 0.0
    for _ in range(ticks):
        t += dt
        jst, st = both_states(d)
        jh = _jax_update(jh, jst, t)
        th = tpred.update_history(th, st, t)
        d = _advance(d, dt)
    return d, jh, th


def _cfg(hi, ticked):
    """The fixture's config with a fleet-exact cell_capacity (the largest
    bucket of the ticked fleet), so that the grid path truncates nothing
    and gathers no more than it must."""
    d = ticked[0]
    n = d["pos"].shape[0]
    cfg = SystemConfig(
        num_objects=n, world=WorldConfig(hi=hi),
        grid=GridConfig(cell_size=100.0),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=8192))
    _, st = both_states(d)
    starts = build_grid(st.pos, st.alive, to_torch_cfg(cfg)).starts
    cap = int((starts[1:cfg.num_cells + 1] - starts[:cfg.num_cells]).max())
    return (cfg.replace(grid=GridConfig(cell_size=100.0, cell_capacity=cap)),
            *ticked)


def _fleet_with_history(seed, n=300, world=1500.0, classes=False):
    """tests/test_fused_predict.py::_fleet_with_history in numpy (a
    clustered 2D fleet); `classes` mixes in stationary and accelerating
    objects."""
    d = np_fleet(seed, n, world)
    if classes:
        d = _with_classes(d, seed)
    return _cfg((world, world, 0.0), _ticks(d))


def _fleet_3d(n=150):
    """tests/test_fused_predict.py's 3D fleet in numpy: uniform in a
    600 x 600 x 300 m world, vertical speeds N(0, 3)."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 600.0, (n, 3))
    pos[:, 2] = rng.uniform(0.0, 300.0, n)
    heading = rng.uniform(0, 2 * np.pi, n)
    speed = rng.uniform(5.0, 20.0, n)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                    rng.normal(0.0, 3.0, n)], -1)
    return _cfg((600.0, 600.0, 300.0), _ticks(_state_dict(pos, vel)))


def _converging_cluster(n=96, seed=1, r_lo=30.0, r_hi=70.0):
    """tests/test_fused_predict.py::_converging_cluster: n objects on a ring
    all heading at one point, so every offset is hit-dense and per-offset
    slot truncation is certain at small k_slots."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    r0 = rng.uniform(r_lo, r_hi, n)
    pos = np.zeros((n, 3), np.float32)
    pos[:, 0] = 500.0 + r0 * np.cos(ang)
    pos[:, 1] = 500.0 + r0 * np.sin(ang)
    vel = np.zeros((n, 3), np.float32)
    sp = rng.uniform(4, 7, n)
    vel[:, 0] = -sp * np.cos(ang)
    vel[:, 1] = -sp * np.sin(ang)
    d = _state_dict(pos, vel, otype=np.zeros(n, np.int64))
    d["heading"] = np.zeros(n, np.float32)
    return _cfg((1000.0, 1000.0, 0.0), _ticks(d))


def _dense(hi):
    """chip_smoke.py's dense fleet at a size the CPU takes: 200 objects
    crowd one cell, 100 are spread over the world."""
    d = dense_fleet(200, 100, hi, 100.0, seed=13)
    d.pop("cls")        # the classes come from the history here
    return _cfg(hi, _ticks(d))


FIXTURES = {
    "seed0": lambda: _fleet_with_history(0),
    "seed1": lambda: _fleet_with_history(1),
    "classes": lambda: _fleet_with_history(2, classes=True),
    "3d": _fleet_3d,
    "cluster": _converging_cluster,
    "dense": lambda: _dense((1500.0, 1500.0, 0.0)),
    "dense3d": lambda: _dense((600.0, 600.0, 300.0)),
}
HORIZON = {"3d": 2.0, "cluster": 10.0, "dense3d": 2.0}
_JAX_CACHE = {}


def _jax_predict(name, merge_k=32):
    """JAX predict_collisions on a fixture (cached per module)."""
    key = (name, merge_k)
    if key not in _JAX_CACHE:
        cfg, d, jh, _ = FIXTURES[name]()
        jst, _ = both_states(d)
        index = jax_build_grid(jst.pos, jst.alive, cfg)
        _JAX_CACHE[key] = tuple(np.asarray(x) for x in _jax_predict_collisions(
            jst, jh, index, cfg=cfg, horizon=HORIZON.get(name, 5.0),
            step=0.5, merge_k=merge_k))
    return _JAX_CACHE[key]


def _risk_map(other, valid, risk, ttc, *_):
    v, o = np.asarray(valid), np.asarray(other)
    r, t = np.asarray(risk), np.asarray(ttc)
    return {(i, int(o[i, k])): (float(r[i, k]), float(t[i, k]))
            for i in range(v.shape[0]) for k in np.nonzero(v[i])[0]}


def _assert_maps_equal(got, want):
    gm, wm = _risk_map(*got), _risk_map(*want)
    assert wm, "the fleet produced no predicted risks; the test is vacuous"
    assert set(gm) == set(wm), (sorted(set(wm) - set(gm))[:5],
                                sorted(set(gm) - set(wm))[:5])
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL,
                                   err_msg=str(k))


def _np(xs):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in xs)


# ---- history and classes -------------------------------------------------

def _hist_equal(th, jh):
    for f in tpred.HISTORY_FIELDS:
        np.testing.assert_array_equal(getattr(th, f).numpy(),
                                      np.asarray(getattr(jh, f)), f)


@pytest.mark.parametrize("capacity,ticks", [(16, 4), (4, 7), (3, 1)])
def test_history_and_classes_match_jax(capacity, ticks):
    """Ring contents, counts and heads after the ticks (wrapped rings
    included, dead objects never written), the three classes and the
    fallback mask all equal the JAX package's."""
    d = _with_classes(np_fleet(4, 240, 1500.0), 4)
    d["alive"] = np.arange(240) % 17 != 5
    d, jh, th = _ticks(d, ticks=ticks, capacity=capacity)
    _hist_equal(th, jh)
    assert th.capacity == capacity
    got = tpred.classify_trajectories(th)
    want = np.asarray(_jax_classify(jh))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpred.needs_fallback(th).numpy(),
                                  np.asarray(jpred.needs_fallback(jh)))
    if ticks >= 3:
        assert set(np.unique(want)) == {0, 1, 2}


def test_history_crosses_over_from_jax():
    """history_from_jax_numpy carries the JAX ring across unchanged, and the
    port's class-predicted positions equal JAX's."""
    d = _with_classes(np_fleet(6, 120, 1500.0), 6)
    d, jh, _ = _ticks(d, ticks=5)
    th = tpred.history_from_jax_numpy(
        {f: np.asarray(getattr(jh, f)) for f in tpred.HISTORY_FIELDS},
        device="cpu")
    _hist_equal(th, jh)
    jst, st = both_states(d)
    cls = tpred.classify_trajectories(th)
    for t in (0.0, 2.5, 9.5):
        got = tpred._predicted_position(
            st, cls, torch.tensor(t, dtype=torch.float32))
        want = jpred._predicted_position(
            jst, jnp.asarray(cls.numpy()), jnp.float32(t))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tpred.history_from_jax_numpy({"pos": np.zeros((1, 2, 3))})


# ---- the merge -----------------------------------------------------------

def _merge_inputs(seed, n=40, m=24):
    """[n, m] pools with exact risk ties (risks from a small set, 1.0 the
    clip value) and others that recur within a row."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, 6, (n, m)).astype(np.int32)
    hit = rng.random((n, m)) < 0.6
    risk = rng.choice(np.array([0.25, 0.5, 0.75, 1.0], np.float32), (n, m))
    ttc = rng.choice(np.array([1.0, 2.5, 4.0], np.float32), (n, m))
    dist = rng.uniform(0, 5, (n, m)).astype(np.float32)
    return cand, hit, risk, ttc, dist


@pytest.mark.parametrize("seed,merge_k", [(0, 8), (1, 16), (2, 32)])
def test_merge_pair_risks_matches_jax(seed, merge_k):
    """Equal outputs, the pre-dedup merge_k-th risk included, on pools with
    exact ties (merge_k = 32 pads the 24-column pool)."""
    args = _merge_inputs(seed)
    want = _jax_merge(*map(jnp.asarray, args), merge_k, True)
    got = tpred.merge_pair_risks(*map(torch.tensor, args), merge_k,
                                 return_kth=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stable_topk_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0]])
    v, i = stable_topk(x, 3, dim=1)
    assert i.tolist() == [[1, 2, 4], [4, 0, 1]]
    assert v.tolist() == [[3.0, 3.0, 3.0], [1.0, 0.0, 0.0]]


# ---- the grid path -------------------------------------------------------

def _port_inputs(name):
    cfg, d, _, th = FIXTURES[name]()
    _, st = both_states(d)
    return cfg, to_torch_cfg(cfg), st, th


@pytest.mark.parametrize("name", ["seed0", "classes", "3d"])
def test_predict_collisions_matches_jax(name):
    cfg, tcfg, st, th = _port_inputs(name)
    index = build_grid(st.pos, st.alive, tcfg)
    assert int(grid_overflow(index, tcfg)) == 0
    got = tpred.predict_collisions(st, th, index, tcfg,
                                   horizon=HORIZON.get(name, 5.0), step=0.5)
    _assert_maps_equal(_np(got), _jax_predict(name))


@pytest.mark.parametrize("name", ["classes", "dense3d"])
def test_predict_collisions_equals_predict_pairs(monkeypatch, name):
    """The grid path (predict_collisions, [N, K] tables) and the fused
    tail's recompute (refine._predict_pairs, [P] record lists) give the same
    bits on the same (own, candidate) pairs at one offset: the grid
    candidates of each object's predicted cell, mapped to sorted rows
    through the cell list's order, merged by the same merge_pair_risks."""
    _, tcfg, st, th = _port_inputs(name)
    offset, n = 1.5, st.n
    monkeypatch.setattr(tpred, "predict_offsets", lambda *_: [offset])
    index = build_grid(st.pos, st.alive, tcfg)
    t = torch.tensor(offset, dtype=torch.float32)
    cls = tpred.classify_trajectories(th)
    pred = tpred.class_advance(st.pos, st.vel, st.acc, cls, t)
    cand, ok = gather_candidates(index, cell_coords(pred, tcfg), tcfg)
    merge_k = cand.shape[1]           # one offset: no pair is cut or merged
    want = tpred.predict_collisions(st, th, index, tcfg, horizon=2.0,
                                    step=0.5, merge_k=merge_k)
    ok = ok & (cand != torch.arange(n)[:, None])
    at = ok.nonzero(as_tuple=True)
    cl = build_cell_list(st, tcfg, cls=cls)
    inv = torch.empty_like(cl.order)
    inv[cl.order] = torch.arange(n)
    other, *vals = refine._predict_pairs(
        cl, inv[at[0]], inv[cand[at].to(torch.int64)],
        t.expand(at[0].numel()), tcfg, sub_window=1.0)
    assert torch.equal(other, cand[at])
    assert int(vals[0].sum()) > 20       # not vacuous
    cols = [cand.clone()] + [torch.full(cand.shape, fill, dtype=v.dtype)
                             for v, fill in zip(vals, refine._POOL_FILL[1:])]
    for col, v in zip(cols[1:], vals):
        col[at] = v
    got = tpred.merge_pair_risks(*cols, merge_k)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


# ---- the kernel path (the predict kernel's plain version) ---------------

@pytest.mark.parametrize("name", ["seed0", "seed1", "classes", "3d"])
def test_fused_predict_matches_jax(name):
    cfg, tcfg, st, th = _port_inputs(name)
    launches = predict_topk.launches
    got = fused_predict(st, th, tcfg, horizon=HORIZON.get(name, 5.0),
                        step=0.5)
    assert predict_topk.launches == launches      # CPU: the plain version
    assert int(got[5]) == 0 and int(got[6]) == 0
    _assert_maps_equal(_np(got[:5]), _jax_predict(name))


@pytest.mark.parametrize("name", ["dense", "dense3d"])
def test_dense_fleet_matches_jax(name):
    """The dense fleet of chip_smoke.py's predict_kernel_vs_plain, small:
    it drives what the kernel's walk must get right (a run longer than
    twice its ring of stage-1 survivors, a ring that holds survivors across
    a sweep round, a last round that is not full, more hits than slots),
    and the plain version's answer on it, merged and certified, equals the
    JAX package's grid path."""
    cfg, tcfg, st, th = _port_inputs(name)
    horizon = HORIZON.get(name, 5.0)
    cls = tpred.classify_trajectories(th)
    cl = build_cell_list(st, tcfg, cls=cls)
    offs = torch.tensor(tpred.predict_offsets(horizon, 0.5),
                        dtype=torch.float32)
    edges = predict_edges(cl, tcfg, offs, torch)
    assert edges["longest_run"] > 2 * PRED_QUEUE, edges
    assert edges["most_waiting"] > WARP, edges
    assert any(r % WARP for r in edges["last_rounds"]), edges
    slots = predict_topk_plain(cl, tcfg, offs, 16, 10)
    assert int(slots.emitted.max()) > 16
    got = fused_predict(st, th, tcfg, horizon=horizon, step=0.5)
    assert int(got[5]) == 0 and int(got[6]) == 0
    assert int(got[7]) > 0, "no slot was evicted; the test is vacuous"
    _assert_maps_equal(_np(got[:5]), _jax_predict(name))


def _sqrt_le_bound(s):
    """csrc/fused_predict.cu's sqrt_le_bound, expression by expression, in
    numpy: the largest float32 T with sqrt(T) <= s."""
    s = np.float32(s)
    if not s >= 0.0:
        return s if s != s else np.float32(-1.0)
    if np.isinf(s):
        return s
    a = np.abs(s)
    up = (a.view(np.int32) + np.int32(1)).view(np.float32)
    m2 = (0.5 * (np.float64(a) + np.float64(up))) ** 2
    with np.errstate(over="ignore"):
        t = np.float32(m2)              # to nearest; then down, as _rd does
    if np.isinf(t) or np.float64(t) > m2:
        t = np.nextafter(t, np.float32(-np.inf))
    return min(t, np.finfo(np.float32).max)


def test_sqrt_le_bound_decides_as_the_square_root():
    """x <= sqrt_le_bound(s) equals sqrt(x) <= s in float32: for random s,
    the edges of the format, and every x within 6 ulp of s*s and of the
    bound, NaN, inf and 0 included. The predict kernel relies on it to
    compare squared distances."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    big = np.finfo(f32).max
    ss = np.concatenate([
        rng.uniform(0.0, 200.0, 1500), 10.0 ** rng.uniform(-44, 38.5, 1500),
        [0.0, -0.0, 1e-45, 3.7e-23, 1.0, 2.0, 4.0, 5.5, 50.0, 100.0,
         1.8446743e19, 1.8446744e19, big, np.inf, -1.0, np.nan]]).astype(f32)
    for s in ss:
        bound = _sqrt_le_bound(s)
        with np.errstate(over="ignore", invalid="ignore"):
            xs = [f32(0.0), f32(np.inf), f32(np.nan)]
            for c in (np.minimum(s * s, big), bound):
                lo = hi = c
                xs.append(c)
                for _ in range(6):
                    lo = np.nextafter(lo, f32(-np.inf))
                    hi = np.nextafter(hi, f32(np.inf))
                    xs += [lo, hi]
            xs = np.array([x for x in xs if not x < 0.0], f32)
            np.testing.assert_array_equal(xs <= bound, np.sqrt(xs) <= s,
                                          err_msg=repr(s))


def test_truncation_certificate_harmless():
    """Truncations that cannot reach the merged top merge_k are counted in
    slot_trunc and certified (slot_oflow 0); the merged output equals the
    reference path's."""
    cfg, tcfg, st, th = _port_inputs("cluster")
    got = fused_predict(st, th, tcfg, horizon=10.0, step=0.5, k_slots=8,
                        merge_k=8)
    assert int(got[5]) == 0
    assert int(got[7]) > 0, "no truncations; the test is vacuous"
    assert int(got[6]) == 0
    _assert_maps_equal(_np(got[:5]), _jax_predict("cluster", merge_k=8))


def test_truncation_certificate_flags_loss():
    """With the hot top-up off and merge_k wider than the slots can feed,
    the certificate refuses (slot_oflow > 0)."""
    cfg, tcfg, st, th = _port_inputs("cluster")
    tcfg = tcfg.replace(detect=dataclasses.replace(tcfg.detect, hot_topup=0))
    got = fused_predict(st, th, tcfg, horizon=10.0, step=0.5, k_slots=8,
                        merge_k=16)
    assert int(got[7]) > 0
    assert int(got[6]) > 0


def test_hot_topup_repairs_lossy_point():
    """The same operating point with the hot top-up on comes back certified
    and equal to the reference path."""
    cfg, tcfg, st, th = _port_inputs("cluster")
    got = fused_predict(st, th, tcfg, horizon=10.0, step=0.5, k_slots=8,
                        merge_k=16)
    assert int(got[5]) == 0
    assert int(got[7]) > 0
    assert int(got[6]) == 0
    _assert_maps_equal(_np(got[:5]), _jax_predict("cluster", merge_k=16))


def test_predict_topk_plain_chunking_and_slots():
    """Chunking the pair enumeration changes nothing; slots hold the class
    in the record, are ordered by risk, and count hits exactly."""
    cfg, tcfg, st, th = _port_inputs("classes")
    cls = tpred.classify_trajectories(th)
    cl = build_cell_list(st, tcfg, cls=cls)
    np.testing.assert_array_equal(cl.fields[:, FI["cls"]].numpy(),
                                  cls[cl.order].numpy().astype(np.float32))
    offs = torch.tensor([0.0, 1.5, 4.5], dtype=torch.float32)
    a = predict_topk_plain(cl, tcfg, offs, 4, 10)
    b = predict_topk_plain(cl, tcfg, offs, 4, 10, max_pairs=300)
    for f in ("keys", "idx", "emitted"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.keys.shape == (3, st.n, 4) and a.emitted.shape == (3, st.n)
    occupied = a.idx >= 0
    assert torch.equal(occupied.sum(2), torch.clamp_max(a.emitted, 4))
    assert (a.keys[:, :, :-1] >= a.keys[:, :, 1:]).all()
    assert int(a.emitted.sum()) > 0
    with pytest.raises(ValueError):
        predict_topk(cl, tcfg, offs, 33, 10)   # past K_MAX = 32


def test_predict_device_paths_agree_with_jax():
    """_predict_device (grid) against the JAX package's, and the fused
    variant against it: the compacted (vehicle, other) risks are equal."""
    from tpu_collide.api.scene import _predict_device as jax_predict_device
    cfg, d, jh, th = FIXTURES["seed1"]()
    jst, st = both_states(d)
    tcfg = to_torch_cfg(cfg)
    want = jax.jit(jax_predict_device, static_argnums=(2, 3, 4, 5))(
        jst, jh, cfg, 5.0, 0.5, 4096)
    grid = _predict_device(st, th, tcfg, 5.0, 0.5, 4096)
    fused = make_predict(tcfg, 5.0, 0.5, k_slots=16, r_cap=4096,
                         device="cpu")(st, th)
    assert [int(x) for x in grid[5:]] == [int(x) for x in want[5:]]
    assert int(fused[5]) == int(want[5]) > 0
    assert [int(x) for x in fused[6:]][:2] == [0, 0]

    def pairs(out):
        c = int(out[5])
        r, v, o, t = (np.asarray(x)[:c] for x in out[:4])
        return {(int(a), int(b)): (float(x), float(y))
                for a, b, x, y in zip(v, o, r, t)}
    wm = pairs(want)
    for got in (grid, fused):
        gm = pairs(_np(got))
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], rtol=TOL, atol=TOL)


# ---- the merge per row (refine.merge_slots) -----------------------------

def _merge_rule(shape, at, vals, merge_k):
    """merge_slots by the rule its kernel (csrc/predict_merge.cu) follows, a
    row at a time in numpy: the row's valid hits (hit, risk >= 0) keyed by
    the risk's bits above and the column's complement below (-0.0 as +0.0);
    the merge_k largest keys kept, kth the last one's risk (-1 short of
    merge_k); the kept ranked by (other ascending, key descending), the
    first of each other id written there, every other place the fill."""
    n_off, m, k_slots = shape
    o, r, s = (x.numpy() for x in at)
    other, hit, risk, ttc, dist = (x.numpy() for x in vals)
    out = [np.zeros((m, merge_k), np.int32), np.zeros((m, merge_k), bool),
           np.zeros((m, merge_k), np.float32),
           np.full((m, merge_k), np.inf, np.float32),
           np.full((m, merge_k), np.inf, np.float32)]
    kth = np.full(m, -1.0, np.float32)
    col = (o * k_slots + s).astype(np.uint64)
    key = (((risk + np.float32(0.0)).view(np.uint32).astype(np.uint64)
            << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - col))
    ok = hit & (risk >= 0.0)
    for row in range(m):
        e = np.nonzero(ok & (r == row))[0]
        kept = e[np.argsort(key[e])[::-1][:merge_k]]
        if e.size >= merge_k:
            kth[row] = risk[kept[-1]]
        kept = kept[np.lexsort((~key[kept], other[kept]))]
        for j, x in enumerate(kept):
            if j == 0 or other[x] != other[kept[j - 1]]:
                for buf, v in zip(out, (other, hit, risk, ttc, dist)):
                    buf[row, j] = v[x]
    return tuple(torch.from_numpy(x) for x in out) + (torch.from_numpy(kth),)


@pytest.mark.parametrize("n_off,m,k_slots,merge_k", [
    (20, 64, 8, 32), (20, 48, 32, 32), (5, 40, 1, 4), (40, 24, 4, 32),
    (16, 40, 8, 100), (20, 24, 32, 300), (4, 24, 8, 300)])
def test_merge_slots_follows_the_kernels_rule(n_off, m, k_slots, merge_k):
    """The plain merge (the dense pool and merge_pair_risks) and the rule
    the kernel computes give the same bits on slot sets made to break a
    merge (tests/predict_merge_cases.adversarial_slots): full
    rows, rows past merge_k, one id at several offsets at equal and
    unequal risks, equal risks in different columns, empty rows."""
    slots = adversarial_slots(n_off, m, k_slots, 7 + m)
    got = refine.merge_slots(*slots, merge_k)
    assert_bits_equal(got, _merge_rule(*slots, merge_k))
    # no row holds merge_k hits where merge_k passes its columns
    assert bool(got[1].any())
    assert bool((got[5] >= 0).any()) == (merge_k <= n_off * k_slots)


_ROWS_INPUTS = {}


def _rows_inputs(halo):
    """(cfg, state, classes) of the dense fleet; with `halo`, its last 150
    objects are marked halo mirrors (shard/halo.extend_with_halo), as a
    shard's prediction holds them: candidates only."""
    if halo not in _ROWS_INPUTS:
        _, tcfg, st, th = _port_inputs("dense")
        cls = tpred.classify_trajectories(th)
        if halo:
            own_n = st.n - 150
            own = dataclasses.replace(st, **{
                f: getattr(st, f)[:own_n] for f in XCHG_FIELDS + ("alive",)})
            st = extend_with_halo(
                own, {f: getattr(st, f)[own_n:] for f in XCHG_FIELDS},
                torch.ones(st.n - own_n, dtype=torch.bool), mark_halo=True)
        _ROWS_INPUTS[halo] = (tcfg, st, cls)
    return _ROWS_INPUTS[halo]


def _dense_pool_rows(shape, at, vals, rows):
    """The hot top-up's pool as it was taken before merge_slots: the rows
    of the whole dense pool."""
    n_off, m, k_slots = shape
    return [x.permute(1, 0, 2).reshape(m, n_off * k_slots)[rows]
            for x in refine._pool(shape, rows.device, at, vals)]


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("merge_k", [4, 32])
@pytest.mark.parametrize("k_slots", [1, 8, 32])
def test_predict_rows_equal_the_dense_pool_path(monkeypatch, k_slots, merge_k,
                                                halo):
    """fused_predict_rows on the dense fleet as it runs (the hot top-up's
    pool built from the occupied slots of its rows), with the hot top-up's
    pool cut from the whole dense pool as before, and with the merge done
    by the kernel's rule: the same lists, counters and kth. At k_slots 1
    truncations go uncertified and the hot top-up runs."""
    cfg, st, cls = _rows_inputs(halo)
    kths, topups = [], []
    merge, pool_rows = refine.merge_slots, refine._slot_pool_rows

    def run(merge_fn, pool_fn):
        def spy(*a):
            out = merge_fn(*a)
            kths.append(out[5])
            return out
        monkeypatch.setattr(refine, "merge_slots", spy)
        monkeypatch.setattr(refine, "_slot_pool_rows",
                            lambda *a: topups.append(1) or pool_fn(*a))
        return refine.fused_predict_rows(st, cls, cfg, horizon=5.0, step=0.5,
                                         merge_k=merge_k, k_slots=k_slots)

    got = run(merge, pool_rows)
    assert bool(got[1].any())
    if k_slots == 1:
        assert int(got[9]) > 0 and topups
    for want in (run(merge, _dense_pool_rows), run(_merge_rule, pool_rows)):
        assert_bits_equal(got, want)
    for kth in kths[1:]:
        assert torch.equal(kth.view(torch.int32), kths[0].view(torch.int32))
    if halo:
        assert not bool(got[1][~got[6]].any())


@pytest.mark.slow
@pytest.mark.parametrize("k_slots,merge_k,hot_topup",
                         [(8, 8, 8), (8, 16, 0), (8, 16, 8)])
def test_truncation_counters_match_pallas_interpret(k_slots, merge_k,
                                                    hot_topup):
    """slot_trunc and slot_oflow against the JAX package's fused_predict
    through the Pallas kernel itself (interpret mode, minutes on a CPU), on
    the converging cluster."""
    from tpu_collide.kernels.refine import fused_predict as jax_fused_predict
    cfg, d, jh, th = FIXTURES["cluster"]()
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 hot_topup=hot_topup))
    jst, st = both_states(d)
    want = jax_fused_predict(jst, jh, cfg, horizon=10.0, step=0.5,
                             k_slots=k_slots, merge_k=merge_k,
                             interpret=True)
    got = fused_predict(st, th, to_torch_cfg(cfg), horizon=10.0, step=0.5,
                        k_slots=k_slots, merge_k=merge_k)
    assert int(want[5]) == int(got[5]) == 0
    assert (int(got[7]), int(got[6])) == (int(want[7]), int(want[6]))
    _assert_maps_equal(_np(got[:5]), tuple(np.asarray(x) for x in want[:5]))
