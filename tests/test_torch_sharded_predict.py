"""The port's sharded prediction (tpu_collide_torch/shard/predict.py)
against the JAX package's (tpu_collide/shard/predict.py) on the 8-device
CPU mesh, and the predict tail's own mask on a halo-extended state.

  * the xla backend against JAX's make_sharded_predict on 1D, 2D (4x2) and
    3D (2x1x2) meshes: equal pair maps (own oid, other oid) -> (risk, ttc,
    dist) at rtol / atol 1e-5, equal per-shard drops and grid overflows;
  * predict_reach and predict_hops as JAX's, and multi-hop bands on a 1D
    and a 2D mesh (a crafted pair two slabs apart, which one hop misses);
  * distribute_history slot for slot as JAX's under dynamic walls, and a
    history that migrates with its object;
  * the fused backend (the predict kernel's plain version on the CPU)
    against JAX's xla backend as pair sets joined on row_oid;
  * the predict tail on a state extended with marked halo mirrors: no
    mirror is a query row and every reported oid is real.

Fleets come from numpy (tests/torch_parity.np_fleet), N <= 300.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core.config import (AlertConfig, GridConfig, ShardConfig,
                                     SimConfig, WorldConfig)
from tpu_collide.core.state import ObjectState as JaxState
from tpu_collide.detect.predict import TrajectoryHistory as JaxHistory
from tpu_collide.detect.predict import predict_collisions as jax_predict
from tpu_collide.index.grid import build_grid as jax_build_grid
from tpu_collide.shard import predict as jpredict
from tpu_collide.shard import step as jstep
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.detect.predict import (classify_trajectories,
                                              history_from_jax_numpy)
from tpu_collide_torch.kernels.refine import fused_predict_rows
from tpu_collide_torch.shard import (collect_state, distribute_history,
                                     distribute_state, make_mesh,
                                     make_sharded_predict, make_sharded_step,
                                     predict_band, predict_hops,
                                     predict_reach,
                                     shard_generators)
from tpu_collide_torch.shard.halo import extend_with_halo
from tests.torch_parity import np_fleet, to_torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON, STEP = 3.0, 0.5        # reach 178 m: a band of 2 x halo_width
# (mesh grid, objects, halo_capacity): the 3D bands hold the most objects
MESHES = {"8x1": ((8, 1, 1), 300, 48), "4x2": ((4, 2, 1), 300, 48),
          "2x1x2": ((2, 1, 2), 200, 96)}


def mesh_cfg(grid, n=300, world=2000.0, halo_capacity=48):
    is3d = grid[2] > 1
    return tc.SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(world, world, 300.0) if is3d
                          else (world, world, 0.0)),
        # the fleets hold at most 15 objects a cell: no bucket truncates
        grid=GridConfig(cell_size=100.0, cell_capacity=16),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          num_shards_z=grid[2], halo_capacity=halo_capacity,
                          slot_headroom=3.0))


def np_history(d, ticks=3, dt=0.1, capacity=16):
    """A history of `ticks` samples whose last one is the fleet's position
    (positions rolled back along the velocities), as numpy arrays."""
    n = d["pos"].shape[0]
    h = dict(pos=np.zeros((n, capacity, 3), np.float32),
             t=np.full((n, capacity), -np.inf, np.float32),
             count=np.full(n, ticks, np.int32),
             head=np.full(n, ticks, np.int32))
    for i in range(ticks):
        h["pos"][:, i] = d["pos"] - d["vel"] * np.float32((ticks - 1 - i)
                                                           * dt)
        h["t"][:, i] = np.float32((i + 1) * dt)
    return h


def jax_inputs(d, h):
    return (JaxState(**{f: jnp.asarray(v) for f, v in d.items()}),
            JaxHistory(**{f: jnp.asarray(v) for f, v in h.items()}))


def port_inputs(d, h):
    return (ObjectState(**{f: torch.from_numpy(np.asarray(v).copy())
                           for f, v in d.items()}),
            history_from_jax_numpy(h, device="cpu"))


def pair_map(other, valid, risk, ttc, dist, oids):
    """{(own oid, other oid): (risk, ttc, dist)} of the valid entries."""
    a = [np.asarray(x) for x in (other, valid, risk, ttc, dist)]
    oids = np.asarray(oids)
    rows, cols = np.nonzero(a[1])
    return {(int(oids[i]), int(a[0][i, j])):
            (float(a[2][i, j]), float(a[3][i, j]), float(a[4][i, j]))
            for i, j in zip(rows, cols)}


def cat(parts):
    return torch.cat(list(parts)).numpy()


def assert_maps_equal(got, want):
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5],
                                   sorted(set(got) - set(want))[:5])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)


def single_device_map(jcfg, jst, jh, horizon, step):
    o, v, r, t, dd = jax.jit(lambda s, h: jax_predict(
        s, h, jax_build_grid(s.pos, s.alive, jcfg), jcfg, horizon=horizon,
        step=step))(jst, jh)
    oid = np.asarray(jst.oid)
    return pair_map(oid[np.asarray(o)], v, r, t, dd, oid)


@pytest.fixture(scope="module", params=list(MESHES), ids=list(MESHES))
def case(request):
    """One fleet per mesh through JAX's sharded xla prediction."""
    grid, n, cap = MESHES[request.param]
    jcfg = mesh_cfg(grid, n=n, halo_capacity=cap)
    d = np_fleet(21, n, 2000.0, is3d=grid[2] > 1)
    h = np_history(d)
    jst, jh = jax_inputs(d, h)
    jmesh = jstep.make_mesh(jcfg)
    st = jstep.distribute_state(jst, jcfg, jmesh)
    hs = jpredict.distribute_history(jh, jcfg, jmesh, jst)
    res = jpredict.make_sharded_predict(jcfg, jmesh, horizon=HORIZON,
                                        step=STEP)(st, hs)
    cfg = to_torch_cfg(jcfg)
    return dict(jcfg=jcfg, cfg=cfg, d=d, h=h,
                mesh=make_mesh(cfg, device="cpu"),
                want=pair_map(*res[:5], st.oid),
                dropped=np.asarray(res[5]), goflow=np.asarray(res[6]))


def test_xla_backend_matches_jax(case):
    cfg, mesh = case["cfg"], case["mesh"]
    state, hist = port_inputs(case["d"], case["h"])
    states = distribute_state(state, cfg, mesh)
    hists = distribute_history(hist, cfg, mesh, state)
    res = make_sharded_predict(cfg, mesh, horizon=HORIZON, step=STEP)(
        states, hists)
    assert len(res) == 7 and len(res[0]) == mesh.size
    got = pair_map(*(cat(c) for c in res[:5]),
                   cat(st.oid for st in states))
    assert case["want"], "fleet too tame: no predicted risks"
    assert_maps_equal(got, case["want"])
    np.testing.assert_array_equal(res[5].numpy(), case["dropped"])
    np.testing.assert_array_equal(res[6].numpy(), case["goflow"])
    assert int(res[5].sum()) == int(res[6].sum()) == 0


def test_fused_backend_matches_jax_xla(case):
    """The predict kernel per shard (its plain version here): the pair set
    and values of JAX's xla backend, joined on row_oid; mirrors and dead
    rows carry row_oid -1."""
    cfg, mesh = case["cfg"], case["mesh"]
    state, hist = port_inputs(case["d"], case["h"])
    states = distribute_state(state, cfg, mesh)
    hists = distribute_history(hist, cfg, mesh, state)
    res = make_sharded_predict(cfg, mesh, horizon=HORIZON, step=STEP,
                               backend="fused")(states, hists)
    assert len(res) == 8
    row_oid = cat(res[5])
    got = pair_map(*(cat(c) for c in res[:5]), row_oid)
    assert_maps_equal(got, case["want"])
    np.testing.assert_array_equal(res[6].numpy(), case["dropped"])
    assert int(res[7].sum()) == 0
    live = row_oid[row_oid >= 0]
    assert sorted(live.tolist()) == list(range(cfg.num_objects))


def test_reach_and_hops_match_jax():
    for grid in ((8, 1, 1), (2, 4, 1), (2, 2, 2)):
        jcfg = mesh_cfg(grid)
        cfg = to_torch_cfg(jcfg)
        for horizon, step in ((10.0, 0.5), (20.0, 2.0), (4.0, 0.5)):
            reach = predict_reach(cfg, horizon, step)
            assert reach == jpredict.predict_reach(jcfg, horizon, step)
            for dim in range(3):
                assert predict_hops(cfg, reach, dim) == \
                    jpredict.predict_hops(jcfg, reach, dim)
            # the band make_sharded_predict builds by default: JAX's hops
            # and its halo_capacity rule (tpu_collide/shard/predict.py)
            hops = tuple(jpredict.predict_hops(jcfg, reach, dim)
                         for dim in range(3))
            scale = -(-int(reach) // int(jcfg.shard.halo_width))
            assert predict_band(cfg, horizon, step) == (
                reach, hops,
                jcfg.shard.halo_capacity * max(1, -(-scale // max(hops))))
            assert predict_band(cfg, horizon, step, hops=3,
                                halo_capacity=7) == (reach, (3, 3, 3), 7)
    # 30 m/s * 9.5 s + 0.5 * 1 * 9.5^2 + the 100 m halo
    assert abs(predict_reach(cfg, 10.0, 0.5)
               - (100.0 + 30.0 * 9.5 + 0.5 * 9.5 ** 2)) < 1e-6


def crafted_pair(n, world, axis, arrival):
    """Background objects, a query at the upper edge of slab 0 along
    `axis` moving at 30 m/s, and a stationary candidate where the query
    arrives `arrival` s later, two slabs on (tests/
    test_sharded_predict.py:290-377)."""
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    pos[2:, 0] = (60.0 + 85.0 * np.arange(n - 2)) % world[0]
    pos[2:, 1] = np.tile([150.0, 800.0], n)[:n - 2]
    if axis == 0:
        pos[2:, 1] = 300.0 + 83.0 * np.arange(n - 2) % world[1]
    edge = world[axis] / 8 if axis == 0 else world[axis] / 4
    q = [1000.0, 1000.0, 0.0]
    q[axis] = edge - 5.0
    pos[0] = q
    vel[0, axis] = 30.0
    pos[1] = q
    pos[1, axis] += 30.0 * arrival
    return dict(pos=pos, vel=vel, acc=np.zeros((n, 3), np.float32),
                heading=np.zeros(n, np.float32),
                size=np.full(n, 2.0, np.float32),
                otype=np.zeros(n, np.int32), alive=np.ones(n, bool),
                oid=np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("grid,world,axis,horizon", [
    ((8, 1, 1), (4000.0, 4000.0), 0, 20.0),
    ((2, 4, 1), (2000.0, 2400.0), 1, 24.0)], ids=["1d", "2d"])
def test_multihop_matches_jax(grid, world, axis, horizon):
    """A band two slabs deep (reach 802 m on 500 m slabs, 1002 m on 600 m
    ones) rides the multi-hop chain: the crafted pair is found as on one
    device and as JAX finds it; one hop does not see it."""
    n, step = 24, 2.0
    jcfg = mesh_cfg(grid, n=n).replace(world=WorldConfig(
        hi=(world[0], world[1], 0.0)))
    cfg = to_torch_cfg(jcfg)
    reach = predict_reach(cfg, horizon, step)
    assert predict_hops(cfg, reach, axis) == 2
    d = crafted_pair(n, world, axis, horizon - step)
    h = np_history(d, dt=jcfg.sim.dt)
    jst, jh = jax_inputs(d, h)
    single = single_device_map(jcfg, jst, jh, horizon, step)
    assert (0, 1) in single
    jmesh = jstep.make_mesh(jcfg)
    st = jstep.distribute_state(jst, jcfg, jmesh)
    hs = jpredict.distribute_history(jh, jcfg, jmesh, jst)
    mesh = make_mesh(cfg, device="cpu")
    state, hist = port_inputs(d, h)
    states = distribute_state(state, cfg, mesh)
    hists = distribute_history(hist, cfg, mesh, state)
    oids = cat(s.oid for s in states)
    want = jpredict.make_sharded_predict(jcfg, jmesh, horizon=horizon,
                                         step=step)(st, hs)
    res = make_sharded_predict(cfg, mesh, horizon=horizon, step=step)(
        states, hists)
    got = pair_map(*(cat(c) for c in res[:5]), oids)
    assert_maps_equal(got, pair_map(*want[:5], st.oid))
    assert_maps_equal(got, single)
    np.testing.assert_array_equal(res[5].numpy(), np.asarray(want[5]))
    one = make_sharded_predict(cfg, mesh, horizon=horizon, step=step,
                               hops=1)(states, hists)
    assert (0, 1) not in pair_map(*(cat(c) for c in one[:5]), oids)


def test_distribute_history_matches_jax():
    """Under dynamic walls on a 4x2 mesh, every ring lands in the slot of
    its object, as in JAX's layout (dead slots empty)."""
    jcfg = mesh_cfg((4, 2, 1))
    d = np_fleet(22, jcfg.num_objects, 2000.0, dead=20)
    h = np_history(d)
    h["count"] = (np.arange(jcfg.num_objects) % 4).astype(np.int32)
    bx = np.array([0.0, 430.0, 1000.0, 1480.0, 2000.0], np.float32)
    by = np.array([0.0, 1130.0, 2000.0], np.float32)
    jst, jh = jax_inputs(d, h)
    jmesh = jstep.make_mesh(jcfg)
    want = jpredict.distribute_history(jh, jcfg, jmesh, jst, bx, by)
    cfg = to_torch_cfg(jcfg)
    mesh = make_mesh(cfg, device="cpu")
    state, hist = port_inputs(d, h)
    got = distribute_history(hist, cfg, mesh, state, torch.tensor(bx),
                             torch.tensor(by))
    assert len(got) == mesh.size
    for f in ("pos", "t", "count", "head"):
        np.testing.assert_array_equal(cat(getattr(g, f) for g in got),
                                      np.asarray(getattr(want, f)), f)
    states = distribute_state(state, cfg, mesh, torch.tensor(bx),
                              torch.tensor(by))
    host = collect_state(states)
    np.testing.assert_array_equal(
        cat(g.count for g in got)[host.alive.numpy()],
        h["count"][host.oid[host.alive].numpy()])


def test_history_migrates_with_its_object():
    """An object crossing a wall takes its recorded samples with it
    (tests/test_sharded_predict.py:103-143)."""
    jcfg = mesh_cfg((8, 1, 1), n=16, world=10_000.0)
    cfg = to_torch_cfg(jcfg)
    d_, w = 8, 10_000.0 / 8
    n = cfg.num_objects
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    for i in range(n):
        pos[i] = [(i % d_) * w + 300.0 + 10 * i, 5000.0, 0.0]
    pos[0] = [4 * w - 1.0, 5000.0, 0.0]
    vel[0] = [20.0, 0.0, 0.0]
    d = dict(pos=pos, vel=vel, acc=np.zeros((n, 3), np.float32),
             heading=np.zeros(n, np.float32),
             size=np.full(n, 2.0, np.float32), otype=np.zeros(n, np.int32),
             alive=np.ones(n, bool), oid=np.arange(n, dtype=np.int32))
    h = np_history(d, ticks=2)
    mesh = make_mesh(cfg, device="cpu")
    state, hist = port_inputs(d, h)
    states = distribute_state(state, cfg, mesh)
    hists = distribute_history(hist, cfg, mesh, state)
    step = make_sharded_step(cfg, mesh, backend="fused", with_history=True)
    states, hists, out, dropped = step(states, hists,
                                       shard_generators(mesh, 0))
    assert int(dropped.sum()) == 0
    where = [s for s, st in enumerate(states)
             if bool((st.alive & (st.oid == 0)).any())]
    assert where == [4]
    for st, hh in zip(states, hists):
        assert bool((hh.count[st.alive] == 2).all())


def test_predict_tail_masks_mirrors_and_decodes_oids():
    """fused_predict_rows on owned rows plus marked halo mirrors (the
    plain kernel): no mirror row is a query row, every reported oid is a
    real one (mirrors as candidates included), and the owned rows' pairs
    are those of the same state with the mirrors unmarked."""
    jcfg = mesh_cfg((8, 1, 1), n=240)
    cfg = to_torch_cfg(jcfg)
    d = np_fleet(23, 240, 2000.0)
    state, hist = port_inputs(d, np_history(d))
    own_n = 160
    own = ObjectState(**{f: getattr(state, f)[:own_n]
                         for f in ("pos", "vel", "acc", "heading", "size",
                                   "otype", "alive", "oid")})
    buf = {f: getattr(state, f)[own_n:] for f in
           ("pos", "vel", "acc", "heading", "size", "otype", "oid")}
    valid = torch.ones(240 - own_n, dtype=torch.bool)
    cls = classify_trajectories(hist)
    runs = {}
    for mark in (True, False):
        ext = extend_with_halo(own, buf, valid, mark_halo=mark)
        other, ok, risk, ttc, dist, soid, is_own, *_ = fused_predict_rows(
            ext, cls, cfg, horizon=HORIZON, step=STEP)
        runs[mark] = (other, ok, risk, ttc, dist, soid, is_own)
    other, ok, risk, ttc, dist, soid, is_own = runs[True]
    query = ok.any(dim=1)
    assert bool((soid[query] >= 0).all() & (soid[query] < own_n).all())
    assert int(is_own.sum()) == own_n and bool((soid[~is_own] == -1).all())
    assert bool((other[ok] >= 0).all())
    marked = pair_map(other, ok, risk, ttc, dist, soid)
    assert any(b >= own_n for _, b in marked), "no mirror candidate"
    o2, ok2, r2, t2, d2, s2, _ = runs[False]
    rows = s2 < own_n
    plain = pair_map(o2[rows], ok2[rows], r2[rows], t2[rows], d2[rows],
                     s2[rows])
    assert_maps_equal(marked, plain)


def skew_fleet(n, seed):
    """80% of the fleet in the first 800 m of a 10 km world: its quantile
    walls make slabs of 105-177 m there."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(0, 800, int(0.8 * n)),
                        rng.uniform(0, 10_000, n - int(0.8 * n))])
    pos = np.stack([x, rng.uniform(0, 10_000, n), np.zeros(n)], 1)
    ang = rng.uniform(0, 2 * np.pi, n)
    speed = rng.uniform(5, 25, n)
    vel = np.stack([speed * np.cos(ang), speed * np.sin(ang), np.zeros(n)],
                   1)
    return dict(pos=pos.astype(np.float32), vel=vel.astype(np.float32),
                acc=np.zeros((n, 3), np.float32),
                heading=ang.astype(np.float32),
                size=np.full(n, 2.0, np.float32),
                otype=np.zeros(n, np.int32), alive=np.ones(n, bool),
                oid=np.arange(n, dtype=np.int32))


def test_walls_narrower_than_the_reach():
    """Quantile walls 105 m apart against a 430 m reach: with the hops
    that predict_hops counts from the equal slabs (1), JAX's sharded
    prediction misses a pair that the single device finds, and the port's
    misses the same one; hops = ceil(reach / narrowest slab) finds every
    pair in both (ROADMAP Queue C)."""
    from tpu_collide.shard.balance import (LoadBalancer as JaxBalancer,
                                           quantile_boundaries)
    n = 400
    jcfg = mesh_cfg((8, 1, 1), n=n, world=10_000.0, halo_capacity=64)
    cfg = to_torch_cfg(jcfg)
    d = skew_fleet(n, 5)
    h = np_history(d, dt=jcfg.sim.dt)
    jst, jh = jax_inputs(d, h)
    single = single_device_map(jcfg, jst, jh, 10.0, 0.5)
    b = quantile_boundaries(d["pos"][:, 0], 8, 0.0, 10_000.0,
                            JaxBalancer(jcfg, 1).min_slab_width())
    reach = predict_reach(cfg, 10.0, 0.5)
    deep = int(np.ceil(reach / np.diff(b).min()))
    assert predict_hops(cfg, reach, 0) == 1 and deep == 5
    jmesh = jstep.make_mesh(jcfg)
    st = jstep.distribute_state(jst, jcfg, jmesh, b)
    hs = jpredict.distribute_history(jh, jcfg, jmesh, jst, b)
    mesh = make_mesh(cfg, device="cpu")
    state, hist = port_inputs(d, h)
    states = distribute_state(state, cfg, mesh, b)
    hists = distribute_history(hist, cfg, mesh, state, b)
    bj, bt = np.asarray(b, np.float32), torch.tensor(b, dtype=torch.float32)
    for hops in (None, deep):
        want = pair_map(*jpredict.make_sharded_predict(
            jcfg, jmesh, hops=hops)(st, hs, bj)[:5], st.oid)
        res = make_sharded_predict(cfg, mesh, backend="fused", hops=hops)(
            states, hists, bt)
        got = pair_map(*(cat(c) for c in res[:5]), cat(res[5]))
        assert_maps_equal(got, want)
        assert int(res[6].sum()) == int(res[7].sum()) == 0
        missed = set(single) - set(got)
        if hops is None:
            assert missed == {(33, 308), (308, 33)}
        else:
            assert not missed and set(got) == set(single)
