"""The port's sharded scenario step (make_sharded_scenario_step,
tpu_collide_torch/shard/step.py) against the JAX package's on the 8-device
CPU mesh, 1D (8 x-slabs) and 2D (4x2 tiles), as tests/test_scenario.py:168
runs it: the 100 x 100 grid map of 100 m roads over a 10 km world, 400
objects. Modes are mixed (road, destination, random), accelerations jitter,
and every shard takes the JAX package's ten draws of its step
(scenario_integrate's split of fold_in(key, shard)), so every branch runs
on the same numbers on both sides. Road objects sit next to the walls and
cross them, so their road and mode must migrate with them.

States slot for slot after collect_state (floats at rtol 1e-5 / atol 1e-4,
as tests/test_torch_scenario.py: libm's atan2, sin and cos differ), the
scenario state (mode, road, target_ok exact), drops, counters and alerts
(values at 1e-5) equal JAX's after each of 5 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, ShardConfig, SimConfig,
                                     WorldConfig)
from tpu_collide.core.state import ObjectState as JaxState
from tpu_collide.shard import step as jstep
from tpu_collide.sim import scenario as jsc
from tpu_collide.sim.traffic import TrafficMap as JaxMap
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.shard import (collect_state, distribute_state,
                                     make_mesh, make_sharded_scenario_step,
                                     shard_generators, shard_slots)
from tpu_collide_torch.sim import scenario as tsc
from tpu_collide_torch.sim.traffic import TrafficMap
from tests.test_torch_scenario import jax_draws
from tests.torch_parity import (alert_map, assert_alerts_equal, np_fleet,
                                to_torch_cfg)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
N, STEPS, WORLD = 400, 5, 10_000.0
SCEN_FIELDS = ("mode", "road", "target", "target_ok")


def scen_cfg(grid):
    return tc.SystemConfig(
        num_objects=N, world=WorldConfig(hi=(WORLD, WORLD, 0.0)),
        sim=SimConfig(accel_change_prob=0.3),
        grid=GridConfig(cell_size=100.0, cell_capacity=16),
        detect=DetectionConfig(mode="fast"),
        alerts=AlertConfig(max_scene_alerts=256),
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          halo_capacity=64, migrate_capacity=16))


def scen_fleet(roads, grid, seed=13):
    """Fleet and scenario arrays: 60% on a road at U(0.1, 0.9) of it, 20%
    destination-oriented without a target, 20% random; the first road
    objects 2 m before an interior wall on a road across it, moving over
    it (h-roads over x walls, v-roads over y walls)."""
    rng = np.random.default_rng(seed)
    d = np_fleet(seed, N, WORLD)
    start, dirn = roads.start.numpy(), roads.dirn.numpy()
    length = roads.length.numpy()
    mode = rng.choice([tsc.MODE_ROAD, tsc.MODE_DEST, tsc.MODE_RANDOM], N,
                      p=[0.6, 0.2, 0.2]).astype(np.int32)
    mode[:32] = tsc.MODE_ROAD
    road = rng.integers(0, length.shape[0], N)
    along = rng.uniform(0.1, 0.9, N) * length[road]
    # road ids sort h-road-* (indices 0-100, along x) before v-road-*
    # (101-201, along y)
    walls = [(0, w) for w in np.linspace(0, WORLD, grid[0] + 1)[1:-1]]
    walls += [(1, w) for w in np.linspace(0, WORLD, grid[1] + 1)[1:-1]]
    for j in range(32):
        dim, w = walls[j % len(walls)]
        road[j] = rng.integers(1, 100) + (101 if dim == 1 else 0)
        along[j] = w - 2.0
    on_road = mode == tsc.MODE_ROAD
    pos = start[road] + along[:, None] * dirn[road]
    speed = rng.uniform(8.0, 14.0, N)
    d["pos"][on_road, :2] = pos[on_road]
    d["vel"][on_road, :2] = (speed[:, None] * dirn[road])[on_road]
    scen = dict(mode=mode, road=np.where(on_road, road, -1).astype(np.int32),
                target=np.zeros((N, 2), np.float32),
                target_ok=np.zeros(N, bool))
    return d, scen


@pytest.fixture(scope="module")
def maps():
    jmap = JaxMap(seed=4).generate_grid_map(100, 100, 100.0)
    tmap = TrafficMap(seed=4).generate_grid_map(100, 100, 100.0)
    jr, _ = jsc.build_road_table(jmap)
    tr, _ = tsc.build_road_table(tmap, device="cpu")
    return ((jr, jsc.build_city_table(jmap)),
            (tr, tsc.build_city_table(tmap, device="cpu")))


def shard_draws(key, mesh, slots, n_cities, cfg):
    """The ten draws of every shard's step under `key`, as the JAX sharded
    scenario step takes them (fold_in of the linear shard index)."""
    return tuple(jax_draws(jax.random.fold_in(key, s), slots, n_cities, cfg)
                 for s in range(mesh.size))


@pytest.mark.parametrize("grid", [(8, 1), (4, 2)], ids=["8x1", "4x2"])
def test_sharded_scenario_step_matches_jax(maps, grid):
    (jr, jc), (tr, tcity) = maps
    jcfg = scen_cfg(grid)
    d, scen = scen_fleet(tr, grid)
    jmesh = jstep.make_mesh(jcfg)
    jst, jex = jstep.distribute_state(
        JaxState(**{f: jnp.asarray(v) for f, v in d.items()}), jcfg, jmesh,
        extra=scen)
    jscen = jsc.ScenarioState(**jex)
    jstep_fn = jstep.make_sharded_scenario_step(jcfg, jmesh, jr, jc,
                                                donate=False)

    cfg = to_torch_cfg(jcfg)
    mesh = make_mesh(cfg, device="cpu")
    slots = shard_slots(cfg)
    states, extras = distribute_state(
        ObjectState(**{f: torch.from_numpy(np.asarray(v))
                       for f, v in d.items()}), cfg, mesh, extra=scen)
    scens = tuple(tsc.ScenarioState(**x) for x in extras)
    step = make_sharded_scenario_step(cfg, mesh, tr, tcity)
    gens = shard_generators(mesh, 0)
    n_cities = tcity.radius.shape[0]
    start_oids = collect_state(states).oid.clone()
    for i in range(STEPS):
        key = jax.random.key(100 + i)
        jst, jscen, jout, jdrop = jstep_fn(jst, jscen, key)
        states, scens, out, dropped = step(
            states, scens, gens,
            draws=shard_draws(key, mesh, slots, n_cities, jcfg))
        host, hscen = collect_state(states), collect_state(scens)
        for f in FIELDS:
            g, w = getattr(host, f).numpy(), np.asarray(getattr(jst, f))
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, err_msg=f, **TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)
        for f in SCEN_FIELDS:
            g, w = getattr(hscen, f).numpy(), np.asarray(getattr(jscen, f))
            if f == "target":
                np.testing.assert_allclose(g, w, err_msg=f, **TOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f)
        np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
        for f in ("num_pairs_checked", "num_risks", "num_alive",
                  "overflow", "alert_overflow"):
            assert int(getattr(out, f)) == int(getattr(jout, f)), f
        assert_alerts_equal(alert_map(jout.alerts),
                            alert_map(out.alerts, unordered=False))
    assert int(out.num_alive) == N and int(dropped.sum()) == 0
    assert int(out.overflow) == 0 and int(out.num_risks) > 0
    # the wall crossers changed shard, their road and mode with them
    moved = (host.oid != start_oids) & host.alive
    assert int(moved.sum()) > 0
    oid = host.oid.long()
    live = host.alive
    assert torch.equal(hscen.mode[live],
                       torch.from_numpy(scen["mode"])[oid[live]])
    on_road = live & (hscen.mode == tsc.MODE_ROAD)
    assert torch.equal(hscen.road[on_road],
                       torch.from_numpy(scen["road"])[oid[on_road]])


def test_fused_sharded_scenario_step_equals_the_reference_shaped(maps):
    """On the 4x2 grid the fused backend (plain kernel) steps to the same
    states as the reference-shaped one, with the same risks and alert
    pairs (unordered)."""
    _, (tr, tcity) = maps
    cfg = to_torch_cfg(scen_cfg((4, 2)))
    mesh = make_mesh(cfg, device="cpu")
    d, scen = scen_fleet(tr, (4, 2), seed=14)
    states, extras = distribute_state(
        ObjectState(**{f: torch.from_numpy(np.asarray(v))
                       for f, v in d.items()}), cfg, mesh, extra=scen)
    scens = tuple(tsc.ScenarioState(**x) for x in extras)
    ends = {}
    for backend in ("xla", "fused"):
        step = make_sharded_scenario_step(cfg, mesh, tr, tcity,
                                          backend=backend)
        st, sc, gens = states, scens, shard_generators(mesh, 5)
        for _ in range(3):
            st, sc, out, dropped = step(st, sc, gens)
        ends[backend] = (collect_state(st), collect_state(sc), out)
    (sx, cx, ox), (sf, cf, of) = ends["xla"], ends["fused"]
    for f in FIELDS:
        assert torch.equal(getattr(sx, f), getattr(sf, f)), f
    for f in SCEN_FIELDS:
        assert torch.equal(getattr(cx, f), getattr(cf, f)), f
    assert int(of.alert_overflow) == int(of.overflow) == 0
    assert int(of.num_risks) == int(ox.num_risks)
    assert set(alert_map(of.alerts)) == set(alert_map(ox.alerts))
