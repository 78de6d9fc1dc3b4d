"""The port's ShardedScene (tpu_collide_torch/api/sharded_scene.py) and the
service node over it, mirroring tests/test_sharded.py::
test_sharded_scene_facade, tests/test_sharded_service.py and the Scene
tests of tests/test_sharded_predict.py (:153, :429):

  * on deterministic physics, the port's ShardedScene on both backends
    against the JAX ShardedScene on the 8-device CPU mesh: equal states
    after three steps, equal occupancy, equal alert pairs, equal predicted
    risks (values at 1e-5);
  * the facade: steps, stats, checkpoint, failover restore bit for bit;
  * pipelined steps and bursts equal to single steps, each output consumed
    once; trajectory rings follow their objects through a rebalance;
  * the route surface on a 4x2 and a 2x2x2 mesh, CollisionSystem building a
    ShardedScene, back-to-back async saves, and every route answering 200
    with no tensor read through numpy (ROADMAP Queue C 10).

Fleets come from numpy (tests/torch_parity.np_fleet), N <= 300.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.api.sharded_scene import ShardedScene as JaxShardedScene
from tpu_collide.core.config import (AlertConfig, GridConfig, ShardConfig,
                                     SimConfig, WorldConfig)
from tpu_collide.core.state import ObjectState as JaxState
from tpu_collide_torch.api.routes import RouteTable
from tpu_collide_torch.api.sharded_scene import ShardedScene
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.core.types import LocationData, Position, Vector
from tpu_collide_torch.system import CollisionSystem
from tests.torch_parity import np_fleet, to_torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON = 3.0


def mesh_cfg(n=300, grid=(8, 1, 1), p=0.0, world=(2000.0, 2000.0, 0.0),
             halo_capacity=64):
    return tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=world),
        grid=GridConfig(cell_size=100.0, cell_capacity=32),
        sim=SimConfig(accel_change_prob=p),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          num_shards_z=grid[2], halo_capacity=halo_capacity,
                          slot_headroom=3.0))


def port_fleet(d):
    return ObjectState(**{f: torch.from_numpy(np.asarray(v).copy())
                          for f, v in d.items()})


def risk_map(risks):
    return {(r.vehicle_id, r.other_vehicle_id):
            (r.risk_level, r.time_to_collision) for r in risks}


def alert_pairs(sc):
    return {frozenset((a.vehicle_id, a.other_vehicle_id))
            for a in sc.alert_manager.alerts.values()}


def by_oid(host):
    """The alive objects of a collected state in oid order."""
    alive = torch.nonzero(host.alive).flatten()
    rows = alive[torch.argsort(host.oid[alive])]
    return ObjectState(**{f: getattr(host, f)[rows] for f in FIELDS})


def states_equal(a, b):
    return all(torch.equal(getattr(x, f), getattr(y, f))
               for x, y in zip(a, b) for f in FIELDS)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ShardedScene on one deterministic fleet: three steps with a
    trajectory tick after each, then predict()."""
    jcfg = mesh_cfg()
    d = np_fleet(31, jcfg.num_objects, 2000.0)
    sc = JaxShardedScene(jcfg, fleet=JaxState(**{
        f: jnp.asarray(v) for f, v in d.items()}), auto_rebalance=False)
    for _ in range(3):
        sc.step()
        sc.record_trajectories()
    risks = sc.predict(horizon=HORIZON)
    host = sc.collect()
    return dict(jcfg=jcfg, d=d, state={f: np.asarray(getattr(host, f))
                                       for f in FIELDS},
                occupancy=sc.occupancy().tolist(), pairs=alert_pairs(sc),
                risks=risk_map(risks), dropped=sc.dropped_total)


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_sharded_scene_matches_jax(jax_run, backend):
    """Both backends against the JAX ShardedScene (xla): the same slot
    layout and positions, occupancy, alert pairs and predicted risks (the
    fused backend predicts through the predict kernel per shard)."""
    cfg = to_torch_cfg(jax_run["jcfg"])
    sc = ShardedScene(cfg, fleet=port_fleet(jax_run["d"]), backend=backend,
                      auto_rebalance=False, device="cpu")
    for _ in range(3):
        sc.step()
        sc.record_trajectories()
    risks = sc.predict(horizon=HORIZON)
    host = sc.collect()
    for f in FIELDS:
        got, want = getattr(host, f).numpy(), jax_run["state"][f]
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=f, **TOL)
        else:
            np.testing.assert_array_equal(got, want, f)
    assert sc.occupancy().tolist() == jax_run["occupancy"]
    assert sc.dropped_total == jax_run["dropped"] == 0
    assert alert_pairs(sc) == jax_run["pairs"] and jax_run["pairs"]
    got, want = risk_map(risks), jax_run["risks"]
    assert want and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=str(k), **TOL)
    assert all(r.is_predicted and 0.0 <= r.risk_level <= 1.0 for r in risks)
    assert sc.last_predict == dict(risks=len(want), dropped=0, overflow=0)
    st = sc.stats()
    assert st["window_regrows"] == st["retunes"] == 0 and not sc.retune()


def test_sharded_scene_facade(tmp_path):
    """step / stats / checkpoint failover (tests/test_sharded.py:165-194):
    the restored fleet's objects equal the saved ones bit for bit, and it
    steps on."""
    cfg = to_torch_cfg(mesh_cfg(p=0.3))
    sc = ShardedScene(cfg, fleet=port_fleet(np_fleet(32, 300, 2000.0)),
                      backend="fused", checkpoint_dir=str(tmp_path),
                      device="cpu")
    sc.step(3)
    st = sc.stats()
    assert st["num_alive"] == 300 and st["dropped_total"] == 0
    assert len(st["shard_occupancy"]) == 8 and st["step_count"] == 3
    saved = sc.collect()
    sc.save_checkpoint()
    sc.step(5)
    after = sc.collect()
    assert sc.step_count == 8
    assert sc.restore_checkpoint() == 3
    assert sc.stats()["num_alive"] == 300
    restored = sc.collect()
    assert not torch.equal(by_oid(restored).pos, by_oid(after).pos)
    # the alive objects come back bit for bit (their slots are the ones
    # distribute_state gives them)
    for f in FIELDS:
        assert torch.equal(getattr(by_oid(restored), f),
                           getattr(by_oid(saved), f)), f
    sc.step(1)
    assert sc.stats()["num_alive"] == 300


def test_pipelined_and_burst_equal_single_steps():
    """step_pipelined x5 + drain and step_burst(5) compute the states of
    five step() calls (the same generators drawn in the same order, with
    redrawn accelerations); every pipelined output is consumed once, so
    the alert manager counts as step()'s."""
    cfg = to_torch_cfg(mesh_cfg(grid=(4, 2, 1), p=0.3))
    d = np_fleet(33, 300, 2000.0)
    scenes = [ShardedScene(cfg, fleet=port_fleet(d), backend="fused",
                           device="cpu") for _ in range(3)]
    plain, piped, burst = scenes
    outs = []
    for _ in range(5):
        plain.step()
        outs.append(piped.step_pipelined())
    assert outs[0] is None and all(o is not None for o in outs[1:])
    last = piped.pipeline_drain()
    assert last is not None and piped.pipeline_drain() is None
    burst.step_burst(5)
    assert states_equal(plain.state, piped.state)
    assert states_equal(plain.state, burst.state)
    assert plain.step_count == piped.step_count == burst.step_count == 5
    keys = ("created", "updated")
    assert {k: plain.alert_manager.get_stats()[k] for k in keys} == \
        {k: piped.alert_manager.get_stats()[k] for k in keys}
    assert alert_pairs(plain) == alert_pairs(piped)
    assert len(burst.last_burst_risks) == 5 and int(last.num_risks) == \
        int(burst.last_burst_risks[-1])


def test_history_redistributes_on_rebalance():
    """A rebalance moves objects to new slots; their trajectory rings move
    with them (tests/test_sharded_predict.py:153-202), so each slot's last
    sample is its own object's position and predict still runs."""
    n = 200
    rng = np.random.default_rng(0)
    d = np_fleet(34, n, 10_000.0, clustered=0.0)
    d["pos"][:int(0.8 * n), 0] = rng.uniform(0, 1000, int(0.8 * n))
    cfg = to_torch_cfg(mesh_cfg(n=n, world=(10_000.0, 10_000.0, 0.0),
                                halo_capacity=256).replace(
        shard=ShardConfig(num_shards=8, slot_headroom=9.0)))
    sc = ShardedScene(cfg, fleet=port_fleet(d), device="cpu")
    sc.record_trajectories()
    sc.record_trajectories()
    before = sc.collect()
    sc.balancer.check_every = 1
    sc._maybe_rebalance()
    assert sc.balancer.stats["rebalances"] == 1
    host = sc.collect()
    assert not torch.equal(host.oid, before.oid)
    hist = [torch.cat([getattr(h, f) for h in sc._traj])
            for f in ("pos", "count", "head")]
    alive = host.alive
    assert bool((hist[1][alive] == 2).all())
    rows = torch.nonzero(alive).flatten()
    last = hist[0][rows, (hist[2][rows] - 1) % 16]
    assert torch.equal(last, host.pos[rows])
    assert isinstance(sc.predict(horizon=HORIZON), list)


def test_history_follows_an_object_between_a_walls_f32_and_f64_values():
    """A quantile wall that falls between two adjacent f32 samples rounds
    down onto the lower one in f32. The fleet is placed by the f64 walls,
    so that object stays below the wall; its ring must go where the object
    went, or every later ring of both shards shifts by one slot."""
    n = 200
    d = np_fleet(35, n, 10_000.0, clustered=0.0)
    x = np.concatenate([np.linspace(10.0, 990.0, 160),
                        np.linspace(1100.0, 9900.0, 40)]).astype(np.float32)
    x[125] = np.nextafter(x[124], np.float32(np.inf))
    d["pos"][:, 0] = np.random.default_rng(1).permutation(x)
    # wall 5 of 8 lies at sorted position 124.375, between x[124] and x[125]
    wall = np.quantile(x, np.linspace(0.0, 1.0, 9))[5]
    assert np.float32(wall) == x[124] < wall
    cfg = to_torch_cfg(mesh_cfg(n=n, world=(10_000.0, 10_000.0, 0.0))
                       .replace(shard=ShardConfig(num_shards=8,
                                                  slot_headroom=9.0)))
    sc = ShardedScene(cfg, fleet=port_fleet(d), device="cpu")
    sc.record_trajectories()
    sc.record_trajectories()
    sc.balancer.check_every = 1
    sc._maybe_rebalance()
    assert sc.balancer.stats["rebalances"] == 1
    host = sc.collect()
    slots = sc.slots
    row = int(torch.nonzero(host.alive & (host.pos[:, 0] == float(x[124])))
              .flatten()[0])
    assert row // slots == 4          # below the f64 wall
    hist = [torch.cat([getattr(h, f) for h in sc._traj])
            for f in ("pos", "count", "head")]
    rows = torch.nonzero(host.alive).flatten()
    assert bool((hist[1][rows] == 2).all())
    assert int(hist[1][host.alive.logical_not()].max()) == 0
    last = hist[0][rows, (hist[2][rows] - 1) % 16]
    assert torch.equal(last, host.pos[rows])


# ---- the route surface ------------------------------------------------------

def post(routes, vid, pos, vel, heading=0.0):
    code, body = routes.handle("POST", "/vehicles/location", {
        "vehicle_id": vid, "position": pos, "velocity": vel,
        "heading": heading}, {})
    assert code == 200, body


def test_sharded_scene_route_surface():
    """tests/test_sharded_service.py:26-78 on the port: ingest a converging
    pair through the route core on a 4x2 mesh, detect, read locations,
    history, risks, alerts, grid membership; inject a failure."""
    cfg = to_torch_cfg(tc.SystemConfig(
        num_objects=64, sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=128),
        shard=ShardConfig(num_shards=4, num_shards_y=2)))
    sc = ShardedScene(cfg, auto_rebalance=False, device="cpu")
    routes = RouteTable(sc)
    post(routes, "carA", {"x": 3100.0, "y": 500.0}, {"x": 10.0})
    post(routes, "carB", {"x": 3180.0, "y": 500.0}, {"x": -10.0},
         float(np.pi))
    batch = sc.detect()
    assert isinstance(batch.count, np.ndarray) and batch.count.shape == (8,)
    assert int(batch.count.sum()) >= 1
    code, body = routes.handle("GET", "/vehicles/carA/location", None, {})
    assert code == 200 and abs(body["data"]["position"]["x"] - 3100.0) < 1e-3
    code, body = routes.handle("GET", "/vehicles/carA/history", None, {})
    assert code == 200 and len(body["data"]) == 1
    code, body = routes.handle("GET", "/vehicles/carA/risks", None, {})
    assert code == 200 and body["data"][0]["other_vehicle_id"] == "carB"
    code, body = routes.handle("GET", "/alerts", None, {})
    assert code == 200 and len(body["data"]) >= 1
    gx, gy = int(3100.0 // cfg.grid.cell_size), int(500.0 // cfg.grid.cell_size)
    code, body = routes.handle("GET", f"/grids/{gx}_{gy}/vehicles", None, {})
    assert code == 200 and "carA" in body["data"]
    code, body = routes.handle("POST", "/api/admin/inject-failure",
                               {"type": "drop_objects", "fraction": 0.5}, {})
    assert code == 200 and sc.stats()["num_alive"] == 1


def test_sharded_scene_route_surface_3d_mesh():
    """tests/test_sharded_service.py:96-129: a pair straddling the z wall
    of a 2x2x2 mesh; the z halo carries the cross-wall candidate."""
    cfg = to_torch_cfg(tc.SystemConfig(
        num_objects=64, world=WorldConfig(hi=(2000.0, 2000.0, 400.0)),
        grid=GridConfig(cell_size=100.0),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=128),
        shard=ShardConfig(num_shards=2, num_shards_y=2, num_shards_z=2)))
    sc = ShardedScene(cfg, auto_rebalance=False, device="cpu")
    routes = RouteTable(sc)
    for vid, z, vz in (("droneA", 185.0, 8.0), ("droneB", 215.0, -8.0)):
        post(routes, vid, {"x": 500.0, "y": 500.0, "z": z}, {"z": vz})
    assert int(sc.detect().count.sum()) >= 1
    code, body = routes.handle("GET", "/vehicles/droneA/risks", None, {})
    assert code == 200 and body["data"][0]["other_vehicle_id"] == "droneB"


def test_collision_system_builds_sharded_scene():
    """tests/test_sharded_service.py:81-93: a sharded config gets a
    ShardedScene that boots from empty through ingest and detect."""
    cfg = to_torch_cfg(tc.SystemConfig(
        num_objects=32, sim=SimConfig(accel_change_prob=0.0),
        shard=ShardConfig(num_shards=8)))
    node = CollisionSystem(cfg, device="cpu")
    assert isinstance(node.scene, ShardedScene)
    assert node.scene.ingested_count == 0
    node.scene.ingest(LocationData("v1", Position(100.0, 100.0, 0.0),
                                   Vector(5.0, 0, 0)))
    assert node.scene.ingested_count == 1
    node.scene.detect()
    assert node.scene.stats()["num_alive"] == 1
    assert node._task_detect({}) == {"num_alerts": 0}


def test_sharded_async_saves_back_to_back(tmp_path):
    """The sharded twin of tests/test_torch_ckpt.py::
    test_scene_async_saves_back_to_back: a save joins the previous one's
    worker before it takes the lock that worker needs (the JAX
    ShardedScene joins it under the lock; ROADMAP Queue C 10)."""
    cfg = to_torch_cfg(mesh_cfg(n=64))
    sc = ShardedScene(cfg, fleet=port_fleet(np_fleet(35, 64, 2000.0)),
                      checkpoint_dir=str(tmp_path), device="cpu")

    def saves():
        for i in range(20):
            sc.step_count = i
            sc.save_checkpoint_async()
        sc.ckpt.wait_async()

    t = threading.Thread(target=saves, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert sc.ckpt.stats["async_saves"] == 20
    assert sc.ckpt.list_checkpoints() == list(range(15, 20))


def test_no_route_converts_a_tensor_through_numpy(tmp_path, monkeypatch):
    """The sharded twin of tests/test_torch_service.py::
    test_no_route_converts_a_tensor_through_numpy: with Tensor.__array__
    raising, every route answers 200 on a fused ShardedScene (plain,
    pipelined and burst steps, detect, the queries, faults), and so does
    CollisionSystem._task_detect (ROADMAP Queue C 10)."""
    def refuse(self, *a, **k):
        raise TypeError("a tensor went through numpy")

    cfg = to_torch_cfg(tc.SystemConfig(
        num_objects=64, world=WorldConfig(hi=(2000.0, 2000.0, 0.0)),
        shard=ShardConfig(num_shards=4, num_shards_y=2)))
    node = CollisionSystem(cfg, checkpoint_dir=str(tmp_path),
                           backend="fused", device="cpu")
    rt = RouteTable(node.scene, scheduler=node.scheduler)
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    with pytest.raises(TypeError):
        np.asarray(torch.zeros(2))
    car_a = {"vehicle_id": "carA", "position": {"x": 990, "y": 100},
             "velocity": {"x": 10}}
    car_b = {"vehicle_id": "carB", "position": {"x": 1040, "y": 100},
             "velocity": {"x": -10}, "heading": 3.14159}
    calls = [
        ("POST", "/vehicles/location", car_a, {}),
        ("POST", "/vehicles/location", car_b, {}),
        ("POST", "/step", {}, {}),
        ("POST", "/step", {"pipelined": True}, {}),
        ("POST", "/step", {"pipelined": True, "steps": 2}, {}),
        ("POST", "/step", {"burst": True, "steps": 3}, {}),
        ("POST", "/step", {"steps": 2}, {}),
        ("POST", "/detect", {}, {}),
        ("GET", "/alerts", None, {"min_risk": "0.1"}),
        ("GET", "/vehicles/carA/location", None, {}),
        ("GET", "/vehicles/carA/history", None, {}),
        ("GET", "/vehicles/carA/risks", None, {}),
        ("GET", "/grids/9_1/vehicles", None, {}),
        ("GET", "/stats", None, {}),
        ("GET", "/api/collision/metrics", None, {}),
        ("POST", "/tasks", {"task_type": "checkpoint"}, {}),
        ("POST", "/api/admin/inject-failure",
         {"type": "drop_objects", "fraction": 0.5}, {}),
        ("POST", "/api/admin/reset-failures", {}, {}),
    ]
    answers = {}
    for method, path, body, query in calls:
        code, payload = rt.handle(method, path, body, query)
        answers[(method, path, json.dumps(body))] = payload
        assert code == 200, (method, path, body, payload)
    step = answers[("POST", "/step", "{}")]["data"]
    # the pair straddles the x wall at 1000 m: both directions, two shards
    assert step["num_alerts"] == step["num_risks"] == 2
    assert answers[("POST", "/detect", "{}")]["data"] == {"num_alerts": 1}
    assert node._task_detect({}) == {"num_alerts": 0}   # one object left
