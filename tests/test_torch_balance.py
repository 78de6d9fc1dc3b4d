"""The port's load balancing (tpu_collide_torch/shard/balance.py) against
the JAX package's (tpu_collide/shard/balance.py) on the 8-device CPU mesh,
mirroring tests/test_rebalance.py: a skewed fleet that overflows equal
slabs, quantile walls that carry it, a sharded step under dynamic walls
equal to the single-device step, the balancer moving walls, and the
clamped back-off with the 2D escape. Walls equal JAX's bit for bit (as the
f32 values the steps take), occupancies and slot layouts equal JAX's.

Fleets come from numpy, N <= 480; physics is deterministic, so the
sharded steps of both packages compute the same states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core.config import (AlertConfig, ShardConfig, SimConfig)
from tpu_collide.core.state import ObjectState as JaxState
from tpu_collide.shard import balance as jbalance
from tpu_collide.shard import step as jstep
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.engine import make_step
from tpu_collide_torch.shard import (LoadBalancer, check_boundaries,
                                     collect_state, distribute_state,
                                     equal_boundaries, imbalance, make_mesh,
                                     make_sharded_step, quantile_boundaries,
                                     shard_generators, shard_occupancy,
                                     shard_slots)
from tests.torch_parity import alert_map, to_torch_cfg

torch.set_num_threads(1)

N = 480


def skewed_fleet(n, world_x, world_y, dense_frac=0.8, dense_hi=0.1,
                 seed=0):
    """dense_frac of the fleet packed into the first dense_hi of x
    (tests/test_rebalance.py:26-42), as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_dense = int(n * dense_frac)
    x = np.concatenate([rng.uniform(0, world_x * dense_hi, n_dense),
                        rng.uniform(0, world_x, n - n_dense)])
    pos = np.stack([x, rng.uniform(0, world_y, n), np.zeros(n)], axis=1)
    speed = rng.uniform(5, 20, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                    np.zeros(n)], axis=1)
    return dict(pos=pos.astype(np.float32), vel=vel.astype(np.float32),
                acc=np.zeros((n, 3), np.float32),
                heading=ang.astype(np.float32),
                size=np.full(n, 2.0, np.float32),
                otype=rng.integers(0, 4, n).astype(np.int32),
                alive=np.ones(n, bool), oid=np.arange(n, dtype=np.int32))


def column_fleet(n=N):
    """Every object in one 120 m column at x 4000-4120
    (tests/test_rebalance.py:136-144)."""
    rng = np.random.default_rng(3)
    pos = np.stack([rng.uniform(4000.0, 4120.0, n),
                    rng.uniform(0.0, 10_000.0, n), np.zeros(n)],
                   axis=1).astype(np.float32)
    z3 = np.zeros((n, 3), np.float32)
    return dict(pos=pos, vel=z3, acc=z3.copy(), heading=np.zeros(n, np.float32),
                size=np.full(n, 2.0, np.float32),
                otype=np.zeros(n, np.int32), alive=np.ones(n, bool),
                oid=np.arange(n, dtype=np.int32))


def skew_cfg(n=N, shards=8, headroom=1.3, shards_y=1):
    return tc.SystemConfig(
        num_objects=n,
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=shards, num_shards_y=shards_y,
                          slot_headroom=headroom, halo_capacity=512,
                          migrate_capacity=128))


def jax_fleet(d):
    return JaxState(**{f: jnp.asarray(v) for f, v in d.items()})


def port_fleet(d):
    return ObjectState(**{f: torch.from_numpy(np.asarray(v).copy())
                          for f, v in d.items()})


def both(jcfg):
    cfg = to_torch_cfg(jcfg)
    return jcfg, jstep.make_mesh(jcfg), cfg, make_mesh(cfg, device="cpu")


def assert_layout_equal(states, jst):
    host = collect_state(states)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(host, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)


def test_skewed_fleet_overflows_equal_slabs():
    jcfg, jmesh, cfg, mesh = both(skew_cfg())
    d = skewed_fleet(N, 10_000.0, 10_000.0)
    with pytest.raises(ValueError, match="overflow"):
        jstep.distribute_state(jax_fleet(d), jcfg, jmesh)
    with pytest.raises(ValueError, match="overflow"):
        distribute_state(port_fleet(d), cfg, mesh)


def test_quantile_walls_carry_the_skew():
    """The same fleet under quantile walls fits at headroom 1.3; the
    walls, the slot layout and the occupancy equal JAX's; 5 steps conserve
    every object with no drop, as JAX's steps do, and the occupancy stays
    balanced."""
    jcfg, jmesh, cfg, mesh = both(skew_cfg())
    d = skewed_fleet(N, 10_000.0, 10_000.0)
    want = jbalance.quantile_boundaries(d["pos"][:, 0], 8, 0.0, 10_000.0,
                                        110.0)
    b = quantile_boundaries(d["pos"][:, 0], 8, 0.0, 10_000.0, 110.0)
    np.testing.assert_array_equal(b, want)
    check_boundaries(cfg, b)
    jst = jstep.distribute_state(jax_fleet(d), jcfg, jmesh, boundaries=want)
    states = distribute_state(port_fleet(d), cfg, mesh, boundaries=b)
    assert_layout_equal(states, jst)
    occ = shard_occupancy(states, cfg)
    np.testing.assert_array_equal(
        occ, jbalance.shard_occupancy(jst, jcfg, shard_slots(cfg)))
    assert imbalance(occ) == jbalance.imbalance(occ) and imbalance(occ) < 1.2

    bj = np.asarray(want, np.float32)
    jf = jstep.make_sharded_step(jcfg, jmesh, donate=False)
    step = make_sharded_step(cfg, mesh)
    bt = torch.tensor(b, dtype=torch.float32)
    gens = shard_generators(mesh, 0)
    for i in range(5):
        jst, jout, jdrop = jf(jst, jax.random.key(100 + i), bj)
        states, out, dropped = step(states, gens, bt)
        np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
        assert int(dropped.sum()) == 0
    np.testing.assert_array_equal(
        shard_occupancy(states, cfg),
        jbalance.shard_occupancy(jst, jcfg, shard_slots(cfg)))
    assert imbalance(shard_occupancy(states, cfg)) < 1.2
    host = collect_state(states)
    np.testing.assert_array_equal(host.oid.numpy(), np.asarray(jst.oid))
    oids = host.oid[host.alive].tolist()
    assert int(out.num_alive) == N and sorted(oids) == list(range(N))


def test_dynamic_walls_match_single_device():
    """Detection does not depend on the walls: one sharded step under
    quantile walls gives the single-device step's risks and alerts, and
    JAX's sharded step's."""
    jcfg, jmesh, cfg, mesh = both(skew_cfg())
    d = skewed_fleet(N, 10_000.0, 10_000.0, seed=3)
    b = quantile_boundaries(d["pos"][:, 0], 8, 0.0, 10_000.0, 110.0)
    _, out1 = make_step(cfg, device="cpu")(port_fleet(d),
                                           torch.Generator())
    states, out8, dropped = make_sharded_step(cfg, mesh)(
        distribute_state(port_fleet(d), cfg, mesh, boundaries=b),
        shard_generators(mesh, 1), torch.tensor(b, dtype=torch.float32))
    jst = jstep.distribute_state(jax_fleet(d), jcfg, jmesh, boundaries=b)
    _, jout, _ = jstep.make_sharded_step(jcfg, jmesh, donate=False)(
        jst, jax.random.key(1), np.asarray(b, np.float32))
    assert int(dropped.sum()) == 0
    assert int(out8.num_risks) == int(out1.num_risks) == int(jout.num_risks)
    assert set(alert_map(out8.alerts)) == set(alert_map(out1.alerts)) \
        == set(alert_map(jout.alerts))
    assert int(out8.num_risks) > 0


def test_load_balancer_moves_walls():
    """A fleet that fits equal slabs but is imbalanced trips
    should_rebalance; rebalance() returns JAX's walls and slot layout, the
    occupancy evens out, and the steps under the new walls run clean."""
    jcfg, jmesh, cfg, mesh = both(skew_cfg(headroom=4.0))
    d = skewed_fleet(N, 10_000.0, 10_000.0, dense_frac=0.6, dense_hi=0.25,
                     seed=5)
    slots = shard_slots(cfg)
    states = distribute_state(port_fleet(d), cfg, mesh)
    jst = jstep.distribute_state(jax_fleet(d), jcfg, jmesh)
    assert imbalance(shard_occupancy(states, cfg)) > 1.2

    bal = LoadBalancer(cfg, slots, check_every=1)
    jbal = jbalance.LoadBalancer(jcfg, slots, check_every=1)
    assert bal.should_rebalance(states) and jbal.should_rebalance(jst)
    np.testing.assert_array_equal(bal.last_occupancy, jbal.last_occupancy)
    states, bx, by, bz = bal.rebalance(states, mesh)
    jst, jbx, _, _ = jbal.rebalance(jst, jmesh)
    assert by is None and bz is None and bx.dtype == torch.float32
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jbx, np.float32))
    # the fleet was placed by the f64 walls, JAX's own
    np.testing.assert_array_equal(bal.last_walls[0], jbx)
    assert bal.last_walls[1:] == (None, None)
    assert_layout_equal(states, jst)
    assert imbalance(shard_occupancy(states, cfg)) < 1.2
    assert bal.stats == jbal.stats == {"checks": 1, "rebalances": 1,
                                       "backoffs": 0}
    assert not torch.allclose(bx, equal_boundaries(cfg, device="cpu"))

    step = make_sharded_step(cfg, mesh)
    gens = shard_generators(mesh, 2)
    for _ in range(3):
        states, out, dropped = step(states, gens, bx)
        assert int(dropped.sum()) == 0
    assert int(out.num_alive) == N


def test_clamped_rebalance_backs_off_and_2d_mesh_escapes():
    """A fleet in one 120 m column cannot be balanced by x walls: the
    walls clamp at min_slab_width (JAX's, bit for bit), one shard keeps
    nearly everything, and the balancer backs off instead of thrashing.
    On a 2x4 tiling the y walls split the column, as in JAX."""
    d = column_fleet()
    jcfg, jmesh, cfg, mesh = both(skew_cfg(headroom=8.0))
    slots = shard_slots(cfg)
    states = distribute_state(port_fleet(d), cfg, mesh)
    jst = jstep.distribute_state(jax_fleet(d), jcfg, jmesh)
    bal = LoadBalancer(cfg, slots, check_every=1)
    jbal = jbalance.LoadBalancer(jcfg, slots, check_every=1)
    assert bal.min_slab_width() == jbal.min_slab_width()
    assert bal.should_rebalance(states) and jbal.should_rebalance(jst)
    states, bx, _, _ = bal.rebalance(states, mesh)
    jst, jbx, _, _ = jbal.rebalance(jst, jmesh)
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jbx, np.float32))
    assert_layout_equal(states, jst)
    assert imbalance(shard_occupancy(states, cfg)) > 4.0
    assert bool((np.diff(np.asarray(jbx)) >= bal.min_slab_width()
                 - 1e-6).all())
    assert bal.should_rebalance(states) is False
    assert jbal.should_rebalance(jst) is False
    assert bal.stats == jbal.stats and bal.stats["backoffs"] == 1

    jcfg2, jmesh2, cfg2, mesh2 = both(skew_cfg(shards=2, shards_y=4,
                                               headroom=4.0))
    slots2 = shard_slots(cfg2)
    states2 = distribute_state(port_fleet(d), cfg2, mesh2)
    jst2 = jstep.distribute_state(jax_fleet(d), jcfg2, jmesh2)
    bal2 = LoadBalancer(cfg2, slots2, check_every=1)
    jbal2 = jbalance.LoadBalancer(jcfg2, slots2, check_every=1)
    assert bal2.should_rebalance(states2) and jbal2.should_rebalance(jst2)
    states2, bx2, by2, bz2 = bal2.rebalance(states2, mesh2)
    jst2, jbx2, jby2, _ = jbal2.rebalance(jst2, jmesh2)
    assert bz2 is None
    np.testing.assert_array_equal(bx2.numpy(), np.asarray(jbx2, np.float32))
    np.testing.assert_array_equal(by2.numpy(), np.asarray(jby2, np.float32))
    assert_layout_equal(states2, jst2)
    np.testing.assert_array_equal(
        shard_occupancy(states2, cfg2),
        jbalance.shard_occupancy(jst2, jcfg2, slots2))
    assert imbalance(shard_occupancy(states2, cfg2)) < 1.3


def test_walls_through_a_dense_core_drop_halo_objects_as_jax_does():
    """Quantile walls cut through the dense part of the fleet, where a
    halo band holds more objects than a small halo_capacity: the sharded
    step drops the band objects beyond it (counted, never silent), shard
    for shard as JAX's sharded step does under the same walls. Equal slabs
    put their walls in the sparse part and drop fewer."""
    jcfg = skew_cfg(headroom=4.0)
    jcfg = jcfg.replace(shard=ShardConfig(
        num_shards=8, slot_headroom=4.0, halo_capacity=8,
        migrate_capacity=128))
    jcfg, jmesh, cfg, mesh = both(jcfg)
    d = skewed_fleet(N, 10_000.0, 10_000.0, dense_frac=0.6, dense_hi=0.25,
                     seed=5)
    slots = shard_slots(cfg)
    states = distribute_state(port_fleet(d), cfg, mesh)
    jst = jstep.distribute_state(jax_fleet(d), jcfg, jmesh)
    jf = jstep.make_sharded_step(jcfg, jmesh, donate=False)
    step = make_sharded_step(cfg, mesh)
    _, _, equal_drop = step(states, shard_generators(mesh, 0))
    _, _, jequal_drop = jf(jst, jax.random.key(0))
    np.testing.assert_array_equal(equal_drop.numpy(), np.asarray(jequal_drop))

    bal = LoadBalancer(cfg, slots, check_every=1)
    jbal = jbalance.LoadBalancer(jcfg, slots, check_every=1)
    assert bal.should_rebalance(states) and jbal.should_rebalance(jst)
    states, bx, _, _ = bal.rebalance(states, mesh)
    jst, jbx, _, _ = jbal.rebalance(jst, jmesh)
    states, out, dropped = step(states, shard_generators(mesh, 1), bx)
    jst, jout, jdrop = jf(jst, jax.random.key(1), np.asarray(jbx, np.float32))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
    assert int(dropped.sum()) > int(equal_drop.sum())
    assert int(out.num_risks) == int(jout.num_risks)
    assert int(out.num_alive) == N
