"""The port's sharded step (tpu_collide_torch/shard/step.py) against the
JAX package's (tpu_collide/shard/step.py) on the 8-device CPU mesh: 1D
(8 x-slabs), 2D (4x2 tiles) and 3D (2x2x2 boxes).

  * the reference-shaped backend against JAX's make_sharded_step, two
    steps: equal slot layouts after collect_state (floats at rtol / atol
    1e-5: headings go through libm's atan2), equal per-shard drops and
    counters, equal alert sets (values at 1e-5, priorities exact). The 1D
    mesh runs deterministic physics; the 2D and 3D meshes redraw
    accelerations, with the JAX package's per-shard draws (fold_in of the
    shard index) injected;
  * the fused backend (the kernel's plain version on the CPU) against
    JAX's reference-shaped sharded step as unordered pairs with equal
    num_risks and num_pairs_checked (tests/test_sharded.py:204-237), and
    against the port's single-device fused detection of the same fleet;
  * bursts, histories, make_sharded_detect and make_sharded_ingest.

Fleets come from numpy (tests/torch_parity.np_fleet), N <= 400.
"""
import dataclasses

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
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.detect.predict import TrajectoryHistory
from tpu_collide_torch.engine import detect_and_alerts_fused
from tpu_collide_torch.shard import (collect_state, distribute_state,
                                     make_mesh, make_sharded_detect,
                                     make_sharded_ingest, make_sharded_step,
                                     shard_generators, shard_slots)
from tests.torch_parity import (alert_map, assert_alerts_equal, np_fleet,
                                to_torch_cfg)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 2
# (mesh grid, detection mode, accel_change_prob): 1D deterministic, 2D and
# 3D with redrawn accelerations (the JAX draws injected)
MESHES = {"8x1": ((8, 1, 1), "precise", 0.0),
          "4x2": ((4, 2, 1), "fast", 0.3),
          "2x2x2": ((2, 2, 2), "fast", 0.3)}


def mesh_cfg(grid, mode, p, n=400):
    is3d = grid[2] > 1
    return tc.SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(1000.0, 1000.0, 300.0) if is3d
                          else (2000.0, 2000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=32 if is3d else 64),
        detect=DetectionConfig(mode=mode),
        sim=SimConfig(accel_change_prob=p),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          num_shards_z=grid[2],
                          halo_capacity=128 if is3d else 64,
                          slot_headroom=2.0 if is3d else 3.0))


def mesh_fleet(seed, jcfg):
    """np_fleet in the config's world, with two objects at every interior
    wall, 1 m to each side, heading across it at 15 m/s: they migrate in
    the first step."""
    grid = (jcfg.shard.num_shards, jcfg.shard.num_shards_y,
            jcfg.shard.num_shards_z)
    world = jcfg.world.hi[0]
    d = np_fleet(seed, jcfg.num_objects, world, is3d=grid[2] > 1)
    j = 0
    for dim, n in enumerate(grid):
        for w in np.linspace(0.0, jcfg.world.hi[dim], n + 1)[1:-1]:
            for side in (-1.0, 1.0):
                d["pos"][j, dim] = w + side
                d["vel"][j, dim] = -15.0 * side
                j += 1
    return d


def jax_draws(jcfg, key, slots):
    """Per shard, the (redraw, new_acc) the JAX sharded step draws from
    `key`: fold_in of the linear shard index, then integrate's split."""
    out = []
    for s in range(jcfg.shard.total_shards):
        k1, k2 = jax.random.split(jax.random.fold_in(key, s))
        r = jcfg.sim.accel_range
        redraw = (jax.random.uniform(k1, (slots, 1))
                  < jcfg.sim.accel_change_prob)
        acc = jax.random.uniform(k2, (slots, 3), minval=-r, maxval=r)
        out.append((torch.from_numpy(np.array(redraw)),
                    torch.from_numpy(np.array(acc))))
    return tuple(out)


def keys():
    return [jax.random.key(100 + i) for i in range(STEPS)]


@pytest.fixture(scope="module", params=list(MESHES), ids=list(MESHES))
def run(request):
    """One fleet per mesh, stepped STEPS times by JAX's reference-shaped
    sharded step, with the states and outputs of every step."""
    grid, mode, p = MESHES[request.param]
    jcfg = mesh_cfg(grid, mode, p)
    d = mesh_fleet(7, jcfg)
    fleet = JaxState(**{f: jnp.asarray(v) for f, v in d.items()})
    jmesh = jstep.make_mesh(jcfg)
    step = jstep.make_sharded_step(jcfg, jmesh, donate=False)
    st = jstep.distribute_state(fleet, jcfg, jmesh)
    first = st
    history = []
    for key in keys():
        st, out, dropped = step(st, key)
        history.append((jax.tree.map(np.asarray, st),
                        jax.tree.map(np.asarray, out), np.asarray(dropped)))
    cfg = to_torch_cfg(jcfg)
    mesh = make_mesh(cfg, device="cpu")
    slots = shard_slots(cfg)
    return dict(jcfg=jcfg, cfg=cfg, mesh=mesh, fleet=d, first=first,
                history=history, slots=slots,
                draws=[jax_draws(jcfg, k, slots) if p > 0 else None
                       for k in keys()])


def port_fleet(d):
    return ObjectState(**{f: torch.from_numpy(np.asarray(v))
                          for f, v in d.items()})


def assert_state_equals_jax(got, want, what):
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=f"{what}: {f}", **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


def test_distribute_state_matches_jax(run):
    """The same fleet lands in the same slots on every shard."""
    states = distribute_state(port_fleet(run["fleet"]), run["cfg"],
                              run["mesh"])
    assert len(states) == run["mesh"].size
    assert all(st.n == run["slots"] for st in states)
    assert_state_equals_jax(collect_state(states), run["first"],
                            "distributed")


def test_xla_step_matches_jax(run):
    """Two reference-shaped sharded steps: states slot for slot, drops,
    counters and alerts as JAX's."""
    cfg, mesh = run["cfg"], run["mesh"]
    step = make_sharded_step(cfg, mesh)
    states = distribute_state(port_fleet(run["fleet"]), cfg, mesh)
    gens = shard_generators(mesh, 0)
    migrated = 0
    for i, (jst, jout, jdrop) in enumerate(run["history"]):
        before = collect_state(states)
        states, out, dropped = step(states, gens, draws=run["draws"][i])
        host = collect_state(states)
        assert_state_equals_jax(host, jst, f"step {i}")
        np.testing.assert_array_equal(dropped.numpy(), jdrop)
        for f in ("num_pairs_checked", "num_risks", "num_alive", "overflow",
                  "alert_overflow"):
            assert int(getattr(out, f)) == int(getattr(jout, f)), f
        np.testing.assert_allclose(float(out.max_risk),
                                   float(jout.max_risk), **TOL)
        np.testing.assert_array_equal(out.alerts.count.numpy(),
                                      np.asarray(jout.alerts.count))
        assert_alerts_equal(alert_map(jout.alerts),
                            alert_map(out.alerts, unordered=False))
        migrated += int((before.oid != host.oid).sum())
    assert int(out.num_alive) == cfg.num_objects
    assert int(out.num_risks) > 0 and migrated > 0


def test_fused_step_matches_jax_xla_and_single_device(run):
    """The fused backend (plain kernel): unordered pairs, num_risks and
    num_pairs_checked as JAX's reference-shaped sharded step, every
    certificate 0; and the same pairs and risks as the port's single-device
    fused detection of the collected fleet."""
    cfg, mesh = run["cfg"], run["mesh"]
    step = make_sharded_step(cfg, mesh, backend="fused")
    states = distribute_state(port_fleet(run["fleet"]), cfg, mesh)
    gens = shard_generators(mesh, 0)
    for i, (jst, jout, _) in enumerate(run["history"]):
        states, out, dropped = step(states, gens, draws=run["draws"][i])
        assert int(dropped.sum()) == 0
        assert int(out.overflow) == int(out.alert_overflow) == 0
        assert int(out.num_risks) == int(jout.num_risks)
        assert int(out.num_pairs_checked) == int(jout.num_pairs_checked)
        pairs = set(alert_map(out.alerts))
        assert pairs == set(alert_map(jout.alerts))
        single = detect_and_alerts_fused(collect_state(states), cfg)
        assert set(alert_map(single.alerts)) == pairs
        assert int(single.num_risks) == int(out.num_risks)
    assert pairs


def history_of(states):
    """A history per shard whose fields are functions of each slot's oid,
    so that a migrated history can be told by its object."""
    out = []
    for st in states:
        o = st.oid.to(torch.float32)
        out.append(TrajectoryHistory(
            pos=o[:, None, None].expand(-1, 4, 3).clone(),
            t=o[:, None].expand(-1, 4).clone(),
            count=st.oid % 5, head=st.oid % 4))
    return tuple(out)


def test_histories_migrate_with_their_objects():
    """with_history=True: the states equal those of the plain step, and
    every alive slot's history is its own object's after migration."""
    cfg = to_torch_cfg(mesh_cfg((4, 2, 1), "fast", 0.3))
    mesh = make_mesh(cfg, device="cpu")
    d = mesh_fleet(8, mesh_cfg((4, 2, 1), "fast", 0.3))
    states = distribute_state(port_fleet(d), cfg, mesh)
    hists = history_of(states)
    step_h = make_sharded_step(cfg, mesh, backend="fused", with_history=True)
    step = make_sharded_step(cfg, mesh, backend="fused")
    g_h, g = shard_generators(mesh, 3), shard_generators(mesh, 3)
    plain = states
    for _ in range(3):
        states, hists, out_h, drop_h = step_h(states, hists, g_h)
        plain, out, drop = step(plain, g)
    for a, b in zip(states, plain):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(drop_h, drop)
    for st, h in zip(states, hists):
        a = st.alive
        o = st.oid[a]
        assert torch.equal(h.count[a], o % 5)
        assert torch.equal(h.head[a], o % 4)
        assert torch.equal(h.pos[a], o.to(torch.float32)[:, None, None]
                           .expand(-1, 4, 3))
        assert torch.equal(h.t[a], o.to(torch.float32)[:, None].expand(-1, 4))
    start = collect_state(distribute_state(port_fleet(d), cfg, mesh))
    assert int((collect_state(states).oid != start.oid).sum()) > 0
    assert int(out_h.num_alive) == cfg.num_objects


def test_burst_equals_single_steps():
    """burst_n=3 from the same generators as 3 single steps: equal states,
    risks per step, summed drops and burst-wide certificates."""
    cfg = to_torch_cfg(mesh_cfg((8, 1, 1), "fast", 0.3))
    mesh = make_mesh(cfg, device="cpu")
    states = distribute_state(port_fleet(mesh_fleet(
        9, mesh_cfg((8, 1, 1), "fast", 0.3))), cfg, mesh)
    burst = make_sharded_step(cfg, mesh, backend="fused", burst_n=3)
    step = make_sharded_step(cfg, mesh, backend="fused")
    sb, gens, ob, drops, risks = burst(states, shard_generators(mesh, 4))
    g = shard_generators(mesh, 4)
    outs, total = [], torch.zeros(mesh.size, dtype=torch.int32)
    cur = states
    for _ in range(3):
        cur, o, dr = step(cur, g)
        outs.append(o)
        total += dr
    for a, b in zip(sb, cur):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert risks.tolist() == [int(o.num_risks) for o in outs]
    assert torch.equal(drops, total)
    assert int(ob.alert_overflow) == max(int(o.alert_overflow) for o in outs)
    assert set(alert_map(ob.alerts)) == set(alert_map(outs[-1].alerts))
    assert len(gens) == mesh.size and sum(risks.tolist()) > 0
    with pytest.raises(ValueError, match="no injected draws"):
        burst(states, g, draws=((None, None),) * mesh.size)


@pytest.mark.parametrize("grid", [(8, 1, 1), (4, 2, 1)], ids=["8x1", "4x2"])
def test_sharded_detect_matches_jax(grid):
    """make_sharded_detect (no physics) on a distributed fleet, with
    dynamic x walls: counters, drops and alerts as JAX's."""
    jcfg = mesh_cfg(grid, "fast", 0.0, n=300)
    d = np_fleet(11, jcfg.num_objects, 2000.0)
    bx = np.linspace(0.0, 2000.0, grid[0] + 1).astype(np.float32)
    bx[1:-1] += np.float32(37.5) * (-1) ** np.arange(grid[0] - 1)
    jmesh = jstep.make_mesh(jcfg)
    jst = jstep.distribute_state(
        JaxState(**{f: jnp.asarray(v) for f, v in d.items()}), jcfg, jmesh,
        jnp.asarray(bx))
    jout, jdrop = jstep.make_sharded_detect(jcfg, jmesh)(jst, jnp.asarray(bx))
    cfg = to_torch_cfg(jcfg)
    mesh = make_mesh(cfg, device="cpu")
    states = distribute_state(port_fleet(d), cfg, mesh, torch.tensor(bx))
    out, dropped = make_sharded_detect(cfg, mesh)(states, torch.tensor(bx))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
    for f in ("num_pairs_checked", "num_risks", "num_alive", "overflow",
              "alert_overflow"):
        assert int(getattr(out, f)) == int(getattr(jout, f)), f
    assert_alerts_equal(alert_map(jout.alerts),
                        alert_map(out.alerts, unordered=False))
    assert int(out.num_risks) > 0


def ingest_batch(b, rows):
    """An oid-sorted, -1-padded update batch of b entries from
    (oid, x, y) rows."""
    upd = {"oid": np.full(b, -1, np.int32),
           "pos": np.zeros((b, 3), np.float32),
           "vel": np.zeros((b, 3), np.float32),
           "acc": np.zeros((b, 3), np.float32),
           "heading": np.zeros(b, np.float32),
           "size": np.full(b, 2.0, np.float32),
           "otype": np.zeros(b, np.int32)}
    for i, (oid, x, y) in enumerate(sorted(rows)):
        upd["oid"][i] = oid
        upd["pos"][i] = (x, y, 0.0)
        upd["vel"][i] = (1.0 + i, -2.0, 0.0)
    return upd


@pytest.mark.parametrize("grid,headroom,alive,new", [
    ((2, 2, 1), 2.0, 64, 8), ((2, 1, 1), 1.0, 24, 28)],
    ids=["2x2", "2x1-full"])
def test_sharded_ingest_matches_jax(grid, headroom, alive, new):
    """make_sharded_ingest against JAX's (test_mesh2d.py:211,
    test_sharded_ingest.py): in-place updates, a move across both walls
    (the old copy dies, one copy lives), new objects into free slots, and
    on the full 2x1 mesh inserts beyond the free slots counted."""
    jcfg = mesh_cfg(grid, "fast", 0.0, n=64).replace(
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          slot_headroom=headroom))
    d = np_fleet(12, 64, 2000.0, dead=64 - alive)
    rows = [(0, 1900.0, 1900.0), (1, 100.0, 100.0), (5, 1500.0, 300.0),
            (9, 40.0, 1960.0)]
    rows += [(1000 + i, 20.0 + 3 * i, 20.0) for i in range(new)]
    upd = ingest_batch(32, rows)
    jmesh = jstep.make_mesh(jcfg)
    jst = jstep.distribute_state(
        JaxState(**{f: jnp.asarray(v) for f, v in d.items()}), jcfg, jmesh)
    jst, jdrop = jstep.make_sharded_ingest(jcfg, jmesh)(
        jst, {k: jnp.asarray(v) for k, v in upd.items()})
    cfg = to_torch_cfg(jcfg)
    mesh = make_mesh(cfg, device="cpu")
    states = distribute_state(port_fleet(d), cfg, mesh)
    states, dropped = make_sharded_ingest(cfg, mesh)(states, upd)
    assert_state_equals_jax(collect_state(states), jst, "ingested")
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdrop))
    host = collect_state(states)
    live = host.oid[host.alive].tolist()
    assert len(live) == len(set(live))
    slots = shard_slots(cfg)
    where = torch.nonzero(host.alive & (host.oid == 0)).flatten().tolist()
    assert len(where) == 1 and where[0] // slots == mesh.size - 1
    assert (int(dropped.sum()) > 0) == (headroom == 1.0)
    assert int(host.alive.sum()) > alive


def test_make_mesh_refuses():
    """A halo narrower than the search radius, slabs an object crosses in
    one step, and (with no card) a mesh that names no device."""
    base = mesh_cfg((8, 1, 1), "fast", 0.0)
    narrow = base.replace(shard=dataclasses.replace(base.shard,
                                                    halo_width=50.0))
    with pytest.raises(ValueError, match="search radius"):
        make_mesh(to_torch_cfg(narrow), device="cpu")
    fast = base.replace(sim=dataclasses.replace(base.sim, max_speed=3000.0))
    with pytest.raises(ValueError, match="x-slab"):
        make_mesh(to_torch_cfg(fast), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_sharded_step(to_torch_cfg(base),
                              make_mesh(to_torch_cfg(base)))
