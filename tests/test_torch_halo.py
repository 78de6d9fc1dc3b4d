"""The port's halo exchange and migration (tpu_collide_torch/shard/halo.py)
against the JAX package's (tpu_collide/shard/halo.py), and the fused
tail's own mask (kernels/cell_list.CellList.own, kernels/refine).

The JAX pieces run inside jax.shard_map on the 8-device CPU mesh, as the
sharded step runs them; the port's take the same per-shard arrays, made
from a numpy seed. Walls are dynamic (uneven) f32 tensors. Buffers,
masks, drop counts and migrated states must be equal element for element:
the pieces only gather, compare and scatter the f32 values they are given.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tpu_collide as tc
from tpu_collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, ShardConfig, SimConfig,
                                     WorldConfig)
from tpu_collide.core.state import ObjectState as JaxState
from tpu_collide.shard import halo as jh
from tpu_collide.shard import step as jstep
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tpu_collide_torch.kernels.refine import (_hot_topup, fused_scene_fast,
                                              fused_scene_precise)
from tpu_collide_torch.shard import collective, halo as th
from tpu_collide_torch.shard import step as tstep
from tests.torch_parity import np_fleet, to_torch_cfg

torch.set_num_threads(1)

WORLD = 2000.0
HOPS = (1, 2, 3)
HOP_WIDTH = 300.0       # wider than the narrowest slab: hops 2-3 matter
PACK_CAP = 8
MIGRATE_CAP = 4
# dynamic walls: each slab at least HOP_WIDTH / 2 wide
WALLS = {(8, 1): ([0.0, 200.0, 450.0, 700.0, 1000.0, 1250.0, 1500.0,
                   1800.0, 2000.0], None),
         (4, 2): ([0.0, 450.0, 1000.0, 1500.0, 2000.0],
                  [0.0, 900.0, 2000.0])}


def mesh_cfg(grid):
    return tc.SystemConfig(
        num_objects=400, world=WorldConfig(hi=(WORLD, WORLD, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=512),
        shard=ShardConfig(num_shards=grid[0], num_shards_y=grid[1],
                          halo_capacity=16, migrate_capacity=MIGRATE_CAP,
                          slot_headroom=3.0))


def crossing_layout(jcfg, grid, seed=3):
    """The JAX [D * slots] layout of a numpy fleet distributed by the
    dynamic walls, then moved so that pieces bind: in every slab 12 objects
    at one x, 20 m inside its lower wall (ties for the pack and halo caps),
    and 6 objects at one x, 4 m past each wall they sit next to (they
    migrate; more than MIGRATE_CAP, all tied), 2 exactly on its upper
    wall (they belong to the slab above) and 2 exactly on its lower wall
    (they stay); on a 2D grid 4 more past each y wall."""
    n = jcfg.num_objects
    d = np_fleet(seed, n, WORLD)
    bx, by = WALLS[grid]
    jst = JaxState(**{f: jnp.asarray(v) for f, v in d.items()})
    mesh = jstep.make_mesh(jcfg)
    walls = (jnp.asarray(bx, jnp.float32),
             None if by is None else jnp.asarray(by, jnp.float32))
    lay = jstep.distribute_state(jst, jcfg, mesh, *walls)
    lay = {f: np.array(getattr(lay, f)) for f in FIELDS}
    slots = jstep.shard_slots(jcfg)
    rng = np.random.default_rng(seed)
    for s in range(mesh.devices.size):
        ix = s // grid[1]
        rows = np.flatnonzero(lay["alive"][s * slots:(s + 1) * slots]) \
            + s * slots
        rng.shuffle(rows)
        tie, lo_out, hi_out = rows[:12], rows[12:18], rows[18:24]
        lay["pos"][tie, 0] = np.float32(bx[ix] + 20.0)
        lay["pos"][lo_out, 0] = np.float32(bx[ix] - 4.0)
        lay["pos"][hi_out, 0] = np.float32(bx[ix + 1] + 4.0)
        lay["pos"][rows[32:34], 0] = np.float32(bx[ix + 1])
        lay["pos"][rows[34:36], 0] = np.float32(bx[ix])
        if by is not None:
            iy = s % grid[1]
            lay["pos"][rows[24:28], 1] = np.float32(by[iy] - 4.0)
            lay["pos"][rows[28:32], 1] = np.float32(by[iy + 1] + 4.0)
    return lay, walls, mesh


def jax_pieces(jcfg, grid, lay, walls, mesh, tag):
    """The halo pieces of every shard, inside jax.shard_map: pack of the
    lower band (with a tag riding as extra), migrate x then y (with the
    tag), halo_exchange_hops on x for each of HOPS, halo_exchange on y of
    the x-extended state, extend_with_halo with marks. Every output is
    concatenated over the shards in the mesh's order."""
    sdim = jstep._state_spec_axes(jcfg)
    two_d = grid[1] > 1
    by = walls[1] if two_d else jstep.equal_boundaries(jcfg, 1)

    def body(state, tag, bx, by):
        sx, sy, _ = jstep._shard_coords(jcfg)
        lo, _ = jh.slab_bounds(jcfg, sx, bx, 0)
        near = state.alive & (state.pos[:, 0] < lo + HOP_WIDTH)
        buf, valid, drop = jh.pack(state, near, PACK_CAP, lo,
                                   extra={"tag": tag}, dim=0)
        st_m, ex_m, mig = jh.migrate(state, jcfg, sx, bx,
                                     extra={"tag": tag}, dim=0)
        if two_d:
            st_m, ex_m, mig_y = jh.migrate(st_m, jcfg, sy, by, extra=ex_m,
                                           dim=1)
            mig = mig + mig_y
        hops = [jh.halo_exchange_hops(state, jcfg, sx, bx, 0,
                                      width=HOP_WIDTH, hops=h)
                for h in HOPS]
        ext = jh.extend_with_halo(state, hops[0][0], hops[0][1],
                                  mark_halo=True)
        halo_y = (jh.halo_exchange(ext, jcfg, sy, by, dim=1) if two_d
                  else None)
        r = lambda x: x.reshape(1)
        return dict(
            pack=(buf, valid, r(drop)), migrate=(st_m, ex_m, r(mig)),
            hops=[(b, v, r(dr)) for b, v, dr in hops], ext=ext,
            halo_y=None if halo_y is None else (halo_y[0], halo_y[1],
                                                r(halo_y[2])))

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P(sdim), P(sdim), P(), P()),
                              out_specs=P(sdim)))
    put = lambda v: jax.device_put(jnp.asarray(v),
                                   NamedSharding(mesh, P(sdim)))
    st = JaxState(**{f_: put(v) for f_, v in lay.items()})
    out = f(st, put(tag), walls[0], by)
    return jax.tree.map(np.asarray, out)


def port_shards(lay, d, slots):
    return tuple(ObjectState(**{
        f: torch.from_numpy(v[s * slots:(s + 1) * slots].copy())
        for f, v in lay.items()}) for s in range(d))


def chunks(a, d):
    return np.split(np.asarray(a), d)


def assert_tree_equal(got, want, what):
    """got: a (dict of) tensor(s) of one shard; want: the numpy chunk."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree_equal(got[k], want[k], f"{what}.{k}")
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g, want, err_msg=what)


def split_tree(tree, d):
    """A JAX output leaf-concatenated over the shards, as d per-shard
    trees."""
    if isinstance(tree, dict):
        parts = {k: split_tree(v, d) for k, v in tree.items()}
        return [{k: parts[k][s] for k in tree} for s in range(d)]
    if dataclasses.is_dataclass(tree):
        parts = {f.name: split_tree(getattr(tree, f.name), d)
                 for f in dataclasses.fields(tree)}
        return [{k: parts[k][s] for k in parts} for s in range(d)]
    return chunks(tree, d)


def state_dict(st):
    return {f: getattr(st, f) for f in FIELDS}


@pytest.fixture(scope="module", params=[(8, 1), (4, 2)], ids=["8x1", "4x2"])
def pieces(request):
    grid = request.param
    jcfg = mesh_cfg(grid)
    lay, walls, jmesh = crossing_layout(jcfg, grid)
    d = grid[0] * grid[1]
    slots = jstep.shard_slots(jcfg)
    tag = np.arange(d * slots, dtype=np.int32) * 7 + 1
    want = jax_pieces(jcfg, grid, lay, walls, jmesh, tag)
    cfg = to_torch_cfg(jcfg)
    mesh = tstep.make_mesh(cfg, device="cpu")
    states = port_shards(lay, d, slots)
    tags = [torch.from_numpy(t) for t in chunks(tag, d)]
    bx = torch.tensor(np.asarray(walls[0]))
    by = None if walls[1] is None else torch.tensor(np.asarray(walls[1]))
    return dict(grid=grid, cfg=cfg, mesh=mesh, states=states, tags=tags,
                bx=bx, by=by, want=want, d=d)


def test_pack_keeps_the_nearest_with_stable_ties(pieces):
    """The lower band of every shard through pack with a cap that binds on
    12 objects at one x: the same rows kept (lowest slots among ties), the
    same tag riding along, the same count dropped."""
    p = pieces
    buf_w, valid_w, drop_w = p["want"]["pack"]
    bufs, valids, drops = (split_tree(buf_w, p["d"]),
                           chunks(valid_w, p["d"]), chunks(drop_w, p["d"]))
    dropped_any = 0
    for s, (st, tag) in enumerate(zip(p["states"], p["tags"])):
        ix = p["mesh"].axis_index(s, "shard")
        lo, _ = th.slab_bounds(p["cfg"], ix, p["bx"], 0)
        near = st.alive & (st.pos[:, 0] < lo + HOP_WIDTH)
        buf, valid, drop = th.pack(st, near, PACK_CAP, lo, extra={"tag": tag})
        assert_tree_equal(buf, bufs[s], f"shard {s} buffer")
        assert_tree_equal(valid, valids[s], f"shard {s} valid")
        assert int(drop) == int(drops[s][0])
        dropped_any += int(drop)
    assert dropped_any > 0


def test_migrate_matches_jax_with_tied_emigrants(pieces):
    """Migration along x (and y on the 4x2 grid) with 6 tied emigrants a
    wall against a capacity of 4: equal slot layouts, equal tags carried
    along, equal drop counts."""
    p = pieces
    st_w, ex_w, mig_w = p["want"]["migrate"]
    states_w = split_tree(st_w, p["d"])
    tags_w = split_tree(ex_w, p["d"])
    walls = (p["bx"], p["by"])
    states, extras, drops = th.migrate(p["states"], p["cfg"], p["mesh"],
                                       p["bx"],
                                       extras=[{"tag": t} for t in p["tags"]])
    if p["by"] is not None:
        states, extras, drops_y = th.migrate(states, p["cfg"], p["mesh"],
                                             walls[1], extras=extras, dim=1)
        drops = tuple(a + b for a, b in zip(drops, drops_y))
    for s in range(p["d"]):
        assert_tree_equal(state_dict(states[s]), states_w[s], f"shard {s}")
        assert_tree_equal(extras[s], tags_w[s], f"shard {s} extra")
    got = [int(x) for x in drops]
    assert got == [int(x) for x in mig_w]
    assert sum(got) > 0


@pytest.mark.parametrize("hop_i", range(len(HOPS)),
                         ids=[f"hops{h}" for h in HOPS])
def test_halo_exchange_hops_matches_jax(pieces, hop_i):
    """halo_exchange_hops along x with a band wider than the narrowest
    slab, at hops 1, 2 and 3: equal buffers, masks and drops per shard."""
    p = pieces
    buf_w, valid_w, drop_w = p["want"]["hops"][hop_i]
    bufs_w = split_tree(buf_w, p["d"])
    got = th.halo_exchange_hops(p["states"], p["cfg"], p["mesh"], p["bx"],
                                0, width=HOP_WIDTH, hops=HOPS[hop_i])
    for s, (buf, valid, drop) in enumerate(got):
        assert_tree_equal(buf, bufs_w[s], f"shard {s} buffer")
        assert_tree_equal(valid, chunks(valid_w, p["d"])[s], f"shard {s}")
        assert int(drop) == int(drop_w[s])
    assert sum(int(v.sum()) for _, v, _ in got) > 0


def test_extend_with_halo_and_the_y_phase_match_jax(pieces):
    """extend_with_halo (mirrors marked -(oid + 2)) of the hop-1 halo, and
    on the 4x2 grid halo_exchange along y of the x-extended states (where
    the x mirrors travel on with their marks)."""
    p = pieces
    halo = th.halo_exchange_hops(p["states"], p["cfg"], p["mesh"], p["bx"],
                                 0, width=HOP_WIDTH)
    ext = tuple(th.extend_with_halo(st, b, v, mark_halo=True)
                for st, (b, v, _) in zip(p["states"], halo))
    ext_w = split_tree(p["want"]["ext"], p["d"])
    for s in range(p["d"]):
        assert_tree_equal(state_dict(ext[s]), ext_w[s], f"shard {s}")
        n_own = p["states"][s].n
        mirror = ext[s].oid[n_own:][ext[s].alive[n_own:]]
        assert (mirror <= -2).all()
    if p["by"] is None:
        return
    buf_w, valid_w, drop_w = p["want"]["halo_y"]
    bufs_w = split_tree(buf_w, p["d"])
    got = th.halo_exchange(ext, p["cfg"], p["mesh"], p["by"], dim=1)
    for s, (buf, valid, drop) in enumerate(got):
        assert_tree_equal(buf, bufs_w[s], f"shard {s} y buffer")
        assert_tree_equal(valid, chunks(valid_w, p["d"])[s], f"shard {s}")
        assert int(drop) == int(drop_w[s])


def test_equal_walls_are_the_jax_f32_walls():
    """equal_boundaries and slab_bounds without walls give JAX's f32 values
    on slabs of a width f32 cannot hold (1000 m / 3)."""
    jcfg = tc.SystemConfig(world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
                           shard=ShardConfig(num_shards=3))
    cfg = to_torch_cfg(jcfg)
    want = np.asarray(jstep.equal_boundaries(jcfg, 0))
    np.testing.assert_array_equal(
        tstep.equal_boundaries(cfg, 0, device="cpu").numpy(), want)
    for i in range(3):
        got = [float(x) for x in th.slab_bounds(cfg, i)]
        assert got == [float(x) for x in jh.slab_bounds(jcfg, jnp.int32(i))]


def test_place_fills_the_lowest_free_slots():
    """place against the JAX function on one shard: arrivals take the
    lowest dead slots, invalid rows are skipped, arrivals beyond the free
    slots are counted, an extra field lands beside its object."""
    n, cap = 24, 8
    d = np_fleet(5, n, WORLD)
    d["alive"][[0, 1, 2, 10]] = False
    arrivals = np_fleet(6, cap, WORLD)
    valid = np.ones(cap, bool)
    valid[[1, 4]] = False
    extra = np.arange(n, dtype=np.int32)
    xbuf = np.arange(cap, dtype=np.int32) + 100
    jst = JaxState(**{f: jnp.asarray(v) for f, v in d.items()})
    jbuf = {f: jnp.asarray(arrivals[f]) for f in th.XCHG_FIELDS}
    jbuf["x:id"] = jnp.asarray(xbuf)
    js, jx, jdrop = jh.place(jst, jbuf, jnp.asarray(valid),
                             extra={"id": jnp.asarray(extra)})
    st = ObjectState(**{f: torch.from_numpy(np.asarray(v))
                        for f, v in d.items()})
    buf = {f: torch.from_numpy(arrivals[f]) for f in th.XCHG_FIELDS}
    buf["x:id"] = torch.from_numpy(xbuf)
    ts, tx, tdrop = th.place(st, buf, torch.from_numpy(valid),
                             extra={"id": torch.from_numpy(extra)})
    assert_tree_equal(state_dict(ts), {f: np.asarray(getattr(js, f))
                                       for f in FIELDS}, "placed")
    np.testing.assert_array_equal(tx["id"].numpy(), np.asarray(jx["id"]))
    assert int(tdrop) == int(jdrop) > 0


def test_ppermute_sends_along_one_axis_and_zeros_the_edges():
    """On a 4x2 mesh, a shift along x moves each column independently;
    the shards that receive nothing get zeros (False for bool)."""
    mesh = collective.Mesh((4, 2), ("x", "y"), (torch.device("cpu"),) * 8)
    vals = [(torch.full((3,), s), torch.ones(2, dtype=torch.bool))
            for s in range(8)]
    got = collective.ppermute(mesh, vals, "x", [(i, i + 1) for i in range(3)])
    for s in range(8):
        ix, iy = mesh.coords(s)
        if ix == 0:
            assert got[s][0].tolist() == [0, 0, 0]
            assert not got[s][1].any()
        else:
            assert got[s][0].tolist() == [mesh.index((ix - 1, iy))] * 3
    assert collective.psum(mesh, [torch.tensor(s) for s in range(8)])[3] == 28
    assert collective.pmax(mesh, [torch.tensor(s) for s in range(8)])[0] == 7


# ---- the own mask of the fused tail ----------------------------------------

def own_cfg(mode="fast", k=2, hot_topup=8):
    return to_torch_cfg(tc.SystemConfig(
        num_objects=120, world=WorldConfig(hi=(600.0, 600.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode=mode, hot_topup=hot_topup),
        alerts=AlertConfig(max_scene_alerts=2048, max_alerts_per_object=k)))


def cluster_state(seed=9):
    """A dense 120-object fleet in a 600 m world: many rows hot at k = 2."""
    d = np_fleet(seed, 120, 600.0, clustered=0.8)
    return ObjectState(**{f: torch.from_numpy(np.asarray(v))
                          for f, v in d.items()})


def split_with_mirrors(st, n_own):
    """The first n_own objects owned, the rest their mirrors (marked)."""
    oid = st.oid.clone()
    oid[n_own:] = th.mark_oids(oid[n_own:])
    return st.replace(oid=oid)


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_mirror_rows_emit_nothing_and_oids_decode(mode):
    """The alerts of a state whose last 50 rows are marked mirrors are the
    unmarked state's alerts of the 70 owned rows, with decoded ids; the
    risks count owned rows; stage-1 pairs count every row. Every hot row
    is topped up, so both lists are complete."""
    cfg = own_cfg(mode, k=8, hot_topup=128)
    st = cluster_state()
    scene = fused_scene_fast if mode == "fast" else fused_scene_precise
    full = scene(build_cell_list(st, cfg), cfg)
    cl = build_cell_list(split_with_mirrors(st, 70), cfg)
    part = scene(cl, cfg)

    def alerts(res):
        a = res.alerts
        v = a.valid
        return {(int(x), int(y)): (float(r), float(t)) for x, y, r, t in zip(
            a.vehicle_oid[v], a.other_oid[v], a.risk[v], a.ttc[v])}

    want = {k: v for k, v in alerts(full).items() if k[0] < 70}
    got = alerts(part)
    assert got == want and want
    assert int(full.alerts.count) < cfg.alerts.max_scene_alerts
    assert all(o >= 0 for pair in got for o in pair)
    assert any(k[1] >= 70 for k in got)          # pairs with mirrors kept
    assert int(part.num_checked) == int(full.num_checked)
    own_rows = cl.own
    assert int(own_rows.sum()) == 70
    assert torch.equal(cl.oid_decoded, build_cell_list(st, cfg).oid)
    if mode == "fast":
        assert float(part.max_risk) == float(full.max_risk)


def test_a_hot_mirror_row_gets_no_topup():
    """At k = 2 many rows are hot. The hot top-up covers owned rows only:
    no mirror row is covered, and alert_overflow counts owned rows only."""
    cfg = own_cfg("fast", k=2)
    st = cluster_state()
    cl = build_cell_list(split_with_mirrors(st, 70), cfg)
    s = fused_topk(cl, cfg, "hits")
    hot_mirror = (~cl.own & cl.alive & (s.qual > 2))
    assert int(hot_mirror.sum()) > 0
    covered, *_ = _hot_topup(cl, cfg, s.qual, 2)
    assert covered.any() and not (covered & ~cl.own).any()
    res = fused_scene_fast(cl, cfg)
    want = torch.where(cl.own & ~covered, torch.clamp_min(s.qual - 2, 0),
                       torch.zeros_like(s.qual)).sum()
    assert int(res.alert_overflow) == int(want)


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_without_a_halo_every_output_is_unchanged(mode):
    """own equals alive without a halo, and a halo of invalid rows changes
    no output of either tail."""
    cfg = own_cfg(mode, k=2)
    st = cluster_state()
    cl = build_cell_list(st, cfg)
    assert torch.equal(cl.own, cl.alive)
    scene = fused_scene_fast if mode == "fast" else fused_scene_precise
    base = scene(cl, cfg)
    empty = {f: getattr(st, f)[:5] for f in th.XCHG_FIELDS}
    ext = th.extend_with_halo(st, empty, torch.zeros(5, dtype=torch.bool),
                              mark_halo=True)
    res = scene(build_cell_list(ext, cfg), cfg)
    for f in ("num_checked", "num_risks", "max_risk", "alert_overflow"):
        assert float(getattr(res, f)) == float(getattr(base, f)), f
    for f in dataclasses.fields(base.alerts):
        assert torch.equal(getattr(res.alerts, f.name),
                           getattr(base.alerts, f.name)), f.name
