"""The port's cell list against the JAX package's build_cell_list: per-cell
membership, cell_start[b * nx] == cr_start[b], n_alive, dead objects, and
the stencil runs the kernel walks. The sorted records against the gathers
and torch.cat that built them before the record kernel (csrc/
cell_records.cu, held to its plain version on the card by
tests/test_torch_cell_records_card.py and chip_smoke.py)."""
import numpy as np
import pytest
import torch

from tpu_collide.kernels.cell_list import build_cell_list as jax_build
from tpu_collide_torch.kernels.cell_list import (FI, FIELD_NAMES, NF,
                                                 build_cell_list,
                                                 cell_records,
                                                 cell_records_plain,
                                                 stencil_pairs)
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


def _np_cells(d, cfg):
    """Flat cell id of every object, in f32 exactly as cell_list.py:355-361
    computes it."""
    nx, ny, nz = cfg.grid_dims
    c3 = np.floor((d["pos"] - np.asarray(cfg.world.lo, np.float32))
                  / np.float32(cfg.grid.cell_size)).astype(np.int32)
    c3 = np.clip(c3, 0, np.array([nx, ny, nz]) - 1)
    return (c3[:, 2] * ny + c3[:, 1]) * nx + c3[:, 0]


@pytest.mark.parametrize("is3d", [False, True])
def test_cell_list_matches_jax(is3d):
    n, dead = 400, 9
    cfg = jax_cfg(n, is3d=is3d)
    d = np_fleet(1, n, 1000.0 if is3d else 2000.0, is3d=is3d, dead=dead)
    d["alive"][[3, 50]] = False            # dead inside the fleet too
    jst, st = both_states(d)
    jcl = jax_build(jst, cfg)
    cl = build_cell_list(st, to_torch_cfg(cfg))
    nx, ny, nz = cfg.grid_dims
    n_alive = int(d["alive"].sum())

    assert int(jcl.overflow) == 0
    assert int(cl.n_alive) == int(jcl.n_alive) == n_alive
    assert int(cl.overflow) == 0
    cr_start = np.asarray(jcl.cr_start)
    cell_start = cl.cell_start.numpy()
    assert cr_start.shape == (ny * nz + 1,)
    np.testing.assert_array_equal(cell_start[np.arange(ny * nz + 1) * nx],
                                  cr_start)

    # per-cell membership: the objects of cell c are exactly those whose
    # f32 cell id is c, in both packages (JAX sorts by the same key, so its
    # oids run through the cells in the same order)
    cells = _np_cells(d, cfg)
    alive_oids = np.flatnonzero(d["alive"])
    j_oid = np.asarray(jcl.oid_flat)[:n_alive]
    p_oid = cl.oid.numpy()[:n_alive]
    np.testing.assert_array_equal(cells[j_oid], cells[p_oid])
    assert sorted(p_oid) == sorted(alive_oids)
    for c in np.unique(cells[alive_oids]):
        members = set(cl.oid.numpy()[cell_start[c]:cell_start[c + 1]])
        assert members == set(alive_oids[cells[alive_oids] == c])
    np.testing.assert_array_equal(np.diff(cell_start) >= 0, True)

    # dead objects sort last and belong to no cell
    assert set(cl.oid.numpy()[n_alive:]) == set(np.flatnonzero(~d["alive"]))
    assert (cl.cell.numpy()[n_alive:] == cfg.num_cells).all()
    assert not cl.alive.numpy()[n_alive:].any()

    # sorted records carry each object's fields
    order = cl.order.numpy()
    np.testing.assert_array_equal(cl.oid.numpy(), d["oid"][order])
    for i, name in enumerate(("x", "y", "z")):
        np.testing.assert_array_equal(
            cl.fields[:, FIELD_NAMES.index(name)].numpy(),
            d["pos"][order, i])
    np.testing.assert_array_equal(
        cl.fields[:, FIELD_NAMES.index("heading")].numpy(),
        d["heading"][order])


@pytest.mark.parametrize("is3d", [False, True])
def test_stencil_pairs_cover_neighbour_cells(is3d):
    """The runs of a row are exactly the objects of the (up to) 3x3(x3)
    cells around its own, each once, in ascending sorted order."""
    n = 300
    cfg = jax_cfg(n, is3d=is3d)
    d = np_fleet(2, n, 1000.0 if is3d else 2000.0, is3d=is3d, dead=5)
    _, st = both_states(d)
    cl = build_cell_list(st, to_torch_cfg(cfg))
    nx, ny, nz = cfg.grid_dims
    cell = cl.cell.numpy()
    alive = cl.alive.numpy()
    xyz = np.stack([cell % nx, (cell // nx) % ny, cell // (nx * ny)], 1)
    rows = torch.arange(n)
    own, cand = stencil_pairs(cl, rows)
    own, cand = own.numpy(), cand.numpy()
    for r in range(n):
        got = cand[own == r]
        if not alive[r]:
            assert got.size == 0
            continue
        near = np.all(np.abs(xyz - xyz[r]) <= 1, axis=1) & alive
        assert np.all(np.diff(got) > 0)
        np.testing.assert_array_equal(got, np.flatnonzero(near))


def _records_by_cat(state, order, cls):
    """The records and oids as build_cell_list made them with one ten-piece
    torch.cat of gathered and computed columns."""
    heading = state.heading[order]
    cls_col = (torch.zeros((state.n, 1), dtype=torch.float32)
               if cls is None else cls[order, None].to(torch.float32))
    fields = torch.cat([
        state.pos[order], state.vel[order], state.acc[order],
        state.size[order, None], heading[:, None],
        state.otype[order, None].to(torch.float32),
        torch.sin(heading)[:, None], torch.cos(heading)[:, None],
        cls_col, torch.zeros((state.n, 1), dtype=torch.float32),
    ], dim=1).contiguous()
    return fields, state.oid[order].contiguous()


def _record_fleet(fleet, is3d):
    """(numpy fleet, marked rows) of a records case: dead rows inside the
    fleet, halo mirrors' marked oids, one object, or none."""
    n = {"dead_inside": 300, "halo": 300, "one": 1, "empty": 0}[fleet]
    d = np_fleet(4, 300, 1000.0 if is3d else 2000.0, is3d=is3d, dead=7)
    d = {k: v[:n] for k, v in d.items()}
    marked = np.zeros(n, bool)
    if fleet == "dead_inside":
        d["alive"][[3, 50, 120]] = False
    elif fleet == "halo":
        marked[::3] = True
        d["oid"] = np.where(marked, -(d["oid"] + 2), d["oid"])
    return d, marked


@pytest.mark.parametrize("fleet", ["dead_inside", "halo", "one", "empty"])
@pytest.mark.parametrize("with_cls", [False, True])
@pytest.mark.parametrize("is3d", [False, True])
def test_records_equal_the_cat(is3d, with_cls, fleet):
    """On the CPU build_cell_list's records and oids are the cat's, bit for
    bit, and cell_records takes the plain version: nothing launches."""
    d, marked = _record_fleet(fleet, is3d)
    n = len(d["oid"])
    cfg = to_torch_cfg(jax_cfg(max(n, 1), is3d=is3d))
    _, st = both_states(d)
    cls = (torch.from_numpy(np.random.default_rng(5).integers(
        0, 5, n).astype(np.int32)) if with_cls else None)
    before = cell_records.launches
    cl = build_cell_list(st, cfg, cls=cls)
    want_fields, want_oid = _records_by_cat(st, cl.order, cls)
    assert cl.fields.shape == (n, NF) and cl.fields.is_contiguous()
    assert cl.oid.dtype == torch.int32 and cl.oid.shape == (n,)
    bits = lambda x: x.view(torch.int32)
    assert torch.equal(bits(cl.fields), bits(want_fields))
    assert torch.equal(cl.oid, want_oid)
    for got in (cell_records(st, cl.order, cls),
                cell_records_plain(st, cl.order, cls)):
        assert torch.equal(bits(got[0]), bits(want_fields))
        assert torch.equal(got[1], want_oid)
    assert cell_records.launches == before      # CPU: the plain version
    order = cl.order.numpy()
    # halo marks ride along as the state holds them, and own rows skip them
    np.testing.assert_array_equal(cl.oid.numpy(), d["oid"][order])
    np.testing.assert_array_equal(cl.own.numpy(),
                                  d["alive"][order] & ~marked[order])
    want_cls = (np.zeros(n, np.float32) if cls is None
                else cls.numpy()[order].astype(np.float32))
    np.testing.assert_array_equal(cl.fields[:, FI["cls"]].numpy(), want_cls)
    assert not cl.fields[:, FI["pad1"]].numpy().any()


def test_records_refuse_other_devices():
    d, _ = _record_fleet("one", False)
    _, st = both_states(d)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cell_records(st.replace(**{f: meta(getattr(st, f)) for f in
                                   ("pos", "vel", "acc", "heading", "size",
                                    "otype", "alive", "oid")}),
                     meta(torch.zeros(1, dtype=torch.int64)))
