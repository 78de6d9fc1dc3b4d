"""The port's sort-based grid (tpu_collide_torch/index/grid.py) and
engine.grid_overflow against the JAX package, on the same numpy fleets.

Integer outputs (cell coordinates, bucket order and starts, candidate lists,
the overflow count, the radius query's mask) must be equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_collide.core.config import GridConfig
from tpu_collide.engine import grid_overflow as jax_grid_overflow
from tpu_collide.index import grid as jgrid
from tpu_collide_torch.engine import grid_overflow
from tpu_collide_torch.index import grid as tgrid
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


def _setup(is3d, capacity=64, n=400):
    cfg = jax_cfg(n, is3d=is3d)
    cfg = cfg.replace(grid=GridConfig(cell_size=100.0,
                                      cell_capacity=capacity))
    d = np_fleet(5, n, 1000.0 if is3d else 2000.0, is3d=is3d, dead=7)
    jst, st = both_states(d)
    return cfg, to_torch_cfg(cfg), jst, st


def _max_bucket(st, tcfg):
    index = tgrid.build_grid(st.pos, st.alive, tcfg)
    return int((index.starts[1:tcfg.num_cells + 1]
                - index.starts[:tcfg.num_cells]).max())


@pytest.mark.parametrize("is3d", [False, True])
def test_build_grid_matches_jax(is3d):
    cfg, tcfg, jst, st = _setup(is3d)
    want = jgrid.build_grid(jst.pos, jst.alive, cfg)
    got = tgrid.build_grid(st.pos, st.alive, tcfg)
    assert got.dims == tuple(want.dims)
    for f in ("cell3", "flat_cell", "order", "starts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # dead objects sit in the sentinel bucket, past every real one
    assert int(got.starts[tcfg.num_cells]) == int(st.alive.sum())


def test_cell_coords_clip_outside_the_world():
    cfg, tcfg, _, _ = _setup(False)
    pos = np.array([[-50.0, 10.0, 0.0], [2500.0, 1999.9, 0.0],
                    [100.0, 200.0, 0.0], [1e6, -1e6, 0.0]], np.float32)
    want = np.asarray(jgrid.cell_coords(jnp.asarray(pos), cfg))
    got = tgrid.cell_coords(torch.tensor(pos), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgrid.flatten_cells(got, tcfg).numpy(),
        np.asarray(jgrid.flatten_cells(jnp.asarray(want), cfg)))


@pytest.mark.parametrize("is3d,capacity", [(False, 64), (False, 3),
                                           (True, 64), (True, 2)])
def test_gather_candidates_matches_jax(is3d, capacity):
    """Candidate lists and masks equal, with a roomy and a truncating
    cell_capacity."""
    cfg, tcfg, jst, st = _setup(is3d, capacity)
    rng = np.random.default_rng(1)
    q = rng.uniform(-100.0, 1100.0 if is3d else 2100.0, (60, 3))
    if not is3d:
        q[:, 2] = 0.0
    q = q.astype(np.float32)
    jidx = jgrid.build_grid(jst.pos, jst.alive, cfg)
    tidx = tgrid.build_grid(st.pos, st.alive, tcfg)
    wc, wv = jgrid.gather_candidates(
        jidx, jgrid.cell_coords(jnp.asarray(q), cfg), cfg)
    gc, gv = tgrid.gather_candidates(
        tidx, tgrid.cell_coords(torch.tensor(q), tcfg), tcfg)
    assert gc.shape == (60, tcfg.stencil_size * capacity)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("is3d", [False, True])
def test_grid_overflow_matches_jax(is3d):
    """The bucket-truncation count equals the JAX package's, 0 with a
    fleet-exact cell_capacity and positive below it."""
    cfg, tcfg, jst, st = _setup(is3d)
    big = _max_bucket(st, tcfg)
    assert big > 3
    for cap, positive in ((big, False), (big - 1, True), (3, True)):
        c = cfg.replace(grid=GridConfig(cell_size=100.0, cell_capacity=cap))
        tc_ = to_torch_cfg(c)
        want = int(jax_grid_overflow(
            jgrid.build_grid(jst.pos, jst.alive, c), c))
        got = int(grid_overflow(tgrid.build_grid(st.pos, st.alive, tc_),
                                tc_))
        assert got == want, cap
        assert (got > 0) == positive, cap


@pytest.mark.parametrize("is3d", [False, True])
def test_query_radius_matches_jax(is3d):
    cfg, tcfg, jst, st = _setup(is3d)
    pos = np.asarray(jst.pos)[:50] + np.float32(3.0)
    jidx = jgrid.build_grid(jst.pos, jst.alive, cfg)
    tidx = tgrid.build_grid(st.pos, st.alive, tcfg)
    wc, wok = jgrid.query_radius(jidx, jst.pos, jst.alive, jnp.asarray(pos),
                                 80.0, cfg)
    gc, gok = tgrid.query_radius(tidx, st.pos, st.alive, torch.tensor(pos),
                                 80.0, tcfg)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    np.testing.assert_array_equal(gc.numpy()[gok.numpy()],
                                  np.asarray(wc)[np.asarray(wok)])
    assert gok.sum() > 50         # each query finds at least its own object
    with pytest.raises(ValueError):
        tgrid.query_radius(tidx, st.pos, st.alive, torch.tensor(pos), 150.0,
                           tcfg)
