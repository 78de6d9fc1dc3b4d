"""The port's config tuners (kernels/tune.py) against the JAX package's
(tpu_collide/kernels/tune.py) on the same numpy-made fleets: exact
integers and equal configs. The survivor probe against the Pallas kernel
in interpret mode is in the slow tier."""
import dataclasses

import jax
import pytest
import torch

import tpu_collide.kernels.tune as jtune
from tpu_collide.core.config import GridConfig, WorldConfig
from tpu_collide_torch.core.config import SimConfig
from tpu_collide_torch.engine import grid_overflow
from tpu_collide_torch.index.grid import build_grid
from tpu_collide_torch.kernels import tune
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk_plain
from tpu_collide_torch.sim.integrator import integrate
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("is3d", [False, True])
def test_suggest_cell_capacity_matches_jax(is3d):
    """The same capacity as the JAX package's, and at that capacity the
    grid path drops nothing (at the densest cell's occupancy minus one it
    would)."""
    n = 500
    cfg = jax_cfg(n, is3d=is3d)
    jst, st = both_states(np_fleet(2, n, 1000.0 if is3d else 2000.0,
                                   is3d=is3d, clustered=0.8, dead=30))
    cap = tune.suggest_cell_capacity(st, to_torch_cfg(cfg))
    assert cap == jtune.suggest_cell_capacity(jst, cfg)
    assert tune.suggest_cell_capacity(st, to_torch_cfg(cfg), margin=0) \
        == jtune.suggest_cell_capacity(jst, cfg, margin=0)
    tcfg = to_torch_cfg(cfg)
    index = build_grid(st.pos, st.alive, tcfg)
    exact = tcfg.replace(grid=dataclasses.replace(tcfg.grid,
                                                  cell_capacity=cap))
    assert int(grid_overflow(index, exact)) == 0
    occ = int((index.starts[1:tcfg.num_cells + 1]
               - index.starts[:tcfg.num_cells]).max())
    short = tcfg.replace(grid=dataclasses.replace(tcfg.grid,
                                                  cell_capacity=occ - 1))
    assert int(grid_overflow(index, short)) > 0


@pytest.mark.parametrize("world,cell", [((2000.0, 2000.0, 0.0), 40.0),
                                        ((2000.0, 2000.0, 300.0), 100.0),
                                        ((2000.0, 2000.0, 300.0), 150.0)])
def test_suggest_cell_size_and_tune_config_match_jax(world, cell):
    cfg = jax_cfg(100).replace(world=WorldConfig(hi=world),
                               grid=GridConfig(cell_size=cell))
    tcfg = to_torch_cfg(cfg)
    assert tune.suggest_cell_size(tcfg) == jtune.suggest_cell_size(cfg)
    jcfg, jwr = jtune.tune_config(cfg)
    got, wr = tune.tune_config(tcfg)
    assert jwr is None and wr is None
    assert got == to_torch_cfg(jcfg)
    assert got.detect.gate_stage1 == (world[2] > 0)


def _survivor_need(cfg, st):
    """sum over live rows of min(emitted, survivor_k), from the plain
    version's survivor counts."""
    cl = build_cell_list(st, cfg)
    em = fused_topk_plain(cl, cfg, "survivors").emitted
    k = cfg.detect.survivor_k
    return int(torch.where(cl.alive, torch.clamp_max(em, k), 0).sum())


def test_measure_survivor_need_and_cap():
    """The probe reads the kernel's survivor counts (the plain version on
    the CPU); with steps it returns the worst of the stepped states, as
    many single measurements give; the cap follows the JAX package's
    rounding."""
    n = 400
    cfg = to_torch_cfg(jax_cfg(n, mode="precise")).replace(
        sim=SimConfig(accel_change_prob=0.5))
    _, st = both_states(np_fleet(4, n, 1000.0, clustered=0.7))
    need = tune.measure_survivor_need(cfg, st)
    assert need == _survivor_need(cfg, st) > 0
    folded = tune.measure_survivor_need(cfg, st, torch.Generator()
                                        .manual_seed(1), steps=3)
    gen = torch.Generator().manual_seed(1)
    worst, cur = 0, st
    for _ in range(3):
        cur = integrate(cur, cfg, gen)
        worst = max(worst, _survivor_need(cfg, cur))
    assert folded == worst
    cap = tune.suggest_survivor_cap(cfg, st)
    want = max(1024, need + need // 8 + 128)
    assert cap == 1 << (want - 1).bit_length() and cap >= need


@pytest.mark.slow
def test_measure_survivor_need_matches_pallas_interpret():
    """The survivor need of the port against the JAX package's Pallas
    kernel in interpret mode, on the state and over 2 physics steps
    (accel_change_prob 0, so both integrators take the same steps)."""
    n = 500
    cfg = jax_cfg(n, mode="precise")
    jst, st = both_states(np_fleet(6, n, 1000.0, clustered=0.7))
    tcfg = to_torch_cfg(cfg)
    want = jtune.measure_survivor_need(cfg, jst, interpret=True)
    assert tune.measure_survivor_need(tcfg, st) == want > 0
    keys = jax.random.split(jax.random.key(3), 2)
    assert tune.measure_survivor_need(tcfg, st, torch.Generator(), steps=2) \
        == jtune.measure_survivor_need(cfg, jst, keys, interpret=True)
    assert tune.suggest_survivor_cap(tcfg, st) \
        == jtune.suggest_survivor_cap(cfg, jst, interpret=True)
