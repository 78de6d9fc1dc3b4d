"""The port's integrator against the JAX integrator (2D and 3D, border
bounces, speed cap, dead slots) with the JAX draws injected, and the port's
fleet generator."""
import jax
import numpy as np
import pytest
import torch

from tpu_collide.core.config import SimConfig
from tpu_collide.sim.integrator import integrate as jax_integrate
from tpu_collide_torch.core.state import FIELDS
from tpu_collide_torch.sim import generate_fleet, integrate
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)

# 1e-6 relative and absolute: room for ulps of atan2 and of XLA's fused
# multiply-adds
TOL = dict(rtol=1e-6, atol=1e-6)


def _edge_fleet(is3d):
    """A fleet with objects on every border moving outward (bounces), some
    above the speed cap, some nearly still, and dead slots."""
    cfg = jax_cfg(200, is3d=is3d).replace(
        sim=SimConfig(accel_change_prob=0.5, accel_range=2.0))
    d = np_fleet(4, 200, 1000.0 if is3d else 2000.0, is3d=is3d, accel=True,
                 dead=7)
    hi = np.asarray(cfg.world.hi, np.float32)
    d["pos"][:10, 0], d["vel"][:10, 0] = 0.0, -12.0
    d["pos"][10:20, 1], d["vel"][10:20, 1] = hi[1], 9.0
    if is3d:
        d["pos"][20:30, 2], d["vel"][20:30, 2] = hi[2], 4.0
    d["vel"][30:40, :2] = 40.0
    d["vel"][40:45, :2] = 0.01
    return cfg, d


@pytest.mark.parametrize("is3d", [False, True])
def test_integrate_matches_jax_with_injected_draws(is3d):
    cfg, d = _edge_fleet(is3d)
    jst, st = both_states(d)
    key = jax.random.key(11)
    want = jax_integrate(jst, key, cfg)
    # the draws integrate takes from its key (tpu_collide/sim/integrator.py)
    k1, k2 = jax.random.split(key)
    redraw = jax.random.uniform(k1, (st.n, 1)) < cfg.sim.accel_change_prob
    new_acc = jax.random.uniform(k2, (st.n, 3), minval=-cfg.sim.accel_range,
                                 maxval=cfg.sim.accel_range)
    got = integrate(st, to_torch_cfg(cfg),
                    redraw=torch.from_numpy(np.array(redraw)),
                    new_acc=torch.from_numpy(np.array(new_acc)))
    assert 0 < int(np.asarray(redraw).sum()) < st.n
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f, **TOL)
    # the edge cases were reached: bounces reversed velocities
    assert (got.vel[:10, 0] > 0).all() and (got.vel[10:20, 1] < 0).all()


def test_integrate_with_generator_matches_jax_without_redraws():
    cfg, d = _edge_fleet(False)
    cfg = cfg.replace(sim=SimConfig(accel_change_prob=0.0))
    jst, st = both_states(d)
    want = jax_integrate(jst, jax.random.key(0), cfg)
    got = integrate(st, to_torch_cfg(cfg), torch.Generator().manual_seed(0))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f, **TOL)


@pytest.mark.parametrize("distribution", ["city_skew", "uniform"])
@pytest.mark.parametrize("is3d", [False, True])
def test_generate_fleet(distribution, is3d):
    cfg = to_torch_cfg(jax_cfg(3000, is3d=is3d))
    st = generate_fleet(torch.Generator().manual_seed(5), cfg, distribution)
    again = generate_fleet(torch.Generator().manual_seed(5), cfg,
                           distribution)
    for f in FIELDS:
        assert torch.equal(getattr(st, f), getattr(again, f)), f
    lo = torch.tensor(cfg.world.lo)
    hi = torch.tensor(cfg.world.hi)
    assert st.pos.dtype == torch.float32 and st.otype.dtype == torch.int32
    assert ((st.pos >= lo) & (st.pos <= hi)).all()
    speed = torch.linalg.vector_norm(st.vel, dim=1)
    assert (speed >= cfg.sim.speed_min - 1e-4).all()
    assert (speed <= cfg.sim.speed_max + 1e-4).all()
    assert torch.equal(st.size, torch.tensor(
        [2.0, 4.0, 5.0, 1.0])[st.otype.long()])
    assert st.alive.all() and (st.acc == 0).all()
    assert (st.vel[:, 2] == 0).all()
    if not is3d:
        assert (st.pos[:, 2] == 0).all()
