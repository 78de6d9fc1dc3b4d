"""Shared pieces of the PyTorch port's parity tests: numpy-made fleets that
both packages take as the same arrays, and the comparisons between them."""
from __future__ import annotations

import numpy as np

from tpu_collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, SimConfig, SystemConfig,
                                     WorldConfig)
from tpu_collide.core.state import state_from_numpy as jax_state_from_numpy
import tpu_collide_torch as tt
from tpu_collide_torch.core.state import FIELDS, from_jax_numpy


def np_fleet(seed, n, world, is3d=False, accel=False, clustered=0.45,
             dead=0):
    """Fleet arrays from np.random.default_rng(seed): a share `clustered`
    of the objects in three gaussian clusters (in 3D, around z = 150 of a
    300 m deep world), the rest uniform; z, vz, az zero in 2D (the
    2D-world contract, DEVIATIONS #16); the last `dead` objects dead."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, world, (n, 3))
    centres = rng.uniform(0.3 * world, 0.7 * world, (3, 3))
    m = rng.random(n) < clustered
    pos[m] = (centres[rng.integers(0, 3, m.sum())]
              + rng.normal(0.0, 0.06 * world, (m.sum(), 3)))
    pos = np.clip(pos, 0.0, world)
    heading = rng.uniform(0.0, 2 * np.pi, n)
    speed = rng.uniform(5.0, 20.0, n)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                    np.zeros(n)], -1)
    acc = rng.normal(0.0, 0.8, (n, 3)) if accel else np.zeros((n, 3))
    acc[:, 2] = 0.0
    if is3d:
        pos[:, 2] = np.where(m, np.clip(rng.normal(150.0, 30.0, n), 0, 300),
                             rng.uniform(0.0, 300.0, n))
        vel[:, 2] = rng.normal(0.0, 3.0, n)
    else:
        pos[:, 2] = 0.0
    otype = rng.integers(0, 4, n)
    alive = np.arange(n) < n - dead
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(pos=f32(pos), vel=f32(vel), acc=f32(acc),
                heading=f32(heading),
                size=np.array([2.0, 4.0, 5.0, 1.0], np.float32)[otype],
                otype=otype.astype(np.int32), alive=alive,
                oid=np.arange(n, dtype=np.int32))


def jax_cfg(n, is3d=False, mode="fast", alerts=512, **detect):
    """A small config of the JAX package; the port takes it over JSON."""
    return SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(1000.0, 1000.0, 300.0) if is3d
                          else (2000.0, 2000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode=mode, **detect),
        alerts=AlertConfig(max_scene_alerts=alerts),
        sim=SimConfig(accel_change_prob=0.0))


def to_torch_cfg(cfg):
    return tt.SystemConfig.from_json(cfg.to_json())


def both_states(d):
    """(JAX state, port state on the CPU) holding the same arrays."""
    jst = jax_state_from_numpy(d["pos"], d["vel"], d["acc"], d["heading"],
                               d["size"], d["otype"], oid=d["oid"],
                               alive=d["alive"])
    return jst, from_jax_numpy(
        {f: np.asarray(getattr(jst, f)) for f in FIELDS}, device="cpu")


def alert_map(alerts, unordered=True):
    """{(vehicle, other): (risk, ttc, distance, rel_speed, priority)} of the
    valid alerts; pairs sorted when `unordered`."""
    v = np.asarray(alerts.valid)
    cols = [np.asarray(getattr(alerts, f))[v]
            for f in ("vehicle_oid", "other_oid", "risk", "ttc", "distance",
                      "rel_speed", "priority")]
    out = {}
    for a, b, *vals in zip(*cols):
        key = ((min(int(a), int(b)), max(int(a), int(b))) if unordered
               else (int(a), int(b)))
        out[key] = tuple(float(x) for x in vals)
    return out


def assert_alerts_equal(want, got):
    """Same pair sets; risk, ttc, distance and rel_speed at rtol = atol =
    1e-5 (the tolerance of tests/test_fused_kernel.py:132); priority
    exact."""
    assert set(got) == set(want), (sorted(set(want) - set(got)),
                                   sorted(set(got) - set(want)))
    for k in want:
        np.testing.assert_allclose(got[k][:4], want[k][:4], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
        assert got[k][4] == want[k][4], k
