"""Load balancing for the sharded mesh (the port of
tpu_collide/shard/balance.py): density-aware re-tiling.

Equal slabs are the default. `LoadBalancer` watches the shards' occupancy
every `check_every` steps and, past an imbalance threshold or near a full
shard, moves the slab WALLS: quantile walls put about equal object counts
in every slab, clamped to a minimum width that keeps the halo and
one-slab-per-step migration sound (shard/step.check_boundaries). The walls
are computed on the host with numpy, as the JAX package computes them, so
the two packages choose the same walls bit for bit; `rebalance` collects
the fleet, computes them and redistributes the fleet under them.

A sharded state is a tuple of per-shard states (shard/step.py); the walls
come back as f32 tensors that make_sharded_step takes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.shard.collective import Mesh
from tpu_collide_torch.shard.step import (check_boundaries, collect_state,
                                          distribute_state)

logger = get_logger(__name__)


def shard_occupancy(states, cfg: SystemConfig,
                    slots: Optional[int] = None) -> np.ndarray:
    """[D] alive objects per shard, in the mesh's x-major order, read on
    the host in one copy. `slots` is accepted for the JAX signature (its
    sharded value is one reshaped array) and ignored."""
    del slots
    if len(states) != cfg.shard.total_shards:
        raise ValueError(f"{len(states)} shards given, the config has "
                         f"{cfg.shard.total_shards}")
    dev = states[0].alive.device
    return torch.stack([st.alive.sum().to(dev) for st in states]).cpu() \
        .numpy()


def imbalance(occ: np.ndarray) -> float:
    """max / mean occupancy (1.0: balanced). The reference triggered at
    1.2x the average (data_sharding.py:513-564)."""
    mean = occ.mean()
    return float(occ.max() / mean) if mean > 0 else 1.0


def quantile_boundaries(x: np.ndarray, d: int, lo: float, hi: float,
                        min_width: float) -> np.ndarray:
    """[d+1] walls that put about equal object counts in each slab, clamped
    to a minimum slab width (halo and migration correctness), in f64 as the
    JAX package computes them."""
    qs = np.quantile(x, np.linspace(0.0, 1.0, d + 1))
    qs[0], qs[-1] = lo, hi
    for i in range(1, d + 1):
        qs[i] = max(qs[i], qs[i - 1] + min_width)
    qs = np.minimum(qs, hi)
    for i in range(d - 1, 0, -1):
        qs[i] = min(qs[i], qs[i + 1] - min_width)
    return qs


class LoadBalancer:
    """Occupancy watcher and rebalance trigger for a sharded fleet (the
    reference's LoadBalancer / ShardManager rebalance,
    data_sharding.py:591-845)."""

    def __init__(self, cfg: SystemConfig, slots: int,
                 overload_ratio: float = 1.2, check_every: int = 100):
        self.cfg = cfg
        self.slots = slots
        self.overload_ratio = overload_ratio
        self.check_every = check_every
        self._step = 0
        self.stats = {"checks": 0, "rebalances": 0, "backoffs": 0}
        self.last_occupancy: Optional[np.ndarray] = None
        # the f64 x, y, z walls the last rebalance placed the fleet by
        self.last_walls: tuple = (None, None, None)
        self._post_rebalance_occ: Optional[np.ndarray] = None

    def min_slab_width(self) -> float:
        """The narrowest legal slab: the halo band must fit and no object
        may cross more than one slab per step."""
        c = self.cfg
        return max(c.shard.halo_width, c.sim.max_speed * c.sim.dt) * 1.01

    def should_rebalance(self, states) -> bool:
        """Call once per step; reads the occupancy every `check_every`
        steps."""
        self._step += 1
        if self._step % self.check_every:
            return False
        self.stats["checks"] += 1
        occ = shard_occupancy(states, self.cfg)
        self.last_occupancy = occ
        # skew that moving walls cannot fix (min_slab_width clamps against
        # one ultra-dense column): when the last rebalance left the
        # occupancy as it is, back off instead of paying a host round trip
        # every check
        if (self._post_rebalance_occ is not None
                and np.array_equal(occ, self._post_rebalance_occ)):
            self.stats["backoffs"] += 1
            if occ.max() >= 0.95 * self.slots:
                logger.warning(
                    "shard occupancy %s near slot limit %d and quantile "
                    "walls are clamped by min_slab_width — raise "
                    "ShardConfig.slot_headroom", occ.tolist(), self.slots)
            return False
        near_full = occ.max() >= 0.9 * self.slots
        return near_full or imbalance(occ) > self.overload_ratio

    def rebalance(self, states, mesh: Mesh):
        """Collect, compute quantile walls per sharded axis, redistribute
        under them. Returns (states, boundaries_x [Dx+1], boundaries_y
        [Dy+1] or None, boundaries_z [Dz+1] or None), the walls f32 tensors
        on the first shard's device; pass all of them to every later step.
        With a 2D / 3D tiling the y / z walls balance a fleet that x walls
        cannot (the reference's octree split). The fleet is placed by the
        f64 walls, kept in `last_walls`: whatever else follows the objects
        into their new slots (their trajectory rings) is placed by those."""
        sh, world = self.cfg.shard, self.cfg.world
        host = collect_state(states, device="cpu")
        packed = ObjectState(**{f: getattr(host, f)[host.alive]
                                for f in FIELDS})
        pos = packed.pos.numpy()
        walls = []
        for dim, d in enumerate((sh.num_shards, sh.num_shards_y,
                                 sh.num_shards_z)):
            if dim > 0 and d <= 1:
                walls.append(None)
                continue
            b = quantile_boundaries(pos[:, dim], d, world.lo[dim],
                                    world.hi[dim], self.min_slab_width())
            check_boundaries(self.cfg, b, dim=dim)
            walls.append(b)
        self.stats["rebalances"] += 1
        fmt = lambda b: np.round(b, 1).tolist() if b is not None else "-"
        logger.info("rebalanced %d objects across %dx%dx%d shards "
                    "(occupancy %s, x walls %s, y walls %s, z walls %s)",
                    packed.n, sh.num_shards, sh.num_shards_y,
                    sh.num_shards_z,
                    self.last_occupancy.tolist()
                    if self.last_occupancy is not None else "?",
                    *(fmt(b) for b in walls))
        # placed by the f64 walls, as the JAX package places them; the
        # steps compare positions with their f32 values
        self.last_walls = tuple(walls)
        new_states = distribute_state(packed, self.cfg, mesh, *walls)
        self._post_rebalance_occ = shard_occupancy(new_states, self.cfg)
        return (new_states, *(None if b is None else torch.tensor(
            b, dtype=torch.float32, device=mesh.devices[0]) for b in walls))
