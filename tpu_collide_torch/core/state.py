"""Fleet state as a structure of tensors (the port of tpu_collide.core.state).

`from_jax_numpy` is how a fleet crosses over from the JAX package: it takes
the JAX state's fields as numpy arrays, so the two packages see the same
numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from tpu_collide_torch.core.device import resolve_device

FIELDS = ("pos", "vel", "acc", "heading", "size", "otype", "alive", "oid")


@dataclasses.dataclass(frozen=True)
class ObjectState:
    """All tensors share leading dim N and one device.

    pos/vel/acc: [N, 3] float32 (m, m/s, m/s^2)
    heading:     [N] float32 radians
    size:        [N] float32 (m)
    otype:       [N] int32 index into config.VEHICLE_TYPES
    alive:       [N] bool (dead slots take no part in detection)
    oid:         [N] int32 stable external object id
    """
    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    heading: torch.Tensor
    size: torch.Tensor
    otype: torch.Tensor
    alive: torch.Tensor
    oid: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kw) -> "ObjectState":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict:
        """{field: numpy array}, the inverse of `from_jax_numpy`."""
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}


def empty_state(n: int, device=None) -> ObjectState:
    """All-dead fleet of capacity n, on the card unless `device` names
    another."""
    device = resolve_device(device)
    f3 = lambda: torch.zeros((n, 3), dtype=torch.float32, device=device)
    f1 = lambda: torch.zeros((n,), dtype=torch.float32, device=device)
    return ObjectState(
        pos=f3(), vel=f3(), acc=f3(), heading=f1(), size=f1(),
        otype=torch.zeros((n,), dtype=torch.int32, device=device),
        alive=torch.zeros((n,), dtype=torch.bool, device=device),
        oid=torch.arange(n, dtype=torch.int32, device=device),
    )


def state_from_numpy(pos, vel, acc, heading, size, otype, oid=None,
                     alive=None, device=None) -> ObjectState:
    """The state of the given arrays, on the card unless `device` names
    another."""
    n = np.shape(pos)[0]
    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    return ObjectState(
        pos=f32(pos), vel=f32(vel), acc=f32(acc), heading=f32(heading),
        size=f32(size), otype=i32(otype),
        alive=(torch.ones((n,), dtype=torch.bool, device=device)
               if alive is None
               else torch.tensor(np.asarray(alive, bool), device=device)),
        oid=(torch.arange(n, dtype=torch.int32, device=device)
             if oid is None else i32(oid)),
    )


def from_jax_numpy(d: Mapping[str, np.ndarray], device=None) -> ObjectState:
    """The port's state from the JAX state's fields given as numpy arrays
    ({'pos': ..., 'vel': ..., ...}, every name of FIELDS), on the card unless
    `device` names another."""
    missing = [f for f in FIELDS if f not in d]
    if missing:
        raise ValueError(f"JAX state fields missing: {missing}")
    return state_from_numpy(d["pos"], d["vel"], d["acc"], d["heading"],
                            d["size"], d["otype"], oid=d["oid"],
                            alive=d["alive"], device=device)


def conform_fleet(state: ObjectState, cfg) -> ObjectState:
    """A fleet taken from the host, brought to the config's contract (the
    2D part of tpu_collide.core.state.conform_fleet): a 2D world treats z,
    vz and az as exactly 0 on the fused path, so they are zeroed and both
    backends see the same data. The JAX function's oid-range check has no
    counterpart: the port keeps oids as int32 beside the records, so every
    int32 oid is exact."""
    if cfg.world.is_3d:
        return state
    flat = lambda x: torch.cat([x[:, :2], torch.zeros_like(x[:, 2:])], dim=1)
    return state.replace(pos=flat(state.pos), vel=flat(state.vel),
                         acc=flat(state.acc))
