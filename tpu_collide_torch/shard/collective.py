"""The device mesh and the collectives of the sharded step: the port's
stand-in for `shard_map`'s `axis_index`, `ppermute`, `psum` and `pmax`.

One process drives every shard. A `Mesh` names one torch device per shard
in the JAX package's x-major linear order (ix * Dy + iy) * Dz + iz
(tpu_collide/shard/step.py:347-357); all shards may name the same device
(one card, or the CPU in the tests). A sharded value is a tuple with one
entry per shard in that order, each a tensor or a dict / tuple of tensors on
its shard's device. The collectives move what a shard receives to its
device; a move between two shards on one device is no copy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch


def tree_map(fn: Callable, tree):
    """fn applied to every tensor of a tensor, or of a dict, tuple or list
    of them (nested), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """shape: (Dx,), (Dx, Dy) or (Dx, Dy, Dz); axis_names: one name per
    axis; devices: one torch.device per shard in x-major linear order."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if len(self.devices) != self.size:
            raise ValueError(f"mesh of {self.size} shards given "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def coords(self, shard: int) -> Tuple[int, ...]:
        """The mesh coordinates of linear shard index `shard`."""
        out = []
        for d in reversed(self.shape):
            out.append(shard % d)
            shard //= d
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        """The linear shard index of mesh coordinates `coords`."""
        lin = 0
        for c, d in zip(coords, self.shape):
            lin = lin * d + c
        return lin

    def axis_index(self, shard: int, axis: str) -> int:
        """The shard's coordinate along the named axis (0 on an axis the
        mesh does not have, as the sharded step reads absent axes)."""
        if axis not in self.axis_names:
            return 0
        return self.coords(shard)[self.axis_names.index(axis)]


def ppermute(mesh: Mesh, values: Sequence, axis: str, perm) -> tuple:
    """jax.lax.ppermute along one named axis: `perm` lists (source,
    destination) coordinates on that axis; shards that differ in another
    coordinate exchange independently. A shard that receives nothing gets
    zeros of its own value's shapes and dtypes (False for bool)."""
    a = mesh.axis_names.index(axis)
    src_of = {dst: src for src, dst in perm}
    out = []
    for s, dev in enumerate(mesh.devices):
        c = list(mesh.coords(s))
        if c[a] in src_of:
            c[a] = src_of[c[a]]
            out.append(tree_map(lambda t: t.to(dev), values[mesh.index(c)]))
        else:
            out.append(tree_map(torch.zeros_like, values[s]))
    return tuple(out)


def _reduce(mesh: Mesh, values: Sequence[torch.Tensor], op) -> tuple:
    total = values[0]
    for v in values[1:]:
        total = op(total, v.to(total.device))
    return tuple(total.to(dev) for dev in mesh.devices)


def psum(mesh: Mesh, values: Sequence[torch.Tensor]) -> tuple:
    """The sum of the shards' values, on every shard (dtype kept)."""
    return _reduce(mesh, values, torch.add)


def pmax(mesh: Mesh, values: Sequence[torch.Tensor]) -> tuple:
    """The largest of the shards' values, on every shard."""
    return _reduce(mesh, values, torch.maximum)
