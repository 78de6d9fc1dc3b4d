"""Halo exchange and object migration between shards (the port of
tpu_collide/shard/halo.py).

  * migration: objects whose coordinate left the local slab move wholesale
    to the neighbour shard along that axis (ownership is position);
  * halo: a boundary band of width >= search_radius is mirrored to the
    neighbour, so that pairs across a wall are detected.

Buffers have static sizes; an overflow drops the objects farthest from the
wall and is counted. The functions that only touch one shard (`pack`,
`kill`, `place`, `extend_with_halo`) take that shard's state; those that
exchange (`exchange_neighbors`, `migrate`, `halo_exchange`,
`halo_exchange_hops`) take every shard's, as a tuple in the mesh's order
(shard/collective.py), and return tuples. Walls are f32 tensors, compared
with the f32 positions as the JAX package compares them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.shard.collective import Mesh, ppermute

# fields exchanged between shards (everything the narrow phase needs)
XCHG_FIELDS = ("pos", "vel", "acc", "heading", "size", "otype", "oid")


def axis_shards(cfg: SystemConfig, dim: int) -> Tuple[int, str]:
    """(shard count, mesh axis name) of world axis `dim` (0 = x slabs,
    1 = y slabs of the 2D tiling, 2 = z slabs of the 3D tiling)."""
    if dim == 0:
        return cfg.shard.num_shards, cfg.shard.axis_name
    if dim == 1:
        return cfg.shard.num_shards_y, cfg.shard.axis_name_y
    if dim != 2:
        raise ValueError(f"world axis {dim} is not 0, 1 or 2")
    return cfg.shard.num_shards_z, cfg.shard.axis_name_z


def slab_bounds(cfg: SystemConfig, shard_idx: int,
                boundaries: torch.Tensor | None = None, dim: int = 0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) of the slab of shard coordinate `shard_idx` along world
    axis `dim`, as 0-dim f32 tensors. boundaries: the [D+1] f32 walls, or
    None for equal slabs computed in f32 as the JAX package computes them
    (on `device`, the CPU when not named)."""
    if boundaries is not None:
        return boundaries[shard_idx], boundaries[shard_idx + 1]
    d, _ = axis_shards(cfg, dim)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    width = f32((cfg.world.hi[dim] - cfg.world.lo[dim]) / d)
    slab_lo = f32(cfg.world.lo[dim]) + width * f32(float(shard_idx))
    return slab_lo, slab_lo + width


def pack(state: ObjectState, mask: torch.Tensor, capacity: int,
         boundary: torch.Tensor, extra=None, dim: int = 0):
    """Compact up to `capacity` masked objects into a send buffer of
    min(N, capacity) rows. When more match, those nearest the wall (along
    world axis `dim`) win, ties by the lower slot (a stable sort, as
    jnp.argsort). Returns (buffer dict, valid [cap] bool, dropped [] int32).
    `extra` (dict name -> [N, ...] tensor) rides along under 'x:' keys."""
    d = torch.abs(state.pos[:, dim] - boundary)
    key = torch.where(mask, d, torch.full_like(d, float("inf")))
    idx = torch.sort(key, stable=True).indices[:capacity]
    valid = mask[idx]
    buf = {f: getattr(state, f)[idx] for f in XCHG_FIELDS}
    for f, a in (extra or {}).items():
        buf["x:" + f] = a[idx]
    dropped = mask.sum(dtype=torch.int32) - valid.sum(dtype=torch.int32)
    return buf, valid, dropped


def exchange_neighbors(mesh: Mesh, cfg: SystemConfig, bufs_l, valids_l,
                       bufs_r, valids_r, dim: int = 0):
    """Every shard sends (bufs_l[s], valids_l[s]) to its lower neighbour
    and (bufs_r[s], valids_r[s]) to its upper one along world axis `dim`.
    Returns (from_upper, from_lower), each a tuple of (buffer, valid) per
    shard; edge shards receive zeros (valid False)."""
    d, ax = axis_shards(cfg, dim)
    to_lower = [(i, i - 1) for i in range(1, d)]
    to_upper = [(i, i + 1) for i in range(d - 1)]
    from_upper = ppermute(mesh, tuple(zip(bufs_l, valids_l)), ax, to_lower)
    from_lower = ppermute(mesh, tuple(zip(bufs_r, valids_r)), ax, to_upper)
    return from_upper, from_lower


def kill(state: ObjectState, mask: torch.Tensor) -> ObjectState:
    return state.replace(alive=state.alive & ~mask)


def place(state: ObjectState, buf, valid: torch.Tensor, extra=None):
    """Scatter arriving objects into dead slots, the lowest free slots
    first. Returns (state, dropped [] int32: arrivals that found no free
    slot), or (state, extra, dropped) when `extra` is given (its 'x:'
    fields of `buf` land in the same slots)."""
    cap = valid.shape[0]
    # free slots first: a stable sort of alive as integers (False < True)
    slots = torch.sort(state.alive.to(torch.int8), stable=True).indices[:cap]
    can = ~state.alive[slots] & valid

    def scatter(arr, new):
        mask = can.reshape((cap,) + (1,) * (new.dim() - 1))
        out = arr.clone()
        out[slots] = torch.where(mask, new, arr[slots])
        return out

    upd = {f: scatter(getattr(state, f), buf[f]) for f in XCHG_FIELDS}
    alive = state.alive.clone()
    alive[slots] = state.alive[slots] | can
    dropped = valid.sum(dtype=torch.int32) - can.sum(dtype=torch.int32)
    new_state = state.replace(alive=alive, **upd)
    if extra is None:
        return new_state, dropped
    new_extra = {f: scatter(a, buf["x:" + f]) for f, a in extra.items()}
    return new_state, new_extra, dropped


def _walls(boundaries, dev):
    return None if boundaries is None else boundaries.to(dev)


def _bands(states, cfg: SystemConfig, mesh: Mesh, boundaries, dim: int,
           lower, upper):
    """Per shard: its slab [lo, hi) and the masks lower(c, lo) and
    upper(c, hi) of its alive objects (empty on the edge shards that have
    no neighbour there)."""
    d, ax = axis_shards(cfg, dim)
    out = []
    for s, st in enumerate(states):
        i = mesh.axis_index(s, ax)
        dev = mesh.devices[s]
        lo, hi = slab_bounds(cfg, i, _walls(boundaries, dev), dim, dev)
        c = st.pos[:, dim]
        none = torch.zeros_like(st.alive)
        go_l = st.alive & lower(c, lo) if i > 0 else none
        go_r = st.alive & upper(c, hi) if i < d - 1 else none
        out.append((lo, hi, go_l, go_r))
    return out


def migrate(states, cfg: SystemConfig, mesh: Mesh,
            boundaries: torch.Tensor | None = None, extras=None,
            dim: int = 0):
    """Move objects whose `dim` coordinate left their slab to the neighbour
    shard along that axis (at most one slab per step; make_mesh and
    check_boundaries hold the walls to that). Emigrants leave whether or
    not they find room; a lost one is counted. Arrivals from below are
    placed before arrivals from above.

    Returns (states, dropped), or (states, extras, dropped) when `extras`
    (one dict of per-object tensors per shard) migrate along; dropped is a
    [] int32 tensor per shard."""
    m = cfg.shard.migrate_capacity
    bands = _bands(states, cfg, mesh, boundaries, dim,
                   lambda c, lo: c < lo, lambda c, hi: c >= hi)
    ex = extras or (None,) * len(states)
    packs_l, packs_r, left = [], [], []
    for st, x, (lo, hi, go_l, go_r) in zip(states, ex, bands):
        packs_l.append(pack(st, go_l, m, lo, extra=x, dim=dim))
        packs_r.append(pack(st, go_r, m, hi, extra=x, dim=dim))
        left.append(kill(st, go_l | go_r))
    from_upper, from_lower = exchange_neighbors(
        mesh, cfg, [p[0] for p in packs_l], [p[1] for p in packs_l],
        [p[0] for p in packs_r], [p[1] for p in packs_r], dim)
    out, out_x, dropped = [], [], []
    for s, st in enumerate(left):
        drop = packs_l[s][2] + packs_r[s][2]
        x = ex[s]
        for buf, valid in (from_lower[s], from_upper[s]):
            if x is None:
                st, dp = place(st, buf, valid)
            else:
                st, x, dp = place(st, buf, valid, extra=x)
            drop = drop + dp
        out.append(st)
        out_x.append(x)
        dropped.append(drop)
    if extras is None:
        return tuple(out), tuple(dropped)
    return tuple(out), tuple(out_x), tuple(dropped)


def _concat_halo(pieces):
    """(buffer, valid) of a list of (buffer, valid) pieces, concatenated
    in order."""
    buf = {f: torch.cat([b[f] for b, _ in pieces]) for f in pieces[0][0]}
    return buf, torch.cat([v for _, v in pieces])


def halo_exchange(states, cfg: SystemConfig, mesh: Mesh,
                  boundaries: torch.Tensor | None = None, dim: int = 0,
                  width: float | None = None, capacity: int | None = None):
    """Mirror each shard's boundary bands to its neighbours along world
    axis `dim`. Returns per shard (halo buffer, halo valid, dropped): the
    2 * capacity foreign rows visible to the shard this step, those from
    below first. For the 2D tiling's y phase pass the x-extended states
    (owned + x halo): mirroring the x halo again covers the corners.
    width / capacity override ShardConfig.halo_width / halo_capacity."""
    return halo_exchange_hops(states, cfg, mesh, boundaries, dim, width,
                              capacity, hops=1)


def halo_exchange_hops(states, cfg: SystemConfig, mesh: Mesh,
                       boundaries: torch.Tensor | None = None, dim: int = 0,
                       width: float | None = None,
                       capacity: int | None = None, hops: int = 1):
    """Multi-hop halo: bands of width `width` that reach up to `hops` slab
    neighbours per side. Hop 1 packs each shard's own bands as
    halo_exchange does; hop h > 1 forwards what arrived from h - 1 slabs
    away, filtered again by this shard's own reach (`c < lo + w` downward,
    `c >= hi - w` upward), so the chain delivers exactly the objects within
    `width` of the slab, across any walls, when each slab is at least
    width / hops wide. Drops happen only at the first pack.

    Returns per shard (halo buffer, halo valid [2 * hops * capacity at
    most], dropped [] int32)."""
    h = cfg.shard.halo_capacity if capacity is None else capacity
    w = cfg.shard.halo_width if width is None else width
    bands = _bands(states, cfg, mesh, boundaries, dim,
                   lambda c, lo: c < lo + w, lambda c, hi: c >= hi - w)
    sends_l, sends_r, dropped = [], [], []
    for st, (lo, hi, near_l, near_r) in zip(states, bands):
        buf_l, val_l, drop_l = pack(st, near_l, h, lo, dim=dim)
        buf_r, val_r, drop_r = pack(st, near_r, h, hi, dim=dim)
        sends_l.append((buf_l, val_l))
        sends_r.append((buf_r, val_r))
        dropped.append(drop_l + drop_r)
    pieces = [[] for _ in states]
    for hop in range(hops):
        from_upper, from_lower = exchange_neighbors(
            mesh, cfg, [b for b, _ in sends_l], [v for _, v in sends_l],
            [b for b, _ in sends_r], [v for _, v in sends_r], dim)
        for s in range(len(states)):
            pieces[s] += [from_lower[s], from_upper[s]]
        if hop + 1 < hops:
            # the downward flow keeps flowing down, the upward one up
            sends_l, sends_r = [], []
            for s, (lo, hi, _, _) in enumerate(bands):
                (b_up, v_up), (b_lo, v_lo) = from_upper[s], from_lower[s]
                sends_l.append((b_up, v_up & (b_up["pos"][:, dim] < lo + w)))
                sends_r.append((b_lo,
                                v_lo & (b_lo["pos"][:, dim] >= hi - w)))
    return tuple(_concat_halo(p) + (d,) for p, d in zip(pieces, dropped))


def mark_oids(oid: torch.Tensor) -> torch.Tensor:
    """Mirror oids marked -(oid + 2): distinct from every real id and from
    -1 (no object) without burning an id range. kernels/cell_list.decode_oid
    undoes it; a mark already made stays."""
    return torch.where(oid >= 0, -(oid + 2), oid)


def extend_with_halo(state: ObjectState, halo_buf, halo_valid: torch.Tensor,
                     mark_halo: bool = False) -> ObjectState:
    """The owned slots followed by the halo rows, one state ready for
    detection. Halo rows are alive (they are candidates) but must emit no
    alert: the reference-shaped tail masks them by row (query_mask); for
    the fused tail, which sorts rows, pass mark_halo=True so that their
    oids carry the mark of `mark_oids` (the refine tail reads it, cl.own)."""
    ext = {f: torch.cat([getattr(state, f), halo_buf[f]])
           for f in XCHG_FIELDS}
    if mark_halo:
        ext["oid"] = torch.cat([state.oid, mark_oids(halo_buf["oid"])])
    return ObjectState(alive=torch.cat([state.alive, halo_valid]), **ext)
