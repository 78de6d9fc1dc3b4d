"""Trajectory prediction on the mesh (the port of
tpu_collide/shard/predict.py).

Each shard predicts for the objects it owns against a halo band WIDENED by
the fleet's largest predicted displacement: a query's class-predicted
position can wander up to max_speed * o_max + 0.5 * accel_range * o_max^2
from its slab, and stage 1 compares that position with the candidates'
CURRENT positions, so a band of halo_width plus that bound makes the
per-shard prediction equal to the single-device one for owned objects.
Bands wider than a slab ride a multi-hop chain (halo.halo_exchange_hops).

Histories ride with ownership: only query objects need a trajectory class
(candidates advance under constant acceleration), so halo mirrors get empty
histories (xla) or class 0 (fused) and nothing but the state band crosses
between shards.

Sharded values are tuples of per-shard tensors in the mesh's order, as in
shard/step.py; per-shard counters are [D] int32 tensors on the first
shard's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.detect.predict import (TrajectoryHistory,
                                              classify_trajectories,
                                              predict_collisions)
from tpu_collide_torch.engine import grid_overflow
from tpu_collide_torch.index.grid import build_grid
from tpu_collide_torch.kernels.refine import fused_predict_rows
from tpu_collide_torch.shard.collective import Mesh
from tpu_collide_torch.shard.step import (_check_sharded, _default_walls,
                                          _dropped, _halo_extend, _shard_of,
                                          _walls, shard_slots)


def predict_reach(cfg: SystemConfig, horizon: float, step: float) -> float:
    """Halo band width covering prediction: the detection halo plus the
    config's bound on class-predicted displacement at the last offset."""
    o_max = max(0.0, horizon - step)
    disp = cfg.sim.max_speed * o_max + 0.5 * cfg.sim.accel_range * o_max ** 2
    return cfg.shard.halo_width + disp


def predict_hops(cfg: SystemConfig, reach: float, dim: int) -> int:
    """Hops per side of the halo chain that a `reach`-wide band needs on
    world axis `dim`, from the equal-slab width (at most d - 1: then the
    chain spans the axis). Callers that move walls must keep every slab at
    least reach / hops wide."""
    d = (cfg.shard.num_shards, cfg.shard.num_shards_y,
         cfg.shard.num_shards_z)[dim]
    if d <= 1:
        return 1
    slab = (cfg.world.hi[dim] - cfg.world.lo[dim]) / d
    return min(d - 1, max(1, math.ceil(reach / slab)))


def predict_band(cfg: SystemConfig, horizon: float, step: float,
                 hops: int | None = None,
                 halo_capacity: int | None = None) -> tuple:
    """The halo band make_sharded_predict builds: (reach, hops per x, y and
    z axis, halo capacity). `hops` (one count for every axis) and
    `halo_capacity` override the defaults: predict_hops per axis, and the
    config's halo_capacity scaled by the band's width over halo_width,
    shared among the hops."""
    reach = predict_reach(cfg, horizon, step)
    if hops is None:
        hops = tuple(predict_hops(cfg, reach, dim) for dim in range(3))
    else:
        hops = (hops,) * 3
    if halo_capacity is None:
        scale = -(-int(reach) // max(1, int(cfg.shard.halo_width)))
        # each hop's buffer carries at most one slab's share of the band
        halo_capacity = cfg.shard.halo_capacity * max(
            1, -(-scale // max(1, max(hops))))
    return reach, hops, halo_capacity


def _pad_history(hist: TrajectoryHistory, n_halo: int) -> TrajectoryHistory:
    """The history followed by n_halo empty rings (halo mirrors)."""
    pad = lambda a, fill: torch.cat([a, torch.full(
        (n_halo,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
        device=a.device)])
    return TrajectoryHistory(pos=pad(hist.pos, 0.0),
                             t=pad(hist.t, float("-inf")),
                             count=pad(hist.count, 0),
                             head=pad(hist.head, 0))


def _local_predict(st, hist, ex, cfg, horizon, step, sub_window, merge_k):
    """One shard's reference-shaped prediction over its owned rows and its
    halo rows: (other oid [slots, merge_k], valid, risk, ttc, dist,
    grid overflow [])."""
    index = build_grid(ex.pos, ex.alive, cfg)
    other_i, valid, risk, ttc, dist = predict_collisions(
        ex, _pad_history(hist, ex.n - st.n), index, cfg, horizon=horizon,
        step=step, sub_window=sub_window, merge_k=merge_k)
    n = st.n
    valid = valid[:n]
    other = ex.oid[other_i[:n].to(torch.int64).clamp(0, ex.n - 1)]
    return (torch.where(valid, other, torch.full_like(other, -1)), valid,
            risk[:n], ttc[:n], dist[:n],
            grid_overflow(index, cfg).to(torch.int32))


def _local_predict_fused(st, hist, ex, cfg, horizon, step, sub_window,
                         merge_k):
    """One shard's prediction through the predict kernel
    (kernels/refine.fused_predict_rows, one launch): halo mirrors enter
    with marked oids and class 0 and are masked as query rows (cl.own).
    Row-space outputs: (other oid [m, merge_k], valid, risk, ttc, dist,
    row oid [m] (-1: mirror or dead row), overflow + slot_oflow [])."""
    cls = torch.cat([classify_trajectories(hist),
                     torch.zeros(ex.n - st.n, dtype=torch.int32,
                                 device=ex.device)])
    (other, valid, risk, ttc, dist, soid, own, overflow, slot_oflow,
     _) = fused_predict_rows(ex, cls, cfg, horizon=horizon, step=step,
                             sub_window=sub_window, merge_k=merge_k)
    valid = valid & own[:, None]
    return (torch.where(valid, other, torch.full_like(other, -1)), valid,
            risk, ttc, dist, torch.where(own, soid, torch.full_like(soid, -1)),
            (overflow + slot_oflow).to(torch.int32))


def make_sharded_predict(cfg: SystemConfig, mesh: Mesh,
                         horizon: float = 10.0, step: float = 0.5,
                         sub_window: float = 1.0, merge_k: int = 32,
                         halo_capacity: int | None = None,
                         backend: str = "xla",
                         window_rows: int | None = None,
                         interpret: bool = False,
                         hops: int | None = None):
    """Per-shard trajectory prediction over `mesh`. Returns
    predict(states, hists, boundaries=None, boundaries_y=None,
    boundaries_z=None) with `hists` one TrajectoryHistory per shard
    (distribute_history, or the with_history step's).

    backend='xla': the grid path per shard; returns (other_oid, valid,
    risk, ttc, dist), each a tuple of per-shard [slots, merge_k] tensors
    aligned with the shards' slots, then dropped [D] and grid_overflow [D]:
    the merged predicted risks of every OWNED object, equal to the
    single-device predict_collisions when each band fits `halo_capacity`
    (halo drops counted in `dropped`, bucket truncation in grid_overflow).

    backend='fused': the predict kernel per shard, one launch each; the
    outputs are in each shard's SORTED-ROW space: (other_oid [m, merge_k],
    valid, risk, ttc, dist, row_oid [m]) per shard, then dropped [D] and
    overflow [D] (overflow + uncertified slot truncations; k_slots 8 as
    the JAX package's). Join on row_oid (-1: halo mirror or dead row). The
    same pair set and values as 'xla', complete when both counters are 0.

    Bands wider than a slab take hops = ceil(reach / slab width) per axis
    from the equal-slab width; callers that move walls keep every slab at
    least predict_reach / hops wide, or pass `hops` for narrower slabs.
    `window_rows` and `interpret` are accepted and ignored."""
    del window_rows, interpret
    if backend not in ("xla", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    reach, hops, halo_capacity = predict_band(cfg, horizon, step, hops,
                                              halo_capacity)
    local = _local_predict_fused if backend == "fused" else _local_predict
    mark = backend == "fused"
    defaults = _default_walls(cfg, mesh)

    def predict(states, hists, boundaries=None, boundaries_y=None,
                boundaries_z=None):
        _check_sharded(states, mesh, "sharded predict")
        _check_sharded(hists, mesh, "sharded predict")
        walls = _walls(mesh, defaults, boundaries, boundaries_y,
                       boundaries_z)
        ext, dropped = _halo_extend(states, cfg, mesh, walls, mark,
                                    width=reach, capacity=halo_capacity,
                                    hops=hops)
        parts = [local(st, h, ex, cfg, horizon, step, sub_window, merge_k)
                 for st, h, ex in zip(states, hists, ext)]
        cols = tuple(tuple(p[j] for p in parts)
                     for j in range(len(parts[0]) - 1))
        return cols + (_dropped(mesh, dropped),
                       _dropped(mesh, [p[-1] for p in parts]))

    return predict


def distribute_history(hist_global: TrajectoryHistory, cfg: SystemConfig,
                       mesh: Mesh, state_global, boundaries=None,
                       boundaries_y=None, boundaries_z=None) -> tuple:
    """Scatter a global fleet's trajectory history into the slots that
    distribute_state gives its objects (bootstrap and restore). Returns one
    TrajectoryHistory per shard on the mesh's devices. Host-side numpy."""
    host = lambda v: torch.as_tensor(v).cpu().numpy()
    slots = shard_slots(cfg)
    pos, alive = host(state_global.pos), host(state_global.alive)
    shard_of = _shard_of(pos, cfg, boundaries, boundaries_y, boundaries_z)
    fields = {f: host(getattr(hist_global, f))
              for f in ("pos", "t", "count", "head")}
    empty = {"pos": 0.0, "t": -np.inf, "count": 0, "head": 0}
    out = []
    for sh, dev in enumerate(mesh.devices):
        idx = np.flatnonzero((shard_of == sh) & alive)
        shard = {}
        for f, v in fields.items():
            buf = np.full((slots,) + v.shape[1:], empty[f], v.dtype)
            buf[:len(idx)] = v[idx]
            shard[f] = torch.from_numpy(buf).to(dev)
        out.append(TrajectoryHistory(**shard))
    return tuple(out)
