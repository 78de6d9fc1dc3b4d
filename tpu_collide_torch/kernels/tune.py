"""Config tuning from fleet statistics (the port of
tpu_collide/kernels/tune.py).

The capacities stay static; these helpers size them right for a given fleet
before the first step:

  * `suggest_cell_capacity`: the grid path's bucket capacity from the
    densest live cell, so that the reference-shaped step drops nothing;
  * `measure_survivor_need` / `suggest_survivor_cap`: the precise fused
    path's survivor compaction from the kernel's survivor counts;
  * `suggest_cell_size` / `tune_config`: the legal cell size for the fused
    path and the stage-1 gate policy.

The JAX package's `suggest_window_rows` sizes the TPU kernel's candidate
windows; the port's cell list has no windows, so it has no counterpart
here and `tune_config` returns None in its place.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.index.grid import cell_coords, flatten_cells
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tpu_collide_torch.sim.integrator import integrate

# the survivor cap's rounding slack, one 128-lane row of the JAX package's
# layout, kept so that the suggested caps equal the JAX package's
LANE = 128


def suggest_cell_capacity(state, cfg: SystemConfig, margin: int = 2) -> int:
    """Exact bucket capacity of the grid path for THIS fleet: the largest
    live-cell occupancy plus `margin`, rounded up to a multiple of 4 (at
    least 4). At that capacity index/grid.gather_candidates drops nothing
    for these positions (engine.grid_overflow is 0)."""
    flat = flatten_cells(cell_coords(state.pos, cfg), cfg)[state.alive]
    occ = torch.bincount(flat.to(torch.int64), minlength=1)
    need = int(occ.max()) + margin
    return max(4, -(-need // 4) * 4)


def measure_survivor_need(cfg: SystemConfig, state,
                          generator: torch.Generator | None = None,
                          steps: int = 0) -> int:
    """The precise fused path's survivor need: sum over live sorted rows of
    min(emitted, survivor_k) from the kernel in survivor mode (no sweep, no
    refine), which is how many records fused_scene_precise's compaction
    must hold. With steps = 0 it measures the given positions; with
    steps > 0 it integrates the state `steps` times, drawing from
    `generator`, and returns the largest need over those steps (the JAX
    package's key sequence, one key per step)."""
    k = cfg.detect.survivor_k

    def need(st) -> torch.Tensor:
        cl = build_cell_list(st, cfg)
        emitted = fused_topk(cl, cfg, mode="survivors").emitted
        return torch.where(cl.alive, torch.clamp_max(emitted, k),
                           torch.zeros_like(emitted)).sum(dtype=torch.int32)

    if steps == 0:
        return int(need(state))
    needs = []
    for _ in range(steps):
        state = integrate(state, cfg, generator)
        needs.append(need(state))
    return int(torch.stack(needs).max())


def suggest_survivor_cap(cfg: SystemConfig, state,
                         generator: torch.Generator | None = None,
                         steps: int = 0) -> int:
    """Fleet-exact DetectionConfig.precise_survivor_cap: the measured need
    plus 1/8 headroom, rounded up to a power of two (at least 1024). A
    later density drift past it is counted in alert_overflow."""
    need = measure_survivor_need(cfg, state, generator, steps)
    cap = max(1024, need + need // 8 + LANE)
    return 1 << (cap - 1).bit_length()


def suggest_cell_size(cfg: SystemConfig) -> float:
    """Smallest legal cell of the fused path: the search radius (its 1-cell
    stencil must cover it)."""
    return max(cfg.grid.cell_size, cfg.detect.search_radius)


def tune_config(cfg: SystemConfig, state=None) -> tuple:
    """(cfg', None): the cell size clamped legal and the stage-1 gate on
    for 3D worlds, off for 2D (the JAX package's policy; the port accepts
    the gate and ignores it, as it only ever skipped work). The second
    element stands where the JAX package returns its window capacity; the
    port has no windows, so `state` is not read."""
    cs = suggest_cell_size(cfg)
    if cs != cfg.grid.cell_size:
        cfg = cfg.replace(grid=dataclasses.replace(cfg.grid, cell_size=cs))
    want_g1 = cfg.world.is_3d
    if cfg.detect.gate_stage1 != want_g1:
        cfg = cfg.replace(detect=dataclasses.replace(
            cfg.detect, gate_stage1=want_g1))
    return cfg, None
