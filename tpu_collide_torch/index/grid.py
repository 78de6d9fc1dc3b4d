"""Sort-based uniform spatial grid (the port of tpu_collide/index/grid.py).

    cell_id = floor((pos - lo) / cell_size)   (clipped to the grid)
    order   = argsort(flat_cell_id)           (stable; dead objects sort last)
    starts  = exclusive cumsum of the bucket sizes

The bucket of cell c is `order[starts[c] : starts[c+1]]`. The broad phase
gathers at most `cell_capacity` objects from each bucket of a query cell's
stencil; what a bucket holds beyond that is dropped from the gather and
counted by `engine.grid_overflow`. This is the reference-shaped path that
`detect.predict.predict_collisions` runs on; the fused kernels use the
cell list (kernels/cell_list.py), which has no capacity.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """cell3:     [N, 3] int32 per-object cell coordinates
    flat_cell: [N] int32 flattened cell id (dead objects get C, a sentinel)
    order:     [N] int32 object indices sorted by flat_cell
    starts:    [C + 2] int32 bucket start offsets into `order`
    dims:      (nx, ny, nz) grid dims
    """
    cell3: torch.Tensor
    flat_cell: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    dims: Tuple[int, int, int]


def cell_coords(pos: torch.Tensor, cfg: SystemConfig) -> torch.Tensor:
    """[*, 3] positions -> [*, 3] int32 cell coords, clipped into the grid.
    The division is by a 0-dim tensor, so it stays an IEEE division on
    every device (PyTorch turns a division by a Python float into a
    reciprocal multiply on CUDA). Its constants are host waits on a card
    (core/device.host_tensor)."""
    dev = pos.device
    lo = host_tensor(cfg.world.lo, torch.float32, dev)
    cs = host_tensor(cfg.grid.cell_size, torch.float32, dev)
    hi = host_tensor([d - 1 for d in cfg.grid_dims], torch.float32, dev)
    c = torch.floor((pos - lo) / cs)
    return torch.minimum(torch.clamp_min(c, 0.0), hi).to(torch.int32)


def flatten_cells(cell3: torch.Tensor, cfg: SystemConfig) -> torch.Tensor:
    nx, ny, _ = cfg.grid_dims
    return cell3[..., 0] + nx * (cell3[..., 1] + ny * cell3[..., 2])


def bucket_starts(flat: torch.Tensor, num_cells: int) -> torch.Tensor:
    """[C+2] bucket start offsets: starts[c] = #elements with cell < c."""
    counts = torch.bincount(flat.to(torch.int64), minlength=num_cells + 2)
    starts = torch.zeros((num_cells + 2,), dtype=torch.int32,
                         device=flat.device)
    starts[1:] = torch.cumsum(counts[:num_cells + 1], 0).to(torch.int32)
    return starts


def build_grid(pos: torch.Tensor, alive: torch.Tensor,
               cfg: SystemConfig) -> GridIndex:
    """One stable sort by flat cell id plus a bucket histogram."""
    num_cells = cfg.num_cells
    c3 = cell_coords(pos, cfg)
    flat = flatten_cells(c3, cfg)
    # dead objects get the sentinel cell C, past every real bucket
    flat = torch.where(alive, flat, torch.full_like(flat, num_cells))
    order = torch.sort(flat, stable=True).indices.to(torch.int32)
    return GridIndex(cell3=c3, flat_cell=flat, order=order,
                     starts=bucket_starts(flat, num_cells),
                     dims=cfg.grid_dims)


def _stencil_offsets(cfg: SystemConfig, device) -> torch.Tensor:
    """[S, 3] int32 neighbour-cell offsets covering search_radius, in
    (dz, dy, dx) loop order."""
    w = cfg.stencil_halfwidth
    rng = range(-w, w + 1)
    zrng = rng if cfg.world.is_3d else (0,)
    offs = [(dx, dy, dz) for dz in zrng for dy in rng for dx in rng]
    return torch.tensor(offs, dtype=torch.int32, device=device)


def gather_candidates(index: GridIndex, query_cell3: torch.Tensor,
                      cfg: SystemConfig):
    """Broad-phase candidate gather: for each query cell ([Q, 3]) the S
    cells of its stencil, up to `cell_capacity` objects from each bucket.

    Returns (cand_idx [Q, S*cap] int32, cand_valid [Q, S*cap] bool).
    Invalid slots point at object 0 with valid=False; callers must mask."""
    nx, ny, nz = index.dims
    dev = query_cell3.device
    nd = torch.tensor((nx, ny, nz), dtype=torch.int32, device=dev)
    num_cells = nx * ny * nz
    cap = cfg.grid.cell_capacity
    offs = _stencil_offsets(cfg, dev)                        # [S, 3]

    nb = query_cell3[:, None, :] + offs[None, :, :]          # [Q, S, 3]
    in_bounds = ((nb >= 0) & (nb < nd)).all(dim=-1)          # [Q, S]
    nbc = torch.minimum(torch.clamp_min(nb, 0), nd - 1).to(torch.int64)
    nb_flat = nbc[..., 0] + nx * (nbc[..., 1] + ny * nbc[..., 2])
    nb_flat = torch.where(in_bounds, nb_flat,
                          torch.full_like(nb_flat, num_cells))
    b0 = index.starts[nb_flat].to(torch.int64)              # [Q, S]
    b1 = index.starts[nb_flat + 1].to(torch.int64)
    slots = b0[..., None] + torch.arange(cap, device=dev)    # [Q, S, cap]
    valid = slots < b1[..., None]
    n = index.order.shape[0]
    cand = index.order[torch.clamp(slots, 0, n - 1)]
    q = query_cell3.shape[0]
    return cand.reshape(q, -1), valid.reshape(q, -1)


def query_radius(index: GridIndex, pos_all: torch.Tensor,
                 alive: torch.Tensor, query_pos: torch.Tensor, radius: float,
                 cfg: SystemConfig):
    """Exact radius query: candidates from the stencil, then the exact
    distance filter. `radius` must be within the stencil's coverage
    (stencil_halfwidth * cell_size)."""
    if radius > cfg.stencil_halfwidth * cfg.grid.cell_size + 1e-6:
        raise ValueError(
            "query radius exceeds the stencil's coverage; widen "
            "DetectionConfig.search_radius or shrink the query")
    cand, valid = gather_candidates(index, cell_coords(query_pos, cfg), cfg)
    c = cand.to(torch.int64)
    d = torch.sqrt(torch.sum(torch.square(pos_all[c] - query_pos[:, None, :]),
                             dim=-1))
    return cand, valid & alive[c] & (d <= radius)
