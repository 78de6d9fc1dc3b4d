"""Cell list: the fleet sorted by grid cell, feeding the fused kernel.

The port of tpu_collide/kernels/cell_list.py. It keeps the semantics of
`build_cell_list` and leaves the TPU layout behind (128-lane storage rows,
tiles, per-tile windows, guard tables):

  * objects sort by flat cell id (cz*ny + cy)*nx + cx, the cell computed in
    f32 as floor((pos - lo) / cell_size) clipped to the grid; dead objects
    carry the key num_cells and sort last;
  * `cell_start[c]` is the sorted index where cell c begins
    (`cell_start[num_cells]` is the number of alive objects);
  * an object's candidates are the objects of the 1-cell stencil around its
    cell. With cells sorted by (z, y, x), that stencil is 3 contiguous runs
    of the sorted order in 2D and 9 in 3D: for each (dz, dy), the cells
    cx-1 .. cx+1.

Every object walks exactly its own runs, so the broad phase has no window
capacity and `overflow` is 0 by construction. `band_cells` and `cand_lanes`
are accepted and ignored. In the unbanded layout of the JAX package, its
`cr_start[b]` equals `cell_start[b * nx]` here.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import span, traced
from tpu_collide_torch.index.grid import cell_coords, flatten_cells

# Sorted per-object record: 16 f32 = 64 bytes, four 16-byte loads in the
# kernel. sin_h / cos_h are computed once per object here, so the kernel
# and its plain version read the same values for the 'product' angle form.
# cls is the trajectory class of the predict mode (0 in the detection
# modes).
FIELD_NAMES = ("x", "y", "z", "vx", "vy", "vz", "ax", "ay", "az",
               "size", "heading", "otype", "sin_h", "cos_h", "cls", "pad1")
NF = len(FIELD_NAMES)
FI = {name: i for i, name in enumerate(FIELD_NAMES)}


@dataclasses.dataclass(frozen=True)
class CellList:
    """The fleet sorted by cell.

    fields:     [N, NF] f32 in FIELD_NAMES order, one row per sorted object
    oid:        [N] int32 object id of each sorted object, as the state
                holds it: a halo mirror's is marked -(oid + 2)
                (shard/halo.extend_with_halo); `oid_decoded` undoes the mark
    cell:       [N] int32 flat cell id of each sorted object (num_cells for
                dead objects, which sort last)
    cell_start: [num_cells + 1] int32 sorted index where each cell begins
    order:      [N] int64 state index of each sorted object
    n_alive:    [] int32
    overflow:   [] int32 broad-phase candidates beyond capacity: always 0
    """
    fields: torch.Tensor
    oid: torch.Tensor
    cell: torch.Tensor
    cell_start: torch.Tensor
    order: torch.Tensor
    n_alive: torch.Tensor
    overflow: torch.Tensor
    grid_dims: tuple
    is3d: bool

    @property
    def n(self) -> int:
        return self.fields.shape[0]

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz

    @property
    def alive(self) -> torch.Tensor:
        """[N] bool per sorted object."""
        return self.cell < self.num_cells

    @property
    def own(self) -> torch.Tensor:
        """[N] bool: alive rows that are not halo mirrors, the rows that
        emit alerts and count risks. Without a halo it equals `alive`."""
        return self.alive & (self.oid >= 0)

    @property
    def oid_decoded(self) -> torch.Tensor:
        """[N] int32 object id of each sorted object, halo marks undone."""
        return decode_oid(self.oid)


def decode_oid(oid: torch.Tensor) -> torch.Tensor:
    """The object id behind a halo mark: -(oid + 2) -> oid. Other ids,
    -1 (no object) included, stay as they are."""
    return torch.where(oid <= -2, -oid - 2, oid)


@traced("tc.cell_list")
def build_cell_list(state: ObjectState, cfg: SystemConfig,
                    cls: torch.Tensor | None = None) -> CellList:
    """`cls` ([N] trajectory class in state order) rides in the record's
    cls field for the predict mode; it is 0 when not given."""
    if cfg.stencil_halfwidth != 1:
        raise ValueError(
            "the fused path requires cell_size >= search_radius "
            f"(stencil halfwidth 1, got {cfg.stencil_halfwidth})")
    nx, ny, nz = cfg.grid_dims
    num_cells = nx * ny * nz
    dev = state.device
    lo = host_tensor(cfg.world.lo, torch.float32, dev)
    # a 0-dim device tensor keeps the division an IEEE division on every
    # device (torch turns division by a Python scalar into a reciprocal
    # multiply on CUDA)
    cs = host_tensor(cfg.grid.cell_size, torch.float32, dev)
    hi = host_tensor((nx - 1, ny - 1, nz - 1), torch.int32, dev)
    c3 = torch.clamp(torch.floor((state.pos - lo) / cs).to(torch.int32),
                     min=torch.zeros_like(hi), max=hi)
    flat = (c3[:, 2] * ny + c3[:, 1]) * nx + c3[:, 0]
    flat = torch.where(state.alive, flat, torch.full_like(flat, num_cells))
    key, order = torch.sort(flat, stable=True)
    heading = state.heading[order]
    cls_col = (torch.zeros((state.n, 1), dtype=torch.float32, device=dev)
               if cls is None else cls[order, None].to(torch.float32))
    fields = torch.cat([
        state.pos[order], state.vel[order], state.acc[order],
        state.size[order, None], heading[:, None],
        state.otype[order, None].to(torch.float32),
        torch.sin(heading)[:, None], torch.cos(heading)[:, None],
        cls_col, torch.zeros((state.n, 1), dtype=torch.float32, device=dev),
    ], dim=1).contiguous()
    cell_start = torch.searchsorted(
        key, torch.arange(num_cells + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return CellList(
        fields=fields, oid=state.oid[order].contiguous(),
        cell=key.contiguous(), cell_start=cell_start, order=order,
        n_alive=cell_start[num_cells],
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        grid_dims=(nx, ny, nz), is3d=cfg.world.is_3d)


def stencil_runs(cl: CellList, rows: torch.Tensor,
                 cells: torch.Tensor | None = None):
    """(start, end) [R, S] int64: the S candidate runs (3 in 2D, 9 in 3D)
    around each row's cell, in ascending sorted order; empty for dead rows
    and for (dz, dy) outside the grid. `cells` ([R] flat cell ids,
    num_cells for none) walks the runs around other cells than the rows'
    own, such as their predicted cells."""
    nx, ny, nz = cl.grid_dims
    c = (cl.cell[rows] if cells is None else cells).to(torch.int64)
    alive = c < cl.num_cells
    c = torch.where(alive, c, torch.zeros_like(c))
    cx, cy, cz = c % nx, (c // nx) % ny, c // (nx * ny)
    x0 = torch.clamp_min(cx - 1, 0)
    x1 = torch.clamp_max(cx + 1, nx - 1)
    starts, ends = [], []
    for dz in ((-1, 0, 1) if cl.is3d else (0,)):
        for dy in (-1, 0, 1):
            z, y = cz + dz, cy + dy
            ok = alive & (z >= 0) & (z < nz) & (y >= 0) & (y < ny)
            base = (torch.clamp(z, 0, nz - 1) * ny
                    + torch.clamp(y, 0, ny - 1)) * nx
            s = cl.cell_start[base + x0].to(torch.int64)
            e = cl.cell_start[base + x1 + 1].to(torch.int64)
            starts.append(torch.where(ok, s, 0))
            ends.append(torch.where(ok, e, 0))
    return torch.stack(starts, dim=1), torch.stack(ends, dim=1)


def stencil_pairs(cl: CellList, rows: torch.Tensor,
                  cells: torch.Tensor | None = None):
    """(own, cand) int64 [P]: every (row, candidate) pair of the rows' runs
    (around `cells` when given, see stencil_runs), in (row, candidate)
    ascending order for ascending rows. Self pairs are included. Waits for
    the device once, for the pair count."""
    start, end = stencil_runs(cl, rows, cells)
    s = start.shape[1]
    ln = (end - start).reshape(-1)
    with span("tc.host_wait"):
        total = int(ln.sum())
    dev = cl.fields.device
    run = torch.repeat_interleave(
        torch.arange(ln.numel(), device=dev), ln, output_size=total)
    first = torch.cumsum(ln, 0) - ln
    cand = (start.reshape(-1)[run]
            + torch.arange(total, device=dev) - first[run])
    own = rows.to(torch.int64).repeat_interleave(s)[run]
    return own, cand


def flat_cells(pos: torch.Tensor, alive: torch.Tensor,
               cfg: SystemConfig) -> torch.Tensor:
    """[R] int64 flat cell id (cz*ny + cy)*nx + cx of positions [R, 3], as
    build_cell_list computes it; num_cells where not alive."""
    flat = flatten_cells(cell_coords(pos, cfg), cfg).to(torch.int64)
    return torch.where(alive, flat, torch.full_like(flat, cfg.num_cells))
