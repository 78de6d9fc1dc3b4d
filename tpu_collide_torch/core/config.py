"""Frozen configuration tree of the PyTorch port.

The same dataclasses, field names, defaults and derived properties as
`tpu_collide.core.config`. The port keeps its own copy because importing the
JAX package's module runs `tpu_collide/__init__.py`, which imports JAX. A
configuration crosses between the two packages as JSON:
`SystemConfig.from_json(jax_cfg.to_json())`.

Fields that only shaped the TPU kernel's layout (`GridConfig.band_cells`,
`GridConfig.cand_lanes`, `GridConfig.wide_oid`) are accepted and ignored by
the port, as are the kernel gates (`DetectionConfig.gate_stage1`,
`gate_stage2`), which only ever skipped work.

`DetectionConfig.hot_cover` is the port's own (see PORT_ONLY): which rows
of the fast tail the hot top-up covers and the certificate counts.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Axis-aligned world bounds (m). A zero z extent makes a 2D world."""
    lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hi: Tuple[float, float, float] = (10_000.0, 10_000.0, 0.0)

    @property
    def extent(self) -> Tuple[float, float, float]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    @property
    def is_3d(self) -> bool:
        return (self.hi[2] - self.lo[2]) > 0.0


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Uniform grid. The fused path needs cell_size >= search_radius, so
    that a 1-cell stencil covers the search radius."""
    cell_size: float = 100.0
    cell_capacity: int = 16
    band_cells: int | None = None
    wide_oid: bool | None = None
    cand_lanes: int | None = None


HOT_COVERS = ("count", "cut")

# The port's fields that the JAX package's config does not have, with their
# defaults: to_json leaves such a field out while it holds its default, so
# that a port config crosses to the JAX package whenever it asks for
# nothing the JAX package lacks.
PORT_ONLY = {"detect": {"hot_cover": "count"}}


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Canonical 4-stage detection semantics (see tpu_collide's copy for the
    reference citations of every field)."""
    search_radius: float = 100.0
    time_window: float = 10.0
    time_step: float = 0.1
    safe_distance_base: float = 5.0
    max_warning_time: float = 10.0
    max_relative_speed: float = 50.0
    min_relative_speed: float = 0.1
    weight_distance: float = 0.3
    weight_time: float = 0.3
    weight_speed: float = 0.2
    weight_angle: float = 0.1
    weight_type: float = 0.1
    same_type_factor: float = 0.5
    diff_type_factor: float = 0.8
    # 'precise' = sampled constant-acceleration sweep; 'fast' = closed-form
    # constant-velocity first crossing
    mode: str = "precise"
    precise_survivor_cap: int | None = None
    survivor_k: int = 8
    hot_topup: int = 8
    # which rows the fast tail's hot top-up covers and alert_overflow
    # counts: 'count' = every own row with more qualifying pairs than
    # slots, the hottest first (the JAX package's rule); 'cut' = only the
    # rows whose dropped pairs can rank in the scene list
    # (kernels/refine._reaching_rows), in fast mode on one device
    hot_cover: str = "count"
    # 'physical' or 'reference' (the reference's closest-approach sign bug,
    # DEVIATIONS.md #1)
    convention: str = "physical"
    # 'product' or 'direct' form of sin(|heading_i - heading_j|)
    angle_form: str = "product"
    gate_stage2: bool = True
    gate_stage1: bool = False
    # False: num_pairs_checked reports -1
    count_checked: bool = True

    def __post_init__(self):
        if self.hot_cover not in HOT_COVERS:
            raise ValueError(f"hot_cover {self.hot_cover!r} is not one of "
                             f"{HOT_COVERS}")

    @property
    def num_time_steps(self) -> int:
        return int(self.time_window / self.time_step)


@dataclasses.dataclass(frozen=True)
class AlertConfig:
    """Alert thresholds, priority rules and top-k sizes."""
    risk_low: float = 0.3
    risk_medium: float = 0.6
    risk_high: float = 0.8
    ttc_critical: float = 3.0
    ttc_high: float = 5.0
    max_alerts_per_object: int = 4
    max_scene_alerts: int = 1024
    alert_expiry_s: float = 30.0
    resend_interval_s: float = 0.5


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Fleet physics of the measured harness."""
    dt: float = 0.1
    accel_change_prob: float = 0.1
    accel_range: float = 1.0
    max_speed: float = 30.0
    min_heading_speed: float = 0.1
    speed_min: float = 5.0
    speed_max: float = 20.0
    city_fraction: float = 0.8


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Spatial sharding settings: the mesh of shard/step.make_mesh (x slabs,
    (x, y) tiles or (x, y, z) boxes), the halo band and the send buffers'
    capacities, the per-shard slot headroom."""
    num_shards: int = 1
    axis_name: str = "shard"
    halo_width: float = 100.0
    halo_capacity: int = 256
    migrate_capacity: int = 64
    slot_headroom: float = 2.0
    num_shards_y: int = 1
    axis_name_y: str = "shard_y"
    num_shards_z: int = 1
    axis_name_z: str = "shard_z"

    @property
    def total_shards(self) -> int:
        return self.num_shards * self.num_shards_y * self.num_shards_z


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    num_objects: int = 1000
    world: WorldConfig = WorldConfig()
    grid: GridConfig = GridConfig()
    detect: DetectionConfig = DetectionConfig()
    alerts: AlertConfig = AlertConfig()
    sim: SimConfig = SimConfig()
    shard: ShardConfig = ShardConfig()

    @property
    def grid_dims(self) -> Tuple[int, int, int]:
        ext = self.world.extent
        cs = self.grid.cell_size
        return tuple(max(1, int(math.ceil(e / cs)) if e > 0 else 1) for e in ext)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dims
        return nx * ny * nz

    @property
    def survivor_cap(self) -> int:
        """Stage-2 survivor compaction capacity (precise mode)."""
        c = self.detect.precise_survivor_cap
        return c if c is not None else max(4096, 2 * self.num_objects)

    @property
    def stencil_halfwidth(self) -> int:
        return max(1, int(math.ceil(self.detect.search_radius / self.grid.cell_size)))

    @property
    def stencil_size(self) -> int:
        w = 2 * self.stencil_halfwidth + 1
        return w * w * (w if self.world.is_3d else 1)

    @property
    def max_candidates(self) -> int:
        return self.stencil_size * self.grid.cell_capacity

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for group, defaults in PORT_ONLY.items():
            for name, default in defaults.items():
                if d[group][name] == default:
                    del d[group][name]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "SystemConfig":
        d = json.loads(s)
        return cls(
            num_objects=d.get("num_objects", 1000),
            world=WorldConfig(**{**d.get("world", {}),
                                 **{k: tuple(v) for k, v in d.get("world", {}).items()
                                    if k in ("lo", "hi")}}),
            grid=GridConfig(**d.get("grid", {})),
            detect=DetectionConfig(**d.get("detect", {})),
            alerts=AlertConfig(**d.get("alerts", {})),
            sim=SimConfig(**d.get("sim", {})),
            shard=ShardConfig(**d.get("shard", {})),
        )

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


# car=2.0, truck=4.0, bus=5.0, motorcycle=1.0
VEHICLE_TYPES = ("car", "truck", "bus", "motorcycle")
VEHICLE_SIZES = (2.0, 4.0, 5.0, 1.0)
