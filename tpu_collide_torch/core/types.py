"""Host-side domain dataclasses — the framework's public data model.

Covers the reference's `common/models.py:10-207` surface (Position, Vector,
LocationData, CollisionRisk, Task, TaskResult, NodeInfo, LoadMetrics,
GridConfig/GridInfo) so users of the reference find the same vocabulary, and
fixes its two-incompatible-schemas problem (SURVEY.md §2.9 #13/#14) by having
exactly ONE CollisionRisk and ONE LoadMetrics.

These types live at the host boundary (ingest/egress, REST API, alerts); on
device everything is SoA arrays (core/state.py).
"""
from __future__ import annotations

import dataclasses
import math
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Position:
    """3D position in meters. Reference: models.py:10-21."""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def distance_to(self, other: "Position") -> float:
        return math.sqrt((self.x - other.x) ** 2 + (self.y - other.y) ** 2
                         + (self.z - other.z) ** 2)

    def to_tuple(self) -> Tuple[float, float, float]:
        return (self.x, self.y, self.z)


@dataclasses.dataclass
class Vector:
    """3D vector. Reference: models.py:24-40."""
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def magnitude(self) -> float:
        return math.sqrt(self.x ** 2 + self.y ** 2 + self.z ** 2)

    def normalize(self) -> "Vector":
        m = self.magnitude()
        if m == 0:
            return Vector(0.0, 0.0, 0.0)
        return Vector(self.x / m, self.y / m, self.z / m)

    def dot(self, other: "Vector") -> float:
        return self.x * other.x + self.y * other.y + self.z * other.z


@dataclasses.dataclass
class Vehicle:
    """A moving object. The reference imports this from common.models where it
    never existed (SURVEY.md §2.9 #1); here it is real. Heading is RADIANS."""
    id: str
    position: Position
    velocity: Vector
    acceleration: Vector = dataclasses.field(default_factory=Vector)
    heading: float = 0.0
    size: float = 2.0
    type: str = "car"
    timestamp: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class LocationData:
    """A position report from a vehicle. Reference: models.py:43-64."""
    vehicle_id: str
    position: Position
    velocity: Vector
    acceleration: Vector = dataclasses.field(default_factory=Vector)
    heading: float = 0.0
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "vehicle_id": self.vehicle_id,
            "position": dataclasses.asdict(self.position),
            "velocity": dataclasses.asdict(self.velocity),
            "acceleration": dataclasses.asdict(self.acceleration),
            "heading": self.heading,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LocationData":
        return cls(
            vehicle_id=d["vehicle_id"],
            position=Position(**d.get("position", {})),
            velocity=Vector(**d.get("velocity", {})),
            acceleration=Vector(**d.get("acceleration", {})),
            heading=d.get("heading", 0.0),
            timestamp=d.get("timestamp", time.time()),
        )


@dataclasses.dataclass
class CollisionRisk:
    """THE collision-risk record (unifies the two incompatible schemas of
    reference models.py:108-136 and collision_detection.py:156-166)."""
    id: str
    vehicle_id: str
    other_vehicle_id: str
    risk_level: float
    time_to_collision: float
    distance: float
    relative_speed: float = 0.0
    collision_position: Optional[Position] = None
    is_predicted: bool = False
    timestamp: float = dataclasses.field(default_factory=time.time)

    @classmethod
    def new(cls, vehicle_id: str, other_vehicle_id: str, **kw) -> "CollisionRisk":
        return cls(id=f"risk-{uuid.uuid4()}", vehicle_id=vehicle_id,
                   other_vehicle_id=other_vehicle_id, **kw)


@dataclasses.dataclass
class Task:
    """A scheduled unit of work. Reference: models.py:139-160."""
    task_id: str
    task_type: str
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    priority: int = 0
    grid_id: Optional[str] = None
    created_at: float = dataclasses.field(default_factory=time.time)
    timeout_s: float = 30.0


@dataclasses.dataclass
class TaskResult:
    """Reference: models.py:163-197."""
    task_id: str
    node_id: str
    success: bool
    result: Any = None
    error: Optional[str] = None
    completed_at: float = dataclasses.field(default_factory=time.time)
    processing_time_ms: float = 0.0


@dataclasses.dataclass
class LoadMetrics:
    """THE load-metrics record (unifies models.py:200-207 with the extended
    fields the collision layer expected, SURVEY.md §2.9 #14)."""
    cpu_usage: float = 0.0
    memory_usage: float = 0.0
    network_usage: float = 0.0
    disk_usage: float = 0.0
    queue_size: int = 0
    task_queue_size: int = 0
    processing_rate: float = 0.0
    average_latency: float = 0.0
    timestamp: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class NodeInfo:
    """A compute participant (a device/shard in the TPU build).
    Reference: models.py:108-136 region."""
    node_id: str
    host: str = "local"
    port: int = 0
    status: str = "active"           # active | suspected | failed
    grid_ids: List[str] = dataclasses.field(default_factory=list)
    load: LoadMetrics = dataclasses.field(default_factory=LoadMetrics)
    registered_at: float = dataclasses.field(default_factory=time.time)
    last_heartbeat: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class NodeConfig:
    """Per-node tuning (reference models.py:87-94, consumed by
    ComputeNodeFactory compute_node.py:645-672). In this framework the
    compiled step replaces per-node workers; these knobs map onto
    SystemConfig (search_radius -> DetectionConfig.search_radius,
    batch_size/processing_interval -> scan chunking / detection_hz)."""
    max_workers: int = 4
    search_radius: float = 100.0
    batch_size: int = 100
    processing_interval: float = 0.1


@dataclasses.dataclass
class GridInfo:
    """A spatial tile. Reference: models.py:67-105."""
    grid_id: str
    level: int
    cell: Tuple[int, int, int]
    bounds_lo: Tuple[float, float, float]
    bounds_hi: Tuple[float, float, float]
    vehicle_count: int = 0


@dataclasses.dataclass
class Alert:
    """A prioritized collision alert (reference warning_system.py:30-45
    `AlertInfo`; `Alert` was also a phantom import there, §2.9 #1)."""
    id: str
    vehicle_id: str
    other_vehicle_id: str
    risk_level: float
    time_to_collision: float
    message: str
    priority: int
    timestamp: float = dataclasses.field(default_factory=time.time)
    acknowledged: bool = False
    last_sent: float = 0.0

    def __lt__(self, other: "Alert") -> bool:
        # heapq is a min-heap; invert so highest (priority, recency) pops
        # first — same trick as reference warning_system.py:43-45.
        return (self.priority, -self.timestamp) > (other.priority, -other.timestamp)
