"""Traffic scenario simulator: road maps + per-vehicle movement modes.

The scenario-generation toolkit of the reference's test layer
(vehicle_simulator.py:69-761, SURVEY.md §2.12): a TrafficMap of road
segments / intersections / cities (grid generator with 50 km/h roads every
`cell_size` meters and up to 5 cities, :219-270, or a random map, :272-302),
and a VehicleSimulator with three movement modes — random,
road_constrained, destination_oriented (:436-719) — and two spatial
distributions (uniform / 80-20 city-skew, :376-390).

This is host-side scenario tooling that FEEDS the engine (via Scene.ingest
or any REST sink); the hot path stays on device. Randomness is seeded
(`random.Random(seed)`) so scenarios reproduce — the reference used the
global RNG.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

from tpu_collide_torch.core.types import LocationData, Position, Vector, Vehicle
from tpu_collide_torch.core.utils import get_logger

logger = get_logger(__name__)

VEHICLE_SIZES = {"car": 2.0, "truck": 4.0, "bus": 5.0, "motorcycle": 1.0}


@dataclasses.dataclass
class RoadSegment:
    """reference vehicle_simulator.py:29-41"""
    id: str
    start: Position
    end: Position
    width: float = 5.0
    speed_limit: float = 13.9           # 50 km/h

    @property
    def length(self) -> float:
        return self.start.distance_to(self.end)

    def direction(self) -> Tuple[float, float]:
        l = self.length
        if l < 0.1:
            return (1.0, 0.0)
        return ((self.end.x - self.start.x) / l,
                (self.end.y - self.start.y) / l)


@dataclasses.dataclass
class City:
    """reference vehicle_simulator.py:55-66"""
    id: str
    center: Position
    radius: float
    density: float = 1.0


class TrafficMap:
    """Roads/intersections/cities (reference vehicle_simulator.py:69-302)."""

    def __init__(self, seed: int = 0):
        self.size: Tuple[float, float] = (10_000.0, 10_000.0)
        self.roads: Dict[str, RoadSegment] = {}
        self.intersections: Dict[str, Position] = {}
        self.cities: Dict[str, City] = {}
        self.road_connections: Dict[str, List[str]] = {}
        self.rng = random.Random(seed)

    def add_road(self, road: RoadSegment) -> None:
        self.roads[road.id] = road
        self.road_connections.setdefault(road.id, [])

    def add_intersection(self, iid: str, pos: Position) -> None:
        self.intersections[iid] = pos

    def add_city(self, city: City) -> None:
        self.cities[city.id] = city

    def connect_roads(self, a: str, b: str) -> None:
        self.road_connections.setdefault(a, []).append(b)
        self.road_connections.setdefault(b, []).append(a)

    def get_next_road(self, road_id: str) -> Optional[str]:
        # filter to roads that exist: the reference's grid generator connects
        # a phantom v-road-{width+1} at the map edge
        # (vehicle_simulator.py:256-258) — harmless there only because the
        # code never ran
        nxt = [r for r in self.road_connections.get(road_id, [])
               if r in self.roads]
        return self.rng.choice(nxt) if nxt else None

    def get_position_on_road(self) -> Tuple[float, float, str]:
        rid = self.rng.choice(list(self.roads)) if self.roads else None
        if rid is None:
            return (self.rng.uniform(0, self.size[0]),
                    self.rng.uniform(0, self.size[1]), "")
        r = self.roads[rid]
        t = self.rng.random()
        return (r.start.x + (r.end.x - r.start.x) * t,
                r.start.y + (r.end.y - r.start.y) * t, rid)

    def get_position_near_city(self) -> Position:
        if not self.cities:
            return Position(self.rng.uniform(0, self.size[0]),
                            self.rng.uniform(0, self.size[1]), 0.0)
        c = self.rng.choice(list(self.cities.values()))
        r = self.rng.random() * c.radius
        th = self.rng.random() * 2 * math.pi
        return Position(c.center.x + r * math.cos(th),
                        c.center.y + r * math.sin(th), 0.0)

    def generate_grid_map(self, width: int, height: int,
                          cell_size: float = 100.0) -> "TrafficMap":
        """Grid of 50 km/h roads every cell_size meters + up to 5 cities
        (reference :219-270)."""
        self.size = (width * cell_size, height * cell_size)
        for i in range(height + 1):
            self.add_road(RoadSegment(
                f"h-road-{i}", Position(0, i * cell_size, 0),
                Position(width * cell_size, i * cell_size, 0)))
        for i in range(width + 1):
            self.add_road(RoadSegment(
                f"v-road-{i}", Position(i * cell_size, 0, 0),
                Position(i * cell_size, height * cell_size, 0)))
        for i in range(width + 1):
            for j in range(height + 1):
                self.add_intersection(
                    f"intersection-{i}-{j}",
                    Position(i * cell_size, j * cell_size, 0))
                if i < width:
                    self.connect_roads(f"h-road-{j}", f"v-road-{i}")
                if j < height:
                    self.connect_roads(f"h-road-{j}", f"v-road-{i+1}")
        for _ in range(min(5, (width + 1) * (height + 1) // 4)):
            i = self.rng.randint(0, width)
            j = self.rng.randint(0, height)
            self.add_city(City(
                f"city-{i}-{j}", Position(i * cell_size, j * cell_size, 0),
                radius=self.rng.uniform(cell_size * 1.5, cell_size * 3),
                density=self.rng.uniform(0.5, 1.0)))
        return self

    def generate_random_map(self, num_roads: int = 50,
                            num_cities: int = 5) -> "TrafficMap":
        """Random roads + cities (reference :272-302)."""
        w, h = self.size
        for i in range(num_roads):
            s = Position(self.rng.uniform(0, w), self.rng.uniform(0, h), 0)
            e = Position(self.rng.uniform(0, w), self.rng.uniform(0, h), 0)
            self.add_road(RoadSegment(
                f"road-{i}", s, e,
                speed_limit=self.rng.uniform(8.3, 27.8)))
        rids = list(self.roads)
        for rid in rids:
            for other in self.rng.sample(rids, min(3, len(rids))):
                if other != rid:
                    self.connect_roads(rid, other)
        for i in range(num_cities):
            self.add_city(City(
                f"city-{i}",
                Position(self.rng.uniform(0, w), self.rng.uniform(0, h), 0),
                radius=self.rng.uniform(500, 2000),
                density=self.rng.uniform(0.5, 1.0)))
        return self


class VehicleSimulator:
    """Per-vehicle scenario simulator (reference
    vehicle_simulator.py:305-761)."""

    MAX_SPEED = 30.0

    def __init__(self, traffic_map: Optional[TrafficMap] = None,
                 num_vehicles: int = 100,
                 movement_mode: str = "random",
                 distribution: str = "uniform",
                 seed: int = 0):
        assert movement_mode in ("random", "road_constrained",
                                 "destination_oriented")
        assert distribution in ("uniform", "city_centered")
        self.traffic_map = traffic_map or TrafficMap(seed).generate_grid_map(
            100, 100)
        self.num_vehicles = num_vehicles
        self.movement_mode = movement_mode
        self.distribution = distribution
        self.rng = random.Random(seed)
        self.vehicles: Dict[str, Vehicle] = {}
        self.vehicle_modes: Dict[str, str] = {}
        self.vehicle_roads: Dict[str, str] = {}
        self.vehicle_targets: Dict[str, Position] = {}
        self.stats = {"updates": 0}

    # ---- initialization (reference :342-434) ----

    def initialize_vehicles(self) -> None:
        self.vehicles.clear()
        w, h = self.traffic_map.size
        for i in range(self.num_vehicles):
            vid = f"vehicle-{i}"
            vtype = self.rng.choice(list(VEHICLE_SIZES))
            # 80% near cities when city_centered (reference :376-390)
            if (self.distribution == "city_centered"
                    and self.traffic_map.cities and self.rng.random() < 0.8):
                pos = self.traffic_map.get_position_near_city()
            else:
                pos = Position(self.rng.uniform(0, w),
                               self.rng.uniform(0, h), 0.0)
            speed = self.rng.uniform(5, 20)
            heading = self.rng.uniform(0, 2 * math.pi)
            self.vehicles[vid] = Vehicle(
                id=vid, position=pos,
                velocity=Vector(speed * math.cos(heading),
                                speed * math.sin(heading), 0.0),
                heading=heading, size=VEHICLE_SIZES[vtype], type=vtype)
            self.vehicle_modes[vid] = self.movement_mode

    # ---- update (reference :436-719) ----

    def update_vehicles(self, dt: float) -> List[Vehicle]:
        for vid, v in self.vehicles.items():
            mode = self.vehicle_modes.get(vid, "random")
            if mode == "random":
                self._update_random(v, dt)
            elif mode == "road_constrained":
                self._update_road(v, vid, dt)
            else:
                self._update_destination(v, vid, dt)
            v.timestamp = time.time()
        self.stats["updates"] += 1
        return list(self.vehicles.values())

    def _cap_speed(self, v: Vehicle, max_speed: float) -> float:
        speed = math.hypot(v.velocity.x, v.velocity.y)
        if speed > max_speed:
            v.velocity.x *= max_speed / speed
            v.velocity.y *= max_speed / speed
            speed = max_speed
        return speed

    def _update_random(self, v: Vehicle, dt: float) -> None:
        """reference :468-500: accel jitter, cap, move, soft bounce (x0.5)."""
        if self.rng.random() < 0.1:
            v.acceleration.x = self.rng.uniform(-1, 1)
            v.acceleration.y = self.rng.uniform(-1, 1)
        v.velocity.x += v.acceleration.x * dt
        v.velocity.y += v.acceleration.y * dt
        speed = self._cap_speed(v, self.MAX_SPEED)
        v.position.x += v.velocity.x * dt
        v.position.y += v.velocity.y * dt
        if speed > 0.1:
            v.heading = math.atan2(v.velocity.y, v.velocity.x)
        w, h = self.traffic_map.size
        if v.position.x < 0:
            v.position.x, v.velocity.x = 0.0, -v.velocity.x * 0.5
        elif v.position.x > w:
            v.position.x, v.velocity.x = w, -v.velocity.x * 0.5
        if v.position.y < 0:
            v.position.y, v.velocity.y = 0.0, -v.velocity.y * 0.5
        elif v.position.y > h:
            v.position.y, v.velocity.y = h, -v.velocity.y * 0.5

    def _update_road(self, v: Vehicle, vid: str, dt: float) -> None:
        """reference :502-625: project onto road, advance, switch at ends."""
        rid = self.vehicle_roads.get(vid)
        if not rid or rid not in self.traffic_map.roads:
            x, y, rid = self.traffic_map.get_position_on_road()
            if not rid:
                return self._update_random(v, dt)
            v.position.x, v.position.y = x, y
            self.vehicle_roads[vid] = rid
            # snap velocity onto the road so the perpendicular component of
            # the random initial heading doesn't drift the vehicle off-road
            road = self.traffic_map.roads[rid]
            dx, dy = road.direction()
            speed = math.hypot(v.velocity.x, v.velocity.y)
            v.velocity.x, v.velocity.y = speed * dx, speed * dy
            v.heading = math.atan2(dy, dx)
        road = self.traffic_map.roads[rid]
        dx, dy = road.direction()
        along = ((v.position.x - road.start.x) * dx
                 + (v.position.y - road.start.y) * dy)
        if along >= road.length:
            nxt = self.traffic_map.get_next_road(rid)
            if nxt:
                self.vehicle_roads[vid] = nxt
                nr = self.traffic_map.roads[nxt]
                v.position.x, v.position.y = nr.start.x, nr.start.y
                ndx, ndy = nr.direction()
                speed = math.hypot(v.velocity.x, v.velocity.y)
                v.velocity.x, v.velocity.y = speed * ndx, speed * ndy
                v.heading = math.atan2(ndy, ndx)
            else:
                v.position.x, v.position.y = road.end.x, road.end.y
                v.velocity.x, v.velocity.y = -v.velocity.x, -v.velocity.y
                v.heading = math.atan2(v.velocity.y, v.velocity.x)
        elif along < 0:
            v.position.x, v.position.y = road.start.x, road.start.y
            v.velocity.x, v.velocity.y = -v.velocity.x, -v.velocity.y
            v.heading = math.atan2(v.velocity.y, v.velocity.x)
        else:
            if self.rng.random() < 0.1:
                a = self.rng.uniform(-1, 1)
                v.acceleration.x, v.acceleration.y = a * dx, a * dy
            v.velocity.x += v.acceleration.x * dt
            v.velocity.y += v.acceleration.y * dt
            speed = self._cap_speed(v, road.speed_limit)
            if v.velocity.x * dx + v.velocity.y * dy < 0:
                v.velocity.x, v.velocity.y = abs(speed) * dx, abs(speed) * dy
            v.position.x += v.velocity.x * dt
            v.position.y += v.velocity.y * dt
            # re-project onto the road line (accel noise is axis-aligned but
            # float drift accumulates)
            px = v.position.x - road.start.x
            py = v.position.y - road.start.y
            along = px * dx + py * dy
            v.position.x = road.start.x + along * dx
            v.position.y = road.start.y + along * dy
            v.heading = math.atan2(v.velocity.y, v.velocity.x)

    def _update_destination(self, v: Vehicle, vid: str, dt: float) -> None:
        """reference :627-719: steer toward a target (70% city-biased),
        pick a new one on arrival."""
        target = self.vehicle_targets.get(vid)
        if target is None:
            target = (self.traffic_map.get_position_near_city()
                      if self.rng.random() < 0.7 else
                      Position(self.rng.uniform(0, self.traffic_map.size[0]),
                               self.rng.uniform(0, self.traffic_map.size[1]),
                               0.0))
            self.vehicle_targets[vid] = target
        dx = target.x - v.position.x
        dy = target.y - v.position.y
        dist = math.hypot(dx, dy)
        if dist < 20.0:                            # arrived
            del self.vehicle_targets[vid]
            return
        ux, uy = dx / dist, dy / dist
        v.acceleration.x, v.acceleration.y = ux * 2.0, uy * 2.0
        v.velocity.x += v.acceleration.x * dt
        v.velocity.y += v.acceleration.y * dt
        self._cap_speed(v, self.MAX_SPEED)
        v.position.x += v.velocity.x * dt
        v.position.y += v.velocity.y * dt
        v.heading = math.atan2(v.velocity.y, v.velocity.x)
        # keep inside the map (targets are in-bounds; overshoot isn't)
        w, h = self.traffic_map.size
        v.position.x = min(max(v.position.x, 0.0), w)
        v.position.y = min(max(v.position.y, 0.0), h)

    # ---- egress (reference :721-761, 828-908) ----

    def to_location_data(self) -> List[LocationData]:
        return [LocationData(
            vehicle_id=v.id, position=v.position, velocity=v.velocity,
            acceleration=v.acceleration, heading=v.heading,
            timestamp=v.timestamp) for v in self.vehicles.values()]

    def to_json(self) -> str:
        return json.dumps([l.to_dict() for l in self.to_location_data()])

    def run(self, duration: float, dt: float = 0.1,
            sink: Optional[Callable[[List[LocationData]], None]] = None,
            realtime: bool = False) -> int:
        """Drive the simulation, pushing each update batch to `sink`
        (e.g. scene-feeding, console, HTTP client)."""
        steps = int(duration / dt)
        for _ in range(steps):
            self.update_vehicles(dt)
            if sink:
                sink(self.to_location_data())
            if realtime:
                time.sleep(dt)
        return steps


def scene_sink(scene, simulator: Optional["VehicleSimulator"] = None
               ) -> Callable[[List[LocationData]], None]:
    """Sink that feeds a Scene. Pass the simulator so vehicle size/type ride
    along (LocationData doesn't carry them; without the lookup every object
    would ingest as a 2 m car and pair safe distances would be wrong for
    trucks/buses)."""
    def push(batch: List[LocationData]):
        for loc in batch:
            v = simulator.vehicles.get(loc.vehicle_id) if simulator else None
            if v is not None:
                scene.ingest(loc, size=v.size, vtype=v.type)
            else:
                scene.ingest(loc)
    return push


def kafka_sink(bootstrap_servers: str = "localhost:9092",
               topic: str = "vehicle-locations"):
    """Kafka JSON emitter (reference vehicle_simulator.py:764-794). Gated:
    kafka-python is not bundled; raises with guidance when absent."""
    try:
        from kafka import KafkaProducer  # type: ignore
    except ImportError as e:
        raise ImportError(
            "kafka-python is not installed in this environment; use "
            "scene_sink/http sinks, or install kafka-python to emit to "
            f"Kafka at {bootstrap_servers}") from e
    producer = KafkaProducer(bootstrap_servers=bootstrap_servers,
                             value_serializer=lambda v: json.dumps(
                                 v, default=str).encode())

    def push(batch: List[LocationData]):
        for loc in batch:
            producer.send(topic, loc.to_dict(), key=loc.vehicle_id.encode())
    return push


def redis_sink(url: str = "redis://localhost:6379",
               channel: str = "vehicle-locations"):
    """Redis pub/sub JSON emitter (reference vehicle_simulator.py:797-825).
    Gated like kafka_sink."""
    try:
        import redis  # type: ignore
    except ImportError as e:
        raise ImportError(
            "redis is not installed in this environment; use scene_sink/"
            f"http sinks, or install redis to publish to {url}") from e
    client = redis.Redis.from_url(url)

    def push(batch: List[LocationData]):
        for loc in batch:
            client.publish(channel, json.dumps(loc.to_dict(), default=str))
    return push


def http_sink(base_url: str = "http://127.0.0.1:8000"):
    """POST each location to a tpu-collide REST server."""
    import urllib.request

    def push(batch: List[LocationData]):
        for loc in batch:
            req = urllib.request.Request(
                base_url + "/vehicles/location",
                data=json.dumps(loc.to_dict(), default=str).encode(),
                method="POST",
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5).read()
    return push
