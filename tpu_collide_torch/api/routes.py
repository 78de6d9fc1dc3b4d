"""Framework-agnostic route core shared by BOTH HTTP servers.

Round 1 shipped two route implementations (api/rest.py FastAPI,
api/stdlib_server.py stdlib) that drifted apart — the FastAPI /grids
endpoint approximated cell membership with a circumradius query and the
stdlib server lacked the scheduler routes. This module is the single
source of truth: `RouteTable.handle(method, path, body, query)` implements
every endpoint once; the FastAPI app and the stdlib server are thin
transports over it, so they cannot diverge and the whole surface is
testable without fastapi installed.

Paths and the {success, message, data} envelope match the reference
(api.py:88-391) plus the metrics/fault-injection endpoints its harness
polled but never implemented (performance_monitor.py:397-589,
load_generator.py:748-865).
"""
from __future__ import annotations

import dataclasses
import re
import threading
import time

import numpy as np
from typing import Any, Dict, Optional, Tuple

from tpu_collide_torch.core.device import to_host
from tpu_collide_torch.core.types import LocationData, Position, Vector, Task
from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.api.scene import Scene

logger = get_logger(__name__)


def _ok(data: Any = None, message: str = "ok") -> Dict[str, Any]:
    return {"success": True, "message": message, "data": data}


def _err(message: str) -> Dict[str, Any]:
    return {"success": False, "message": message, "data": None}


class FaultState:
    """Active injected faults (reference FailureInjector surface,
    load_generator.py:748-865). All four reference fault types round-trip;
    `drop_objects` is this framework's addition."""

    def __init__(self):
        self.slow_until = 0.0
        self.slow_latency_ms = 0.0
        self.high_load_until = 0.0
        self.partitioned_nodes: set = set()
        self.log: list = []

    def active(self) -> Dict[str, Any]:
        now = time.time()
        return {
            "slow_response": max(0.0, self.slow_until - now),
            "high_load": max(0.0, self.high_load_until - now),
            "partitioned_nodes": sorted(self.partitioned_nodes),
            "injected_total": len(self.log),
        }

    def reset(self):
        self.slow_until = 0.0
        self.high_load_until = 0.0
        self.partitioned_nodes.clear()


class RouteTable:
    """All REST endpoints over a Scene (+ optional scheduler).

    handle() is synchronous and serializes on an internal lock (device
    access must be single-threaded); async transports call it via
    run_in_executor so device work never blocks an event loop."""

    def __init__(self, scene: Scene, scheduler=None, throttling=None,
                 on_ingest=None):
        self.scene = scene
        self.scheduler = scheduler
        self.throttling = throttling
        self.on_ingest = on_ingest       # callback(LocationData) after ingest
        self.faults = FaultState()
        self._lock = threading.Lock()

    # ---- fault plumbing ----

    def _apply_faults(self) -> None:
        now = time.time()
        if now < self.faults.slow_until:
            time.sleep(self.faults.slow_latency_ms / 1000.0)
        if now < self.faults.high_load_until:
            # emulate load pressure: brief busy spin (bounded — one core)
            end = time.time() + 0.02
            while time.time() < end:
                pass

    def _inject(self, body: dict) -> Tuple[int, Dict[str, Any]]:
        kind = (body or {}).get("type", "reset")
        f = self.faults
        if kind == "slow_response":
            f.slow_latency_ms = float(body.get("latency", 500))
            f.slow_until = time.time() + float(body.get("duration", 60))
            f.log.append({"type": kind, "latency": f.slow_latency_ms})
            return 200, _ok(message="slow_response injected")
        if kind == "high_load":
            f.high_load_until = time.time() + float(body.get("duration", 60))
            f.log.append({"type": kind})
            return 200, _ok(message="high_load injected")
        if kind == "network_partition":
            ids = body.get("node_ids", [])
            f.partitioned_nodes.update(ids)
            if self.scheduler is not None:
                for nid in ids:
                    try:
                        self.scheduler.unregister_node(nid)
                    except Exception:  # noqa: BLE001 — best-effort chaos
                        pass
            f.log.append({"type": kind, "node_ids": ids})
            return 200, _ok({"partitioned": sorted(f.partitioned_nodes)})
        if kind == "node_failure":
            nid = body.get("node_id")
            if self.scheduler is not None and nid:
                try:
                    self.scheduler.unregister_node(nid)
                except Exception:  # noqa: BLE001
                    pass
            f.log.append({"type": kind, "node_id": nid})
            return 200, _ok(message=f"node {nid} failed")
        if kind == "drop_objects":
            frac = float(body.get("fraction", 0.1))
            killed = self.scene.drop_fraction(frac)
            f.log.append({"type": kind, "killed": killed})
            return 200, _ok({"killed": killed})
        if kind == "reset":
            f.reset()
            return 200, _ok(message="faults cleared")
        return 400, _err(f"unknown fault type {kind!r}")

    # ---- the one route table ----

    def handle(self, method: str, path: str, body: Optional[dict],
               query: Dict[str, str]) -> Tuple[int, Dict[str, Any]]:
        scene = self.scene
        with self._lock:
            self._apply_faults()
            if (self.throttling is not None
                    and not self.throttling.allow_request(path)):
                return 429, _err("throttled")

            if method == "GET" and path == "/health":
                return 200, _ok({"timestamp": time.time(), "status": "ok"})

            if method == "POST" and path == "/vehicles/location":
                b = body or {}
                try:
                    loc = LocationData(
                        vehicle_id=b["vehicle_id"],
                        position=Position(**b.get("position", {})),
                        velocity=Vector(**b.get("velocity", {})),
                        acceleration=Vector(**b.get("acceleration", {})),
                        heading=b.get("heading", 0.0),
                        timestamp=b.get("timestamp") or time.time())
                except (KeyError, TypeError) as e:
                    return 400, _err(f"bad location payload: {e}")
                scene.ingest(loc, size=b.get("size", 2.0),
                             vtype=b.get("vehicle_type", "car"))
                if self.on_ingest is not None:
                    self.on_ingest(loc)
                return 200, _ok(message="Location updated")

            m = re.fullmatch(r"/vehicles/([^/]+)/location", path)
            if method == "GET" and m:
                loc = scene.get_location(m.group(1))
                if loc is None:
                    return 404, _err(f"vehicle {m.group(1)} not found")
                return 200, _ok(loc.to_dict())

            m = re.fullmatch(r"/vehicles/([^/]+)/history", path)
            if method == "GET" and m:
                return 200, _ok([l.to_dict()
                                 for l in scene.get_history(m.group(1))])

            m = re.fullmatch(r"/vehicles/([^/]+)/risks", path)
            if method == "GET" and m:
                return 200, _ok([dataclasses.asdict(r)
                                 for r in scene.get_vehicle_risks(m.group(1))])

            m = re.fullmatch(r"/risks/([^/]+)", path)
            if method == "GET" and m:
                a = scene.alert_manager.alerts.get(m.group(1))
                if a is None:
                    return 404, _err("risk not found")
                return 200, _ok(dataclasses.asdict(a))

            if method == "POST" and path == "/tasks":
                if self.scheduler is None:
                    return 400, _err("no scheduler configured")
                import uuid
                b = body or {}
                t = Task(task_id=f"task-{uuid.uuid4()}",
                         task_type=b.get("task_type", ""),
                         payload=b.get("payload", {}),
                         priority=b.get("priority", 0),
                         grid_id=b.get("grid_id"),
                         timeout_s=b.get("timeout_s", 30.0))
                tid = self.scheduler.submit_task_nowait(t)
                return 200, _ok({"task_id": tid})

            if method == "POST" and path == "/nodes":
                if self.scheduler is None:
                    return 400, _err("no scheduler configured")
                from tpu_collide_torch.core.types import NodeInfo
                b = body or {}
                self.scheduler.register_node(NodeInfo(
                    node_id=b["node_id"], host=b.get("host", "local"),
                    port=b.get("port", 0), grid_ids=b.get("grid_ids", [])))
                return 200, _ok(message="Node registered")

            m = re.fullmatch(r"/nodes/([^/]+)", path)
            if method == "DELETE" and m:
                if self.scheduler is None:
                    return 400, _err("no scheduler configured")
                self.scheduler.unregister_node(m.group(1))
                return 200, _ok(message="Node unregistered")

            m = re.fullmatch(r"/nodes/([^/]+)/load", path)
            if method == "POST" and m:
                if self.scheduler is None:
                    return 400, _err("no scheduler configured")
                from tpu_collide_torch.core.types import LoadMetrics
                b = body or {}
                self.scheduler.update_node_load(m.group(1), LoadMetrics(
                    cpu_usage=b.get("cpu_usage", 0.0),
                    memory_usage=b.get("memory_usage", 0.0),
                    queue_size=b.get("queue_size", 0),
                    processing_rate=b.get("processing_rate", 0.0),
                    average_latency=b.get("average_latency", 0.0)))
                return 200, _ok(message="Load updated")

            m = re.fullmatch(r"/grids/([^/]+)/vehicles", path)
            if method == "GET" and m:
                try:
                    cx, cy = (int(v) for v in m.group(1).split("_")[:2])
                except ValueError:
                    return 400, _err("grid_id must be '<cx>_<cy>'")
                # EXACT cell membership (reference api.py:372-380 returned
                # the grid store's resident set; a circumradius query would
                # include neighbors' residents)
                return 200, _ok(scene.grid_vehicles(cx, cy))

            if method == "GET" and path == "/alerts":
                min_risk = float(query.get("min_risk", 0.0))
                return 200, _ok([dataclasses.asdict(a)
                                 for a in scene.alerts(min_risk)])

            m = re.fullmatch(r"/alerts/([^/]+)/acknowledge", path)
            if method == "POST" and m:
                if scene.alert_manager.acknowledge_alert(m.group(1)):
                    return 200, _ok(message="acknowledged")
                return 404, _err("alert not found")

            if method == "POST" and path == "/step":
                # burst=true: all steps ride ONE device dispatch
                # (Scene.step_burst) — device-rate stepping for callers
                # that only need the final alert list.
                # pipelined=true: one-behind serving (Scene.step_pipelined)
                # — every step's alerts reach the manager, the response
                # describes the PREVIOUS step (one step of alert latency
                # buys overlap of host work with the device step).
                n = int((body or {}).get("steps", 1))
                if n < 1:
                    return 400, _err("steps must be >= 1")
                if (body or {}).get("burst"):
                    out = scene.step_burst(n)
                elif (body or {}).get("pipelined"):
                    if not hasattr(scene, "step_pipelined"):
                        return 400, _err(
                            "pipelined stepping requires a single-device "
                            "scene")
                    out = None
                    for _ in range(n):
                        out = scene.step_pipelined() or out
                    if out is None:     # first-ever call: nothing consumed
                        return 200, _ok({"step_count": scene.step_count,
                                         "pipelined_pending": True})
                else:
                    out = scene.step(n)
                # the three counters in one device-to-host copy (a CUDA
                # tensor does not convert through numpy), under the Scene's
                # device lock as every other device call
                with scene._device_lock:
                    risks, count, top = to_host(
                        [out.num_risks, out.alerts.count, out.max_risk])
                return 200, _ok({
                    "step_count": scene.step_count,
                    "num_risks": int(risks),
                    "num_alerts": int(count),
                    "max_risk": float(top)})

            if method == "POST" and path == "/detect":
                batch = scene.detect()
                return 200, _ok({"num_alerts":
                                 int(np.asarray(batch.count).sum())})

            if method == "GET" and path == "/stats":
                s = scene.stats()
                s["faults"] = self.faults.active()
                return 200, _ok(s)

            if method == "GET" and path == "/api/collision/metrics":
                s = scene.stats()
                return 200, _ok({
                    "detection_count": s["step_count"],
                    "avg_detection_time_ms": s["avg_step_ms"],
                    "max_detection_time_ms": s["max_step_ms"],
                    "active_alerts": s["alerts"]["active"],
                    "faults": self.faults.active()})

            if method == "POST" and path == "/api/admin/inject-failure":
                return self._inject(body or {})

            if method == "POST" and path == "/api/admin/reset-failures":
                self.faults.reset()
                return 200, _ok(message="faults cleared")

            return 404, _err(f"no route {method} {path}")
