"""REST API — FastAPI server with the reference's endpoint surface.

Paths and response envelope match the reference (api.py:88-391) so existing
clients port 1:1:

  GET  /health
  POST /vehicles/location            (ingest -> broker + Scene buffer)
  GET  /vehicles/{id}/location
  GET  /vehicles/{id}/history
  GET  /vehicles/{id}/risks
  GET  /risks/{id}
  POST /tasks
  POST /nodes  DELETE /nodes/{id}  POST /nodes/{id}/load
  GET  /grids/{id}/vehicles

Additions beyond the reference (it polled these but never implemented them,
SURVEY.md §2.12/§4):

  GET  /alerts                       (active alerts, min_risk filter)
  POST /alerts/{id}/acknowledge
  POST /step                         (advance the scene N steps)
  GET  /stats                        (aggregate metrics tree)
  GET  /api/collision/metrics       (the metrics path performance_monitor.py
                                     polls, performance_monitor.py:397-589)
  POST /api/admin/inject-failure    (fault injection the reference's
                                     FailureInjector client expected,
                                     load_generator.py:748-865)

The port of tpu_collide/api/rest.py. Annotations are evaluated where they
are written: FastAPI reads the request models of the handlers below from
their annotations, and it cannot resolve a postponed one that names a class
local to create_app (the request then fails with 422). POST /step's model
carries `pipelined` and `burst`, which the route core reads.
"""
from typing import Any, Dict, List, Optional

from tpu_collide_torch.core.types import LocationData
from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.api.scene import Scene
from tpu_collide_torch.api.routes import RouteTable
from tpu_collide_torch.runtime.messaging import MessageBroker, LocationDataProducer
from tpu_collide_torch.runtime.reliability import ThrottlingManager

logger = get_logger(__name__)


def create_app(scene: Scene, broker: Optional[MessageBroker] = None,
               scheduler=None, throttling: Optional[ThrottlingManager] = None):
    """Build the FastAPI app around a Scene. Import of fastapi is deferred so
    headless/bench environments never pay for it."""
    from fastapi import FastAPI
    from fastapi.middleware.cors import CORSMiddleware
    from pydantic import BaseModel, Field

    class PositionModel(BaseModel):
        x: float = 0.0
        y: float = 0.0
        z: float = 0.0

    class VectorModel(BaseModel):
        x: float = 0.0
        y: float = 0.0
        z: float = 0.0

    class LocationDataModel(BaseModel):
        vehicle_id: str
        position: PositionModel
        velocity: VectorModel = Field(default_factory=VectorModel)
        acceleration: VectorModel = Field(default_factory=VectorModel)
        heading: float = 0.0
        size: float = 2.0
        vehicle_type: str = "car"
        timestamp: Optional[float] = None

    class TaskModel(BaseModel):
        task_type: str
        payload: Dict[str, Any] = Field(default_factory=dict)
        priority: int = 0
        grid_id: Optional[str] = None
        timeout_s: float = 30.0

    class NodeModel(BaseModel):
        node_id: str
        host: str = "local"
        port: int = 0
        grid_ids: List[str] = Field(default_factory=list)

    class LoadModel(BaseModel):
        cpu_usage: float = 0.0
        memory_usage: float = 0.0
        queue_size: int = 0
        processing_rate: float = 0.0
        average_latency: float = 0.0

    class StepModel(BaseModel):
        steps: int = 1
        pipelined: bool = False
        burst: bool = False

    import asyncio
    from fastapi.responses import JSONResponse

    app = FastAPI(title="tpu-collide API",
                  description="TPU-native real-time collision detection",
                  version="1.0.0")
    app.add_middleware(CORSMiddleware, allow_origins=["*"],
                       allow_credentials=True, allow_methods=["*"],
                       allow_headers=["*"])
    producer = LocationDataProducer(broker) if broker else None
    loop_ref: Dict[str, Any] = {}

    def on_ingest(loc: LocationData) -> None:
        # runs on an executor thread — hop the broker publish back to the
        # event loop
        lp = loop_ref.get("loop")
        if producer is not None and lp is not None:
            import asyncio as _aio
            _aio.run_coroutine_threadsafe(producer.send_location(loc), lp)

    routes = RouteTable(scene, scheduler=scheduler, throttling=throttling,
                        on_ingest=on_ingest)
    app.state.routes = routes

    @app.on_event("startup")
    async def _capture_loop():
        loop_ref["loop"] = asyncio.get_running_loop()

    async def _call(method: str, path: str, body: Optional[dict] = None,
                    query: Optional[Dict[str, str]] = None) -> JSONResponse:
        """Every endpoint funnels through the shared RouteTable, executed
        off the event loop (device work must never block it). Identical
        behavior to the stdlib server by construction."""
        loop = asyncio.get_running_loop()
        code, payload = await loop.run_in_executor(
            None, routes.handle, method, path, body, query or {})
        return JSONResponse(payload, status_code=code)

    # pydantic models validate request shapes; handlers delegate

    @app.get("/health")
    async def health():
        return await _call("GET", "/health")

    @app.post("/vehicles/location")
    async def update_location(loc: LocationDataModel):
        return await _call("POST", "/vehicles/location", loc.model_dump())

    @app.get("/vehicles/{vehicle_id}/location")
    async def get_location(vehicle_id: str):
        return await _call("GET", f"/vehicles/{vehicle_id}/location")

    @app.get("/vehicles/{vehicle_id}/history")
    async def get_history(vehicle_id: str):
        return await _call("GET", f"/vehicles/{vehicle_id}/history")

    @app.get("/vehicles/{vehicle_id}/risks")
    async def get_vehicle_risks(vehicle_id: str):
        return await _call("GET", f"/vehicles/{vehicle_id}/risks")

    @app.get("/risks/{risk_id}")
    async def get_risk(risk_id: str):
        return await _call("GET", f"/risks/{risk_id}")

    @app.post("/tasks")
    async def submit_task(task: TaskModel):
        return await _call("POST", "/tasks", task.model_dump())

    @app.post("/nodes")
    async def register_node(node: NodeModel):
        return await _call("POST", "/nodes", node.model_dump())

    @app.delete("/nodes/{node_id}")
    async def unregister_node(node_id: str):
        return await _call("DELETE", f"/nodes/{node_id}")

    @app.post("/nodes/{node_id}/load")
    async def update_load(node_id: str, load: LoadModel):
        return await _call("POST", f"/nodes/{node_id}/load",
                           load.model_dump())

    @app.get("/grids/{grid_id}/vehicles")
    async def grid_vehicles(grid_id: str):
        """grid_id = 'x_y' cell coords; EXACT cell membership (same
        handler as the stdlib server — the round-1 circumradius
        approximation is gone)."""
        return await _call("GET", f"/grids/{grid_id}/vehicles")

    # ---- additions beyond the reference ----

    @app.get("/alerts")
    async def alerts(min_risk: float = 0.0):
        return await _call("GET", "/alerts", query={"min_risk": min_risk})

    @app.post("/alerts/{alert_id}/acknowledge")
    async def ack(alert_id: str):
        return await _call("POST", f"/alerts/{alert_id}/acknowledge")

    @app.post("/step")
    async def step(body: StepModel):
        return await _call("POST", "/step", body.model_dump())

    @app.post("/detect")
    async def detect():
        return await _call("POST", "/detect")

    @app.get("/stats")
    async def stats():
        return await _call("GET", "/stats")

    @app.get("/api/collision/metrics")
    async def collision_metrics():
        return await _call("GET", "/api/collision/metrics")

    @app.post("/api/admin/inject-failure")
    async def inject_failure(body: Dict[str, Any]):
        return await _call("POST", "/api/admin/inject-failure", body)

    @app.post("/api/admin/reset-failures")
    async def reset_failures():
        return await _call("POST", "/api/admin/reset-failures")

    return app


class ApiServer:
    """uvicorn wrapper (reference api.py:88-391)."""

    def __init__(self, scene: Scene, broker: Optional[MessageBroker] = None,
                 scheduler=None, host: str = "127.0.0.1", port: int = 8000):
        self.scene = scene
        self.host, self.port = host, port
        self.app = create_app(scene, broker=broker, scheduler=scheduler)

    async def serve(self) -> None:
        import uvicorn
        server = uvicorn.Server(uvicorn.Config(
            self.app, host=self.host, port=self.port, log_level="warning"))
        await server.serve()


class ApiClient:
    """Async HTTP client mirroring every endpoint (reference
    api.py:394-598). Uses httpx or aiohttp when available; otherwise a
    stdlib urllib fallback running in a worker thread (this framework must
    run anywhere JAX runs)."""

    def __init__(self, base_url: str = "http://127.0.0.1:8000"):
        self.base_url = base_url.rstrip("/")

    def _request_sync(self, method: str, path: str, json_body=None):
        import json as _json
        import urllib.error
        import urllib.request
        data = (_json.dumps(json_body).encode()
                if json_body is not None else None)
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return _json.loads(r.read())
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                return _json.loads(body)
            except ValueError:
                # non-JSON error body (proxy/ingress page): surface status
                return {"success": False,
                        "message": f"HTTP {e.code}: {body[:200]!r}",
                        "data": None}

    async def _request(self, method: str, path: str, json_body=None):
        try:
            import httpx
        except ImportError:
            httpx = None
        if httpx is not None:
            async with httpx.AsyncClient() as c:
                r = await c.request(method, self.base_url + path,
                                    json=json_body)
                return r.json()
        try:
            import aiohttp
        except ImportError:
            aiohttp = None
        if aiohttp is not None:
            async with aiohttp.ClientSession() as s:
                async with s.request(method, self.base_url + path,
                                     json=json_body) as r:
                    return await r.json()
        import asyncio
        return await asyncio.get_running_loop().run_in_executor(
            None, self._request_sync, method, path, json_body)

    async def health(self):
        return await self._request("GET", "/health")

    async def update_location(self, location: dict):
        return await self._request("POST", "/vehicles/location", location)

    async def get_location(self, vehicle_id: str):
        return await self._request("GET", f"/vehicles/{vehicle_id}/location")

    async def get_history(self, vehicle_id: str):
        return await self._request("GET", f"/vehicles/{vehicle_id}/history")

    async def get_vehicle_risks(self, vehicle_id: str):
        return await self._request("GET", f"/vehicles/{vehicle_id}/risks")

    async def get_risk(self, risk_id: str):
        return await self._request("GET", f"/risks/{risk_id}")

    async def submit_task(self, task: dict):
        return await self._request("POST", "/tasks", task)

    async def register_node(self, node: dict):
        return await self._request("POST", "/nodes", node)

    async def unregister_node(self, node_id: str):
        return await self._request("DELETE", f"/nodes/{node_id}")

    async def update_node_load(self, node_id: str, load: dict):
        return await self._request("POST", f"/nodes/{node_id}/load", load)

    async def grid_vehicles(self, grid_id: str):
        return await self._request("GET", f"/grids/{grid_id}/vehicles")

    async def alerts(self, min_risk: float = 0.0):
        return await self._request("GET", f"/alerts?min_risk={min_risk}")

    async def acknowledge(self, alert_id: str):
        return await self._request("POST", f"/alerts/{alert_id}/acknowledge")

    async def step(self, steps: int = 1):
        return await self._request("POST", "/step", {"steps": steps})

    async def stats(self):
        return await self._request("GET", "/stats")
