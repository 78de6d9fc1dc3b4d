"""The port's service node on the CPU: the route core
(tpu_collide_torch/api/routes.py), the stdlib HTTP server, the API client,
CollisionSystem (tpu_collide_torch/system.py) and its broker, and the
multi-host bridge. The port cases of tests/test_scene_api.py,
tests/test_runtime.py::test_collision_system_task_dispatch and
tests/test_bridge.py; the port's routes against the JAX package's on the
same requests (the fused step of the JAX Scene in interpret mode); no route
converts a tensor through numpy (on the card np.asarray of a tensor
raises); a sharded configuration is refused.

Every asyncio wait polls in a bounded loop, and every server, broker and
system stops in a finally block."""
import asyncio
import json
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_collide.api import Scene as JaxScene
from tpu_collide.api.routes import RouteTable as JaxRouteTable
from tpu_collide.runtime.messaging import MessageBroker as JaxBroker
import tpu_collide_torch as tt
from tpu_collide_torch.api import Scene
from tpu_collide_torch.api.routes import RouteTable
from tpu_collide_torch.api.stdlib_server import SceneHTTPServer
from tpu_collide_torch.core.config import (VEHICLE_TYPES, ShardConfig,
                                           WorldConfig)
from tpu_collide_torch.core.types import LocationData, Position, Task, Vector
from tpu_collide_torch.runtime.messaging import (TOPIC_ALERTS, Message,
                                                 MessageBroker)
from tpu_collide_torch.system import CollisionSystem
from tests.torch_parity import np_fleet, jax_cfg, to_torch_cfg

torch.set_num_threads(1)

CAR_A = {"vehicle_id": "carA", "position": {"x": 100, "y": 100},
         "velocity": {"x": 10}}
CAR_B = {"vehicle_id": "carB", "position": {"x": 180, "y": 100},
         "velocity": {"x": -10}, "heading": 3.14159}


def small_cfg(n=64):
    return tt.SystemConfig(num_objects=n,
                           world=WorldConfig(hi=(500.0, 500.0, 0.0)))


def small_scene(n=64, **kw):
    return Scene(small_cfg(n), device="cpu", **kw)


async def wait_for(cond, timeout=30.0, interval=0.02) -> bool:
    """Polls cond() until it holds or `timeout` seconds pass."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return cond()


def http_caller(port):
    base = f"http://127.0.0.1:{port}"

    def call(method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            base + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
    return call


# ---- the port cases of tests/test_scene_api.py ------------------------------

def test_rest_endpoints():
    """The endpoint sequence of the JAX test, through the route core the
    FastAPI app (api/rest.create_app) serves, so that it runs without
    FastAPI; the app adds nothing to the handlers."""
    sc = small_scene()
    rt = RouteTable(sc)
    call = lambda m, p, b=None, q=None: rt.handle(m, p, b, q or {})

    assert call("GET", "/health")[1]["success"]
    loc2 = dict(CAR_B, position={"x": 180, "y": 100, "z": 0})
    assert call("POST", "/vehicles/location", CAR_A)[1]["success"]
    assert call("POST", "/vehicles/location", loc2)[1]["success"]

    assert call("POST", "/detect", {})[1]["data"]["num_alerts"] == 1
    alerts = call("GET", "/alerts")[1]["data"]
    assert len(alerts) == 1
    aid = alerts[0]["id"]
    assert call("POST", f"/alerts/{aid}/acknowledge")[1]["success"]

    code, r = call("GET", "/vehicles/carA/location")
    assert r["success"] and r["data"]["position"]["x"] == 100.0
    assert call("GET", "/vehicles/carA/history")[1]["success"]
    assert call("GET", "/vehicles/nope/location")[1]["success"] is False

    # grid query: carA at (100,100) -> cell 1_1 for 100 m cells
    assert "carA" in call("GET", "/grids/1_1/vehicles")[1]["data"]
    assert call("GET", "/grids/zzz/vehicles")[1]["success"] is False

    assert call("GET", "/stats")[1]["data"]["num_alive"] == 2
    r = call("POST", "/api/admin/inject-failure",
             {"type": "drop_objects", "fraction": 0.5})[1]
    assert r["data"]["killed"] == 1
    assert call("GET", "/stats")[1]["data"]["num_alive"] == 1


def test_stdlib_http_server():
    """The dependency-free HTTP server over a real socket."""
    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    call = http_caller(srv.start())
    try:
        code, r = call("GET", "/health")
        assert code == 200 and r["success"]
        call("POST", "/vehicles/location", CAR_A)
        call("POST", "/vehicles/location", CAR_B)
        code, r = call("POST", "/detect", {})
        assert r["data"]["num_alerts"] == 1
        code, r = call("GET", "/alerts")
        assert len(r["data"]) == 1
        aid = r["data"][0]["id"]
        code, r = call("POST", f"/alerts/{aid}/acknowledge", {})
        assert r["success"]
        code, r = call("GET", "/vehicles/carA/location")
        assert r["data"]["position"]["x"] == 100.0
        code, r = call("GET", "/vehicles/nope/location")
        assert code == 404 and not r["success"]
        code, r = call("POST", "/vehicles/location", {"bogus": True})
        assert code == 400
        code, r = call("GET", "/stats")
        assert r["data"]["num_alive"] == 2
    finally:
        srv.stop()


def test_api_client_roundtrip():
    """ApiClient against the stdlib server over a real socket."""
    from tpu_collide_torch.api.rest import ApiClient

    sc = small_scene()
    srv = SceneHTTPServer(sc, port=0)
    client = ApiClient(f"http://127.0.0.1:{srv.start()}")

    async def go():
        assert (await client.health())["success"]
        assert (await client.update_location(CAR_A))["success"]
        await client.update_location(CAR_B)
        loc = await client.get_location("carA")
        assert loc["data"]["position"]["x"] == 100.0
        assert (await client.get_history("carA"))["success"]
        assert (await client.alerts())["success"]
        stats = await client.stats()
        assert stats["data"]["num_alive"] in (0, 2)   # pre/post flush
        return True

    try:
        assert asyncio.run(go())
    finally:
        srv.stop()


def test_route_core_grid_boundary_exact():
    """Exact cell membership for an object just across the cell boundary
    (a circumradius query would include the neighbour cell's)."""
    sc = small_scene()
    sc.ingest(LocationData("carA", Position(199.0, 150.0, 0), Vector()))
    sc.ingest(LocationData("carB", Position(201.0, 150.0, 0), Vector()))
    routes = RouteTable(sc)

    code, r = routes.handle("GET", "/grids/1_1/vehicles", None, {})
    assert code == 200 and r["data"] == ["carA"]
    code, r = routes.handle("GET", "/grids/2_1/vehicles", None, {})
    assert code == 200 and r["data"] == ["carB"]
    assert r["data"] == sc.grid_vehicles(2, 1)
    code, r = routes.handle("GET", "/grids/zzz/vehicles", None, {})
    assert code == 400


def test_fault_injection_reference_surface():
    """The reference FailureInjector's client surface round-trips against
    the stdlib server: node_failure, network_partition, high_load,
    slow_response, and POST /api/admin/reset-failures."""
    import time as _t

    srv = SceneHTTPServer(small_scene(), port=0)
    call = http_caller(srv.start())
    inj = "/api/admin/inject-failure"
    try:
        assert call("POST", inj, {"type": "node_failure",
                                  "node_id": "n1"})[0] == 200
        assert call("POST", inj, {"type": "network_partition",
                                  "node_ids": ["n2", "n3"]})[0] == 200
        assert call("POST", inj, {"type": "high_load",
                                  "duration": 1})[0] == 200
        st = call("GET", "/stats")[1]["data"]["faults"]
        assert st["partitioned_nodes"] == ["n2", "n3"]
        assert st["injected_total"] == 3

        assert call("POST", inj, {"type": "slow_response", "latency": 150,
                                  "duration": 5})[0] == 200
        t0 = _t.time()
        call("GET", "/health")
        assert _t.time() - t0 >= 0.12

        assert call("POST", "/api/admin/reset-failures", {})[0] == 200
        t0 = _t.time()
        call("GET", "/health")
        assert _t.time() - t0 < 0.1
        assert call("GET", "/stats")[1]["data"]["faults"][
            "partitioned_nodes"] == []
    finally:
        srv.stop()


def test_scene_step_zero_rejected():
    sc = small_scene()
    with pytest.raises(ValueError):
        sc.step(0)
    status, body = RouteTable(sc).handle("POST", "/step", {"steps": 0}, {})
    assert status == 400


def test_collision_system_integration(tmp_path):
    """Boot the whole node on the CPU, ingest, let the loops run (the
    detection loop finds the pair, the alert pump publishes it on the
    broker), read stats, stop."""
    async def go():
        sys_ = CollisionSystem(small_cfg(32), node_id="it-node",
                               checkpoint_dir=str(tmp_path),
                               detection_hz=20.0, device="cpu")
        heard = []

        async def on_alert(msg):
            heard.append(msg)

        sys_.broker.subscribe(TOPIC_ALERTS, on_alert)
        await sys_.start()
        try:
            sys_.scene.ingest(LocationData("carA", Position(100, 100, 0),
                                           Vector(10, 0, 0)))
            sys_.scene.ingest(LocationData("carB", Position(180, 100, 0),
                                           Vector(-10, 0, 0),
                                           heading=np.pi))
            assert await wait_for(lambda: heard)
            assert await wait_for(sys_.election.is_current_leader)
            return sys_.get_stats(), sys_.scene.alerts(), heard
        finally:
            await sys_.stop()

    stats, alerts, heard = asyncio.run(go())
    assert stats["scene"]["num_alive"] == 2
    assert stats["is_leader"]                      # single-node -> leader
    assert len(alerts) == 1
    assert stats["broker"]["published"] > 0        # alert egress flowed
    assert {heard[0].key, heard[0].value["other_vehicle_id"]} == \
        {"carA", "carB"}


def test_pump_burst_larger_than_the_broker_queue_drops_nothing():
    """One pump() publishes every due alert in a burst; with a broker queue
    of 16 messages, all 100 alerts still reach the subscriber, none
    dropped, the most urgent first."""
    from tpu_collide_torch.alerts.manager import AlertManager

    async def go():
        broker = MessageBroker(max_queue_size=16)
        heard = []

        async def on_alert(msg):
            heard.append(msg)

        broker.subscribe(TOPIC_ALERTS, on_alert)
        await broker.start()
        try:
            m = AlertManager(small_cfg(), broker=broker)
            for i in range(100):
                m._upsert(f"v{i}", "o", 0.5, 6.0, 9.0, i % 4)
            sent = await m.pump(now=100.0)
            assert await wait_for(lambda: len(heard) >= len(sent))
            return sent, heard, broker.get_stats()
        finally:
            await broker.stop()

    sent, heard, stats = asyncio.run(go())
    assert len(sent) == len(heard) == 100 and stats["dropped"] == 0
    assert [h.value["id"] for h in heard] == [a.id for a in sent]
    assert heard[0].value["priority"] == 3


# ---- the port case of tests/test_runtime.py --------------------------------

def test_collision_system_task_dispatch(tmp_path):
    """A task submitted through the system's scheduler reaches its own
    TaskWorker and runs: a checkpoint lands on disk, a detection task
    counts its alerts from the host batch Scene.detect returns."""
    async def go():
        sys_ = CollisionSystem(small_cfg(16), node_id="task-node",
                               checkpoint_dir=str(tmp_path),
                               detection_hz=0.1, device="cpu")
        results = []

        async def on_result(msg):
            results.append(msg.value)

        sys_.broker.subscribe("task-results", on_result)
        await sys_.start()
        try:
            sys_.scene.ingest(LocationData("carA", Position(100, 100, 0),
                                           Vector(10, 0, 0)))
            sys_.scene.ingest(LocationData("carB", Position(180, 100, 0),
                                           Vector(-10, 0, 0),
                                           heading=np.pi))
            await sys_.scheduler.submit_task(Task(
                task_id="t-ckpt", task_type="checkpoint", payload={}))
            await sys_.scheduler.submit_task(Task(
                task_id="t-det", task_type="collision_detection",
                payload={}))
            assert await wait_for(
                lambda: sys_.scheduler.get_stats()["completed"] >= 2)
            return (sys_.scheduler.get_stats(),
                    sys_.scene.ckpt.list_checkpoints(), results)
        finally:
            await sys_.stop()

    stats, ckpts, results = asyncio.run(go())
    assert stats["completed"] == 2 and stats["failed"] == 0
    assert len(ckpts) == 1          # the checkpoint task actually executed
    det = next(r for r in results if r["task_id"] == "t-det")
    assert det["success"] and det["result"] == {"num_alerts": 1}


# ---- the port case of tests/test_bridge.py ---------------------------------

def test_bridge_relays_and_does_not_echo():
    """Two brokers bridged over loopback TCP: a message crosses once, with
    its origin, and is not echoed back."""
    from tpu_collide_torch.runtime.bridge import BrokerBridge, ORIGIN_HEADER

    async def go():
        ba, bb = MessageBroker(), MessageBroker()
        got_a, got_b = [], []

        async def on_a(m):
            got_a.append(m)

        async def on_b(m):
            got_b.append(m)

        ba.subscribe(TOPIC_ALERTS, on_a)
        bb.subscribe(TOPIC_ALERTS, on_b)
        await ba.start()
        await bb.start()
        bra = BrokerBridge(ba, "host-a", listen=("127.0.0.1", 0))
        brb = None
        try:
            await bra.start()
            brb = BrokerBridge(bb, "host-b",
                               peers=[("127.0.0.1", bra.bound_port)])
            await brb.start()
            assert await wait_for(
                lambda: bra.get_stats()["links"] >= 1, timeout=10.0)
            await ba.publish(Message(topic=TOPIC_ALERTS, value={"n": 1}))
            assert await wait_for(lambda: len(got_b) >= 1, timeout=10.0)
            assert got_b[0].value == {"n": 1}
            assert got_b[0].headers[ORIGIN_HEADER] == "host-a"
            await bb.publish(Message(topic=TOPIC_ALERTS, value={"n": 2}))
            assert await wait_for(
                lambda: any(m.value == {"n": 2} for m in got_a),
                timeout=10.0)
            await asyncio.sleep(0.3)      # no echo storm
            assert len(got_a) == 2 and len(got_b) == 2
            assert bra.get_stats()["received"] == 1
            assert brb.get_stats()["received"] == 1
        finally:
            if brb is not None:
                await brb.stop()
            await bra.stop()
            await bb.stop()
            await ba.stop()

    asyncio.run(go())


# ---- no route converts a tensor through numpy ------------------------------

def test_no_route_converts_a_tensor_through_numpy(tmp_path, monkeypatch):
    """np.asarray of a CUDA tensor raises; on the CPU it would convert, and
    hide the fault. With Tensor.__array__ raising, every route of the port
    answers 200 on a fused CPU Scene (plain, pipelined and burst steps,
    detect, the queries, tasks, nodes, faults), and so does
    CollisionSystem._task_detect."""
    def refuse(self, *a, **k):
        raise TypeError("a tensor went through numpy")

    sys_ = CollisionSystem(small_cfg(), checkpoint_dir=str(tmp_path),
                           backend="fused", device="cpu")
    rt = RouteTable(sys_.scene, scheduler=sys_.scheduler)
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    with pytest.raises(TypeError):
        np.asarray(torch.zeros(2))
    calls = [
        ("GET", "/health", None, {}),
        ("POST", "/vehicles/location", CAR_A, {}),
        ("POST", "/vehicles/location", CAR_B, {}),
        ("POST", "/step", {}, {}),
        ("POST", "/step", {"pipelined": True}, {}),
        ("POST", "/step", {"pipelined": True, "steps": 2}, {}),
        ("POST", "/step", {"burst": True, "steps": 3}, {}),
        ("POST", "/step", {"steps": 2}, {}),
        ("POST", "/detect", {}, {}),
        ("GET", "/alerts", None, {"min_risk": "0.1"}),
        ("GET", "/vehicles/carA/location", None, {}),
        ("GET", "/vehicles/carA/history", None, {}),
        ("GET", "/vehicles/carA/risks", None, {}),
        ("GET", "/grids/1_1/vehicles", None, {}),
        ("GET", "/stats", None, {}),
        ("GET", "/api/collision/metrics", None, {}),
        ("POST", "/tasks", {"task_type": "checkpoint"}, {}),
        ("POST", "/nodes", {"node_id": "n9"}, {}),
        ("POST", "/nodes/n9/load", {"cpu_usage": 0.5}, {}),
        ("DELETE", "/nodes/n9", None, {}),
        ("POST", "/api/admin/inject-failure",
         {"type": "drop_objects", "fraction": 0.5}, {}),
        ("POST", "/api/admin/reset-failures", {}, {}),
    ]
    answers = {}
    for method, path, body, query in calls:
        code, payload = rt.handle(method, path, body, query)
        answers[(method, path, json.dumps(body))] = (code, payload)
        assert code == 200, (method, path, body, payload)
    step = answers[("POST", "/step", "{}")][1]["data"]
    assert step["num_alerts"] == step["num_risks"] == 2   # both directions
    assert answers[("POST", "/detect", "{}")][1]["data"] == {"num_alerts": 1}
    aid = answers[("GET", "/alerts", "null")][1]["data"][0]["id"]
    assert rt.handle("POST", f"/alerts/{aid}/acknowledge", None,
                     {})[0] == 200
    assert sys_._task_detect({}) == {"num_alerts": 0}   # one object left


def test_concurrent_requests_lose_no_report():
    """Eight threads (more than the cores a worker has) drive one route
    core at a shortened switch interval, as the HTTP server's threads do:
    reports of distinct vehicles interleaved with steps and detections.
    Every report lands in the fleet, every request is answered 200, and the
    steps are counted once each."""
    import sys
    import threading

    n_threads, per_thread = 8, 12
    sc = small_scene(n=n_threads * per_thread, backend="fused")
    rt = RouteTable(sc)
    codes, errors = [], []

    def worker(t):
        try:
            for i in range(per_thread):
                body = {"vehicle_id": f"t{t}-{i}",
                        "position": {"x": 20.0 + 40 * i, "y": 20.0 + 50 * t},
                        "velocity": {"x": 1.0}}
                codes.append(rt.handle("POST", "/vehicles/location", body,
                                       {})[0])
                if i % 4 == t % 4:
                    path = "/step" if t % 2 else "/detect"
                    codes.append(rt.handle("POST", path, {}, {})[0])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and set(codes) == {200}
    sc.flush()
    assert sc.ingested_count == sc.stats()["num_alive"] == \
        n_threads * per_thread
    steps = sum(per_thread // 4 for t in range(1, n_threads, 2))
    assert sc.step_count == steps


def test_detect_returns_a_host_batch():
    """Scene.detect returns the whole AlertBatch as numpy arrays, count
    included, as the JAX Scene returns its fetched batch."""
    sc = small_scene()
    sc.ingest(LocationData("carA", Position(100, 100, 0), Vector(10, 0, 0)))
    sc.ingest(LocationData("carB", Position(180, 100, 0), Vector(-10, 0, 0),
                           heading=np.pi))
    batch = sc.detect()
    assert all(isinstance(getattr(batch, f), np.ndarray)
               for f in ("vehicle_oid", "other_oid", "risk", "ttc",
                         "distance", "rel_speed", "priority", "col_pos",
                         "valid", "count"))
    assert int(batch.count) == int(batch.valid.sum()) == 1
    assert batch.col_pos.shape == (sc.cfg.alerts.max_scene_alerts, 3)


# ---- the slice against the JAX package -------------------------------------

N_PARITY = 96


def location_bodies(d):
    """One POST /vehicles/location body per object of a np_fleet."""
    out = []
    for i in range(len(d["pos"])):
        vec = lambda a: dict(zip("xyz", (float(v) for v in a[i])))
        out.append({"vehicle_id": f"v{i}", "position": vec(d["pos"]),
                    "velocity": vec(d["vel"]),
                    "acceleration": vec(d["acc"]),
                    "heading": float(d["heading"][i]),
                    "size": float(d["size"][i]),
                    "vehicle_type": VEHICLE_TYPES[int(d["otype"][i])],
                    "timestamp": 1.0})
    return out


def drive(routes, bodies):
    """The slice's requests; returns the answers of /detect, /step and
    /alerts."""
    for b in bodies:
        code, _ = routes.handle("POST", "/vehicles/location", b, {})
        assert code == 200
    answers = [routes.handle("POST", "/detect", {}, {}),
               routes.handle("POST", "/step", {}, {}),
               routes.handle("GET", "/alerts", None, {})]
    assert [code for code, _ in answers] == [200, 200, 200]
    return [payload["data"] for _, payload in answers]


def pair_values(alerts):
    """{(vehicle, other): (risk, ttc, priority)} of GET /alerts (the
    manager keeps one alert per ordered pair)."""
    out = {(a["vehicle_id"], a["other_vehicle_id"]):
           (a["risk_level"], a["time_to_collision"], a["priority"])
           for a in alerts}
    assert len(out) == len(alerts)
    return out


def message_fields(msg):
    """A TOPIC_ALERTS message without its id and timestamp (the message's
    and the alert's): {field: value}."""
    value = {k: v for k, v in msg.value.items()
             if k not in ("id", "timestamp")}
    return dict(topic=msg.topic, key=msg.key, headers=msg.headers, **value)


def test_service_against_jax():
    """The same seeded fleet and requests through the JAX route core and
    the port's, each over a fused Scene with a broker: equal alert counts
    from /detect and /step, equal risks, equal unordered alert pairs from
    GET /alerts (risk and ttc within 1e-5, the tolerance of
    tests/test_fused_kernel.py), and equal TOPIC_ALERTS messages after one
    pump, but for their ids and timestamps."""
    cfg = jax_cfg(N_PARITY)
    bodies = location_bodies(np_fleet(3, N_PARITY, 2000.0))

    async def go():
        jb, tb = JaxBroker(), MessageBroker()
        heard = {"jax": [], "port": []}
        for name, broker in (("jax", jb), ("port", tb)):
            async def on_alert(msg, name=name):
                heard[name].append(msg)
            broker.subscribe(TOPIC_ALERTS, on_alert)
            await broker.start()
        try:
            js = JaxScene(cfg, broker=jb, backend="fused", interpret=True)
            ts = Scene(to_torch_cfg(cfg), broker=tb, backend="fused",
                       device="cpu")
            want = drive(JaxRouteTable(js), bodies)
            got = drive(RouteTable(ts), bodies)
            sent = [len(await sc.alert_manager.pump(now=1e9))
                    for sc in (js, ts)]
            assert await wait_for(
                lambda: [len(heard["jax"]), len(heard["port"])] == sent)
            return want, got, sent, heard
        finally:
            await jb.stop()
            await tb.stop()

    want, got, sent, heard = asyncio.run(go())
    (jd, jstep, jal), (td, tstep, tal) = want, got
    assert td == jd and td["num_alerts"] > 0
    assert tstep["step_count"] == jstep["step_count"] == 1
    assert tstep["num_alerts"] == jstep["num_alerts"] > 0
    assert tstep["num_risks"] == jstep["num_risks"]
    # 2e-4: the JAX step reads max_risk from its quantised slot keys
    # (tests/test_fused_kernel.py:88)
    assert math.isclose(tstep["max_risk"], jstep["max_risk"], abs_tol=2e-4)

    jp, tp = pair_values(jal), pair_values(tal)
    unordered = lambda m: {frozenset(k) for k in m}
    assert unordered(tp) == unordered(jp) and len(tp) > 0
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k][:2], jp[k][:2], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
        assert tp[k][2] == jp[k][2], k

    assert sent[0] == sent[1] == len(jal)
    order = lambda m: (m["key"], m["other_vehicle_id"])
    jm = sorted((message_fields(m) for m in heard["jax"]), key=order)
    tm = sorted((message_fields(m) for m in heard["port"]), key=order)
    for a, b in zip(jm, tm):
        floats = ("risk_level", "time_to_collision")
        assert {k: v for k, v in b.items() if k not in floats} == \
            {k: v for k, v in a.items() if k not in floats}
        np.testing.assert_allclose([b[f] for f in floats],
                                   [a[f] for f in floats], rtol=1e-5,
                                   atol=1e-5)


# ---- sharding is refused ----------------------------------------------------

def test_sharded_config_is_refused():
    """The port has no sharded step: a config with more than one shard, and
    the --shards flags, raise instead of serving one shard."""
    from tpu_collide_torch.system import main

    cfg = small_cfg().replace(shard=ShardConfig(num_shards=2))
    with pytest.raises(NotImplementedError, match="Queue A items 7-8"):
        CollisionSystem(cfg, device="cpu")
    for flag in ("--shards", "--shards-y", "--shards-z"):
        with pytest.raises(NotImplementedError, match="ShardedScene"):
            main(["--objects", "16", "--device", "cpu", flag, "2"])


# ---- the entry point --------------------------------------------------------

def test_system_module_serves_and_exits_0_on_sigterm(tmp_path):
    """python -m tpu_collide_torch.system on the CPU, as chip_smoke.py
    starts it on the card: /health within a bounded wait, a location, POST
    /step, GET /alerts, then SIGTERM ends it with exit code 0."""
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    import time

    root = pathlib.Path(__file__).resolve().parents[1]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_collide_torch.system", "--device", "cpu",
         "--objects", "64", "--backend", "fused", "--api-port", str(port),
         "--checkpoint-dir", str(tmp_path), "--log-level", "WARNING"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    call = http_caller(port)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                assert call("GET", "/health")[0] == 200
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "no /health in 60 s"
                time.sleep(0.1)
        for body in (CAR_A, CAR_B):
            assert call("POST", "/vehicles/location", body)[0] == 200
        code, r = call("POST", "/step", {})
        assert code == 200 and r["data"]["num_alerts"] == 2
        code, r = call("GET", "/alerts")
        assert code == 200 and len(r["data"]) == 2
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        out = proc.stdout.read().decode()
        proc.stdout.close()
    assert rc == 0, out
