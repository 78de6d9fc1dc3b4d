"""Host-process reliability: heartbeats, leader election, replication,
failover, throttling.

Covers the reference's reliability layer surface (high_availability.py:
17-895, failover_throttling.py:17-803 — SURVEY.md §2.7). Role in the TPU
build: the DEVICE failure story is checkpoint/restore (ckpt/); these
primitives coordinate multiple HOST processes (ingest frontends, bench
drivers, multi-host controllers) sharing one broker. Deviations:
FailoverManager reassigns resources to the least-loaded survivor instead of
a random one (failover_throttling.py:192-246) — determinism over dice.
"""
from __future__ import annotations

import asyncio
import random
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_collide_torch.core.utils import RateLimiter, CircuitBreaker, get_logger
from tpu_collide_torch.runtime.messaging import (MessageBroker, Message,
                                           TOPIC_HEARTBEATS, TOPIC_ELECTION,
                                           TOPIC_REPLICATION, TOPIC_FAILOVER)

logger = get_logger(__name__)


class HeartbeatMonitor:
    """Heartbeats on `node-heartbeats`; a node missing `max_missed`
    intervals is failed (reference high_availability.py:17-221: 5 s
    interval, 3 misses)."""

    ACTIVE, SUSPECTED, FAILED = "active", "suspected", "failed"

    def __init__(self, broker: MessageBroker, node_id: str,
                 interval: float = 5.0, max_missed: int = 3):
        self.broker = broker
        self.node_id = node_id
        self.interval = interval
        self.max_missed = max_missed
        self.nodes: Dict[str, float] = {}          # node -> last beat
        self.status: Dict[str, str] = {}
        self._failure_cbs: List[Callable[[str], Any]] = []
        self._recovery_cbs: List[Callable[[str], Any]] = []
        self.running = False
        self._tasks: List[asyncio.Task] = []

    async def start(self) -> None:
        self.running = True
        self.broker.subscribe(TOPIC_HEARTBEATS, self._on_heartbeat)
        self._tasks = [asyncio.ensure_future(self._beat_loop()),
                       asyncio.ensure_future(self._check_loop())]

    async def stop(self) -> None:
        self.running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def on_node_failure(self, cb: Callable[[str], Any]) -> None:
        self._failure_cbs.append(cb)

    def on_node_recovery(self, cb: Callable[[str], Any]) -> None:
        self._recovery_cbs.append(cb)

    async def send_heartbeat(self) -> None:
        await self.broker.publish(Message(
            topic=TOPIC_HEARTBEATS, key=self.node_id,
            value={"node_id": self.node_id, "timestamp": time.time()}))

    async def _on_heartbeat(self, msg: Message) -> None:
        nid = (msg.value or {}).get("node_id")
        if not nid:
            return
        was = self.status.get(nid)
        self.nodes[nid] = time.monotonic()
        self.status[nid] = self.ACTIVE
        if was == self.FAILED:
            for cb in self._recovery_cbs:
                await _maybe_await(cb(nid))

    async def _beat_loop(self) -> None:
        while self.running:
            await self.send_heartbeat()
            await asyncio.sleep(self.interval)

    async def _check_loop(self) -> None:
        while self.running:
            now = time.monotonic()
            for nid, last in list(self.nodes.items()):
                if nid == self.node_id:
                    continue
                missed = (now - last) / self.interval
                if missed >= self.max_missed:
                    if self.status.get(nid) != self.FAILED:
                        self.status[nid] = self.FAILED
                        logger.warning("node %s failed (%d missed beats)",
                                       nid, int(missed))
                        for cb in self._failure_cbs:
                            await _maybe_await(cb(nid))
                elif missed >= 1.5:
                    if self.status.get(nid) == self.ACTIVE:
                        self.status[nid] = self.SUSPECTED
            await asyncio.sleep(self.interval / 2)


class LeaderElection:
    """Raft-style term voting over the broker (reference
    high_availability.py:224-611): randomized election timeout, majority of
    known_nodes, leader heartbeat at timeout/2, step-down on higher term."""

    FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

    def __init__(self, broker: MessageBroker, node_id: str,
                 known_nodes: List[str], timeout_range: Tuple[float, float]
                 = (1.5, 3.0)):
        self.broker = broker
        self.node_id = node_id
        self.known_nodes = list(known_nodes)
        self.timeout_range = timeout_range
        self.term = 0
        self.voted_for: Optional[str] = None
        self.role = self.FOLLOWER
        self.leader_id: Optional[str] = None
        self._votes: set = set()
        self._last_leader_beat = time.monotonic()
        self._become_leader_cbs: List[Callable[[], Any]] = []
        self._lose_leader_cbs: List[Callable[[], Any]] = []
        self.running = False
        self._tasks: List[asyncio.Task] = []

    def is_current_leader(self) -> bool:
        return self.role == self.LEADER

    def on_become_leader(self, cb: Callable[[], Any]) -> None:
        self._become_leader_cbs.append(cb)

    def on_lose_leadership(self, cb: Callable[[], Any]) -> None:
        self._lose_leader_cbs.append(cb)

    async def start(self) -> None:
        self.running = True
        self.broker.subscribe(TOPIC_ELECTION, self._on_message)
        self._tasks = [asyncio.ensure_future(self._election_loop())]

    async def stop(self) -> None:
        self.running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

    def _timeout(self) -> float:
        return random.uniform(*self.timeout_range)

    async def _election_loop(self) -> None:
        while self.running:
            if self.role == self.LEADER:
                await self._publish({"type": "leader_heartbeat"})
                await asyncio.sleep(self.timeout_range[0] / 2)
            else:
                wait = self._timeout()
                await asyncio.sleep(wait)
                if (time.monotonic() - self._last_leader_beat) > wait:
                    await self._start_election()

    async def _start_election(self) -> None:
        self.term += 1
        self.role = self.CANDIDATE
        self.voted_for = self.node_id
        self._votes = {self.node_id}
        await self._publish({"type": "vote_request"})
        await asyncio.sleep(self.timeout_range[0] / 2)
        if (self.role == self.CANDIDATE
                and len(self._votes) > len(self.known_nodes) // 2):
            await self._become_leader()

    async def _become_leader(self) -> None:
        self.role = self.LEADER
        self.leader_id = self.node_id
        logger.info("node %s is leader for term %d", self.node_id, self.term)
        await self._publish({"type": "leader_heartbeat"})
        for cb in self._become_leader_cbs:
            await _maybe_await(cb())

    async def _publish(self, extra: dict) -> None:
        await self.broker.publish(Message(
            topic=TOPIC_ELECTION, key=self.node_id,
            value={"node_id": self.node_id, "term": self.term, **extra}))

    async def _on_message(self, msg: Message) -> None:
        v = msg.value or {}
        nid, term, typ = v.get("node_id"), v.get("term", 0), v.get("type")
        if nid == self.node_id:
            return
        if term > self.term:                       # step down (:504-535)
            was_leader = self.role == self.LEADER
            self.term, self.role, self.voted_for = term, self.FOLLOWER, None
            if was_leader:
                for cb in self._lose_leader_cbs:
                    await _maybe_await(cb())
        if typ == "vote_request" and term >= self.term:
            if self.voted_for in (None, nid):
                self.voted_for = nid
                await self._publish({"type": "vote_response", "grant_to": nid})
        elif typ == "vote_response" and v.get("grant_to") == self.node_id \
                and term == self.term and self.role == self.CANDIDATE:
            self._votes.add(nid)
            if len(self._votes) > len(self.known_nodes) // 2:
                await self._become_leader()
        elif typ == "leader_heartbeat":
            self._last_leader_beat = time.monotonic()
            self.leader_id = nid
            if self.role == self.CANDIDATE and term >= self.term:
                self.role = self.FOLLOWER


class ReplicationManager:
    """Replicated host KV: last-writer-wins by timestamp; the leader
    re-broadcasts all keys periodically (reference
    high_availability.py:614-895)."""

    def __init__(self, broker: MessageBroker, node_id: str,
                 rebroadcast_interval: float = 10.0):
        self.broker = broker
        self.node_id = node_id
        self.rebroadcast_interval = rebroadcast_interval
        self._data: Dict[str, Tuple[Any, float]] = {}     # key -> (val, ts)
        self.is_leader_fn: Callable[[], bool] = lambda: False
        self.running = False
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self.running = True
        self.broker.subscribe(TOPIC_REPLICATION, self._on_replicate)
        self._task = asyncio.ensure_future(self._rebroadcast_loop())

    async def stop(self) -> None:
        self.running = False
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    async def store_data(self, key: str, value: Any) -> None:
        ts = time.time()
        self._data[key] = (value, ts)
        await self.broker.publish(Message(
            topic=TOPIC_REPLICATION, key=key,
            value={"key": key, "value": value, "ts": ts,
                   "from": self.node_id}))

    def get_data(self, key: str) -> Optional[Any]:
        v = self._data.get(key)
        return v[0] if v else None

    async def _on_replicate(self, msg: Message) -> None:
        v = msg.value or {}
        if v.get("from") == self.node_id:
            return
        key, ts = v.get("key"), v.get("ts", 0.0)
        cur = self._data.get(key)
        if cur is None or ts >= cur[1]:           # LWW (:835-878)
            self._data[key] = (v.get("value"), ts)

    async def _rebroadcast_loop(self) -> None:
        while self.running:
            await asyncio.sleep(self.rebroadcast_interval)
            if self.is_leader_fn():
                for key, (value, ts) in list(self._data.items()):
                    await self.broker.publish(Message(
                        topic=TOPIC_REPLICATION, key=key,
                        value={"key": key, "value": value, "ts": ts,
                               "from": self.node_id}))


class FailoverManager:
    """Resource -> node assignment with reassignment on failure (reference
    failover_throttling.py:17-427). Reassignment is deterministic
    least-loaded instead of random (DEVIATION, see module docstring)."""

    def __init__(self, broker: MessageBroker, node_id: str):
        self.broker = broker
        self.node_id = node_id
        self.assignments: Dict[str, str] = {}     # resource -> node
        self.node_load: Dict[str, float] = {}
        self._handlers: Dict[str, Tuple[Callable[[str], Any],
                                        Callable[[str], Any]]] = {}
        self.stats = {"failovers": 0}

    def register_resource_handler(self, resource_type: str,
                                  takeover: Callable[[str], Any],
                                  release: Callable[[str], Any]) -> None:
        self._handlers[resource_type] = (takeover, release)

    def assign(self, resource: str, node_id: str) -> None:
        self.assignments[resource] = node_id

    def update_node_load(self, node_id: str, load: float) -> None:
        self.node_load[node_id] = load

    async def handle_node_failure(self, failed_node: str,
                                  survivors: List[str]) -> Dict[str, str]:
        """Reassign every resource owned by `failed_node`."""
        moved = {}
        candidates = [n for n in survivors if n != failed_node]
        if not candidates:
            return moved
        for resource, owner in list(self.assignments.items()):
            if owner != failed_node:
                continue
            new_owner = min(candidates,
                            key=lambda n: self.node_load.get(n, 0.0))
            self.assignments[resource] = new_owner
            moved[resource] = new_owner
            self.stats["failovers"] += 1
            rtype = resource.split(":", 1)[0]
            if new_owner == self.node_id and rtype in self._handlers:
                await _maybe_await(self._handlers[rtype][0](resource))
            await self.broker.publish(Message(
                topic=TOPIC_FAILOVER, key=resource,
                value={"resource": resource, "from": failed_node,
                       "to": new_owner}))
        return moved


class ThrottlingPolicy:
    """Rule list: predicate -> rate limit (reference
    failover_throttling.py:618-692)."""

    def __init__(self):
        self.rules: List[Tuple[Callable[[dict], bool], float, int]] = []

    def add_rule(self, condition: Callable[[dict], bool], rate: float,
                 min_priority: int = 0) -> None:
        self.rules.append((condition, rate, min_priority))

    def apply(self, request: dict) -> Optional[Tuple[float, int]]:
        for cond, rate, prio in self.rules:
            if cond(request):
                return rate, prio
        return None


class ThrottlingManager:
    """Global + per-endpoint + per-client rate limits with per-endpoint
    circuit breakers (reference failover_throttling.py:430-615: global
    10k req/s)."""

    def __init__(self, global_rate: float = 10_000.0):
        self.global_limiter = RateLimiter(global_rate)
        self.endpoint_limiters: Dict[str, RateLimiter] = {}
        self.client_limiters: Dict[str, RateLimiter] = {}
        self.breakers: Dict[str, CircuitBreaker] = {}
        self.policy = ThrottlingPolicy()
        self.stats = {"allowed": 0, "throttled": 0, "broken": 0}

    def set_endpoint_limit(self, endpoint: str, rate: float) -> None:
        self.endpoint_limiters[endpoint] = RateLimiter(rate)

    def set_client_limit(self, client: str, rate: float) -> None:
        self.client_limiters[client] = RateLimiter(rate)

    def breaker_for(self, endpoint: str) -> CircuitBreaker:
        if endpoint not in self.breakers:
            self.breakers[endpoint] = CircuitBreaker()
        return self.breakers[endpoint]

    def allow_request(self, endpoint: str, client: Optional[str] = None,
                      request: Optional[dict] = None) -> bool:
        if not self.breaker_for(endpoint).allow():
            self.stats["broken"] += 1
            return False
        pol = self.policy.apply(request or {"endpoint": endpoint,
                                            "client": client})
        if pol is not None:
            rate, _ = pol
            self.endpoint_limiters.setdefault(endpoint, RateLimiter(rate))
        for lim in (self.global_limiter,
                    self.endpoint_limiters.get(endpoint),
                    self.client_limiters.get(client) if client else None):
            if lim is not None and not lim.allow():
                self.stats["throttled"] += 1
                return False
        self.stats["allowed"] += 1
        return True


class AdaptiveThrottling:
    """Scale endpoint rates with load: cpu > 0.8 -> x0.8 (floor 10);
    cpu < 0.5 -> x1.1 (cap 10k). Reference failover_throttling.py:695-803."""

    def __init__(self, manager: ThrottlingManager,
                 load_fn: Callable[[], float], interval: float = 10.0):
        self.manager = manager
        self.load_fn = load_fn
        self.interval = interval
        self.running = False
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self.running = True
        self._task = asyncio.ensure_future(self._loop())

    async def stop(self) -> None:
        self.running = False
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    def adjust_once(self) -> None:
        cpu = self.load_fn()
        for lim in self.manager.endpoint_limiters.values():
            if cpu > 0.8:
                lim.set_rate(max(10.0, lim.rate * 0.8))
            elif cpu < 0.5:
                lim.set_rate(min(10_000.0, lim.rate * 1.1))

    async def _loop(self) -> None:
        while self.running:
            await asyncio.sleep(self.interval)
            self.adjust_once()


async def _maybe_await(x):
    if asyncio.iscoroutine(x):
        return await x
    return x


class StateTransferManager:
    """Node-to-node state transfer over the broker (reference
    disaster_recovery.py:267-519): providers register (get_state,
    apply_state) pairs; `request_state` pulls a named state from a peer."""

    def __init__(self, broker: MessageBroker, node_id: str):
        from tpu_collide_torch.runtime.messaging import TOPIC_STATE_TRANSFER
        self.broker = broker
        self.node_id = node_id
        self._topic = TOPIC_STATE_TRANSFER
        self._providers: Dict[str, Tuple[Callable[[], Any],
                                         Callable[[Any], None]]] = {}
        self._pending: Dict[str, asyncio.Future] = {}
        broker.subscribe(self._topic, self._on_message)

    def register_provider(self, name: str, get_state: Callable[[], Any],
                          apply_state: Callable[[Any], None]) -> None:
        self._providers[name] = (get_state, apply_state)

    async def request_state(self, name: str, from_node: str,
                            timeout: float = 5.0,
                            apply: bool = True) -> Any:
        rid = str(uuid.uuid4())
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        await self.broker.publish(Message(
            topic=self._topic, key=rid,
            value={"type": "request", "request_id": rid, "name": name,
                   "from": self.node_id, "to": from_node}))
        try:
            state = await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)
        if apply and name in self._providers:
            self._providers[name][1](state)
        return state

    async def _on_message(self, msg: Message) -> None:
        v = msg.value or {}
        if v.get("type") == "request" and v.get("to") == self.node_id:
            name = v.get("name")
            if name in self._providers:
                await self.broker.publish(Message(
                    topic=self._topic, key=v["request_id"],
                    value={"type": "response",
                           "request_id": v["request_id"],
                           "name": name, "from": self.node_id,
                           "to": v.get("from"),
                           "state": self._providers[name][0]()}))
        elif v.get("type") == "response" and v.get("to") == self.node_id:
            fut = self._pending.get(v.get("request_id"))
            if fut and not fut.done():
                fut.set_result(v.get("state"))


class RecoveryCoordinator:
    """Named recovery handlers invoked via broker messages with status
    reporting (reference disaster_recovery.py:522-752)."""

    STARTING, COMPLETED, FAILED = "starting", "completed", "failed"

    def __init__(self, broker: MessageBroker, node_id: str):
        from tpu_collide_torch.runtime.messaging import TOPIC_RECOVERY
        self.broker = broker
        self.node_id = node_id
        self._topic = TOPIC_RECOVERY
        self._handlers: Dict[str, Callable[[dict], Any]] = {}
        self.recoveries: Dict[str, str] = {}      # recovery_id -> status
        broker.subscribe(self._topic, self._on_message)

    def register_handler(self, name: str,
                         handler: Callable[[dict], Any]) -> None:
        self._handlers[name] = handler

    async def initiate_recovery(self, name: str,
                                payload: Optional[dict] = None) -> str:
        rid = f"recovery-{uuid.uuid4()}"
        await self.broker.publish(Message(
            topic=self._topic, key=rid,
            value={"type": "execute", "recovery_id": rid, "name": name,
                   "payload": payload or {}, "from": self.node_id}))
        return rid

    async def _report(self, rid: str, status: str,
                      error: Optional[str] = None) -> None:
        self.recoveries[rid] = status
        await self.broker.publish(Message(
            topic=self._topic, key=rid,
            value={"type": "status", "recovery_id": rid, "status": status,
                   "error": error, "from": self.node_id}))

    async def _on_message(self, msg: Message) -> None:
        v = msg.value or {}
        if v.get("type") == "execute":
            name = v.get("name")
            rid = v.get("recovery_id")
            handler = self._handlers.get(name)
            if handler is None:
                return
            await self._report(rid, self.STARTING)
            try:
                await _maybe_await(handler(v.get("payload", {})))
                await self._report(rid, self.COMPLETED)
            except Exception as e:  # noqa: BLE001
                logger.error("recovery %s failed: %s", rid, e)
                await self._report(rid, self.FAILED, str(e))
        elif v.get("type") == "status" and v.get("from") != self.node_id:
            self.recoveries[v.get("recovery_id")] = v.get("status")
