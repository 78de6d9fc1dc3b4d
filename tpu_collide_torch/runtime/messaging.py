"""Host-side async pub/sub — ingest/egress plumbing around the device step.

Mirrors the reference's messaging surface (messaging.py:15-405: Message,
MessageBroker, MessageProducer/Consumer, typed producers and their topics) so
reference users find the same API. Architectural difference: in the reference
the broker IS the data plane between compute stages (SURVEY.md §2.11); here
all intra-step communication is XLA collectives on device, and this broker
only moves data between host-side components (REST ingest -> Scene, alert
egress -> subscribers). Dispatch is event-driven (one task per topic blocking
on its queue) instead of the reference's 1 ms polling loop
(messaging.py:161-182) — no idle spin.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import time
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional

from tpu_collide_torch.core.utils import get_logger, RateLimiter

logger = get_logger(__name__)

# Topic names kept from the reference so integrations translate 1:1
# (messaging.py:323,353,382; warning_system.py:71,576; data_sharding.py:53,618;
#  high_availability.py:35,242,632; disaster_recovery.py:282,542;
#  failover_throttling.py:32)
TOPIC_LOCATIONS = "vehicle-locations"
TOPIC_POSITIONS = "vehicle-positions"
TOPIC_TASKS = "computation-tasks"
TOPIC_RESULTS = "task-results"
TOPIC_ALERTS = "alerts"
TOPIC_SHARD_MGMT = "shard-management"
TOPIC_LOAD_BALANCING = "load-balancing"
TOPIC_HEARTBEATS = "node-heartbeats"
TOPIC_ELECTION = "leader-election"
TOPIC_REPLICATION = "data-replication"
TOPIC_STATE_TRANSFER = "state-transfer"
TOPIC_RECOVERY = "recovery-coordination"
TOPIC_FAILOVER = "failover-events"


@dataclasses.dataclass
class Message:
    """Envelope (reference messaging.py:15-67)."""
    topic: str
    value: Any
    key: Optional[str] = None
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    id: str = dataclasses.field(default_factory=lambda: str(uuid.uuid4()))
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Message":
        return cls(**d)

    def serialize(self) -> bytes:
        return json.dumps(self.to_dict(), default=str).encode()

    @classmethod
    def deserialize(cls, raw: bytes) -> "Message":
        return cls.from_dict(json.loads(raw.decode()))


Callback = Callable[[Message], Awaitable[None]]


class MessageBroker:
    """In-process topic broker (reference messaging.py:70-182).

    publish() never blocks the caller: full queues drop-oldest and count the
    drop (the reference's put_nowait simply raised through to a log)."""

    def __init__(self, max_queue_size: int = 10_000):
        self.max_queue_size = max_queue_size
        self._queues: Dict[str, asyncio.Queue] = {}
        self._subscribers: Dict[str, List[Callback]] = {}
        self._tasks: Dict[str, asyncio.Task] = {}
        self.running = False
        self.stats = {"published": 0, "delivered": 0, "dropped": 0,
                      "callback_errors": 0}

    async def start(self) -> None:
        self.running = True
        # backfill dispatch loops for topics subscribed before start()
        # (components register handlers in __init__, before the system
        # brings the broker up)
        for topic in self._queues:
            if topic not in self._tasks:
                self._tasks[topic] = asyncio.ensure_future(
                    self._dispatch_loop(topic))
        logger.info("message broker started")

    async def stop(self) -> None:
        self.running = False
        for t in self._tasks.values():
            t.cancel()
        for t in self._tasks.values():
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        logger.info("message broker stopped")

    def _ensure_topic(self, topic: str) -> asyncio.Queue:
        if topic not in self._queues:
            self._queues[topic] = asyncio.Queue(maxsize=self.max_queue_size)
            self._subscribers.setdefault(topic, [])
            if self.running:
                self._tasks[topic] = asyncio.ensure_future(
                    self._dispatch_loop(topic))
        return self._queues[topic]

    async def publish(self, message: Message) -> bool:
        q = self._ensure_topic(message.topic)
        if not self.running:
            return False
        self.stats["published"] += 1
        try:
            q.put_nowait(message)
        except asyncio.QueueFull:
            try:
                q.get_nowait()          # drop oldest
                self.stats["dropped"] += 1
                q.put_nowait(message)
            except asyncio.QueueEmpty:
                pass
        return True

    def subscribe(self, topic: str, callback: Callback) -> None:
        self._ensure_topic(topic)
        self._subscribers[topic].append(callback)
        if self.running and topic not in self._tasks:
            self._tasks[topic] = asyncio.ensure_future(
                self._dispatch_loop(topic))

    def unsubscribe(self, topic: str, callback: Callback) -> None:
        if topic in self._subscribers:
            try:
                self._subscribers[topic].remove(callback)
            except ValueError:
                pass

    async def _dispatch_loop(self, topic: str) -> None:
        q = self._queues[topic]
        while self.running:
            msg = await q.get()
            for cb in list(self._subscribers.get(topic, [])):
                try:
                    await cb(msg)
                    self.stats["delivered"] += 1
                except Exception as e:  # noqa: BLE001
                    self.stats["callback_errors"] += 1
                    logger.error("subscriber error on %s: %s", topic, e)

    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats,
                "topics": {t: q.qsize() for t, q in self._queues.items()}}


class MessageProducer:
    """Rate-limited producer (reference messaging.py:185-231, 10k msg/s
    token bucket :198)."""

    def __init__(self, broker: MessageBroker, rate_limit: float = 10_000.0):
        self.broker = broker
        self.rate_limiter = RateLimiter(rate_limit)
        self.stats = {"sent": 0, "throttled": 0}

    async def send(self, topic: str, value: Any, key: Optional[str] = None,
                   headers: Optional[Dict[str, str]] = None) -> bool:
        if not self.rate_limiter.allow():
            self.stats["throttled"] += 1
            return False
        ok = await self.broker.publish(
            Message(topic=topic, value=value, key=key, headers=headers or {}))
        if ok:
            self.stats["sent"] += 1
        return ok


class MessageConsumer:
    """Consumer-group facade (reference messaging.py:234-317; offsets were
    cosmetic there and remain so here)."""

    def __init__(self, broker: MessageBroker, group_id: str = "default"):
        self.broker = broker
        self.group_id = group_id
        self._handlers: Dict[str, List[Callback]] = {}
        self.running = False

    async def start(self) -> None:
        self.running = True

    async def stop(self) -> None:
        self.running = False
        for topic, cbs in self._handlers.items():
            for cb in cbs:
                self.broker.unsubscribe(topic, cb)

    def on_message(self, topic: str, handler: Callback) -> None:
        self._handlers.setdefault(topic, []).append(handler)
        self.broker.subscribe(topic, handler)

    async def commit(self) -> None:     # parity no-op (messaging.py:314-317)
        return None


class LocationDataProducer(MessageProducer):
    """reference messaging.py:320-347"""

    async def send_location(self, location) -> bool:
        d = location.to_dict() if hasattr(location, "to_dict") else location
        return await self.send(TOPIC_LOCATIONS, d,
                               key=d.get("vehicle_id"))


class TaskProducer(MessageProducer):
    """reference messaging.py:350-376"""

    async def send_task(self, task) -> bool:
        d = dataclasses.asdict(task) if dataclasses.is_dataclass(task) else task
        return await self.send(TOPIC_TASKS, d, key=d.get("task_id"))


class TaskResultProducer(MessageProducer):
    """reference messaging.py:379-405"""

    async def send_result(self, result) -> bool:
        d = (dataclasses.asdict(result)
             if dataclasses.is_dataclass(result) else result)
        return await self.send(TOPIC_RESULTS, d, key=d.get("task_id"))
