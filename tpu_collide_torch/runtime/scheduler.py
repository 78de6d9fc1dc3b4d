"""Host-side task scheduler (reference scheduler.py:15-432).

On TPU the per-step compute needs no task queue — it is one jitted program
(SURVEY.md §2.10 "task parallelism collapses into the step loop"). What
remains genuinely schedulable on the host is control-plane work: checkpoint
requests, re-tiling, batch queries, replay jobs, multi-host coordination.
This scheduler keeps the reference's surface — node registry, grid-affine
placement for detection tasks, least-loaded otherwise, priority ordering,
timeout cleanup — over the host broker.
"""
from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from tpu_collide_torch.core.types import LoadMetrics, NodeInfo, Task, TaskResult
from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.runtime.messaging import (MessageBroker, Message,
                                           TaskProducer, TaskResultProducer,
                                           TOPIC_TASKS, TOPIC_RESULTS)

logger = get_logger(__name__)


class Scheduler:
    """Node registry + task placement (reference scheduler.py:15-350)."""

    def __init__(self, broker: MessageBroker):
        self.broker = broker
        self.nodes: Dict[str, NodeInfo] = {}
        self.grid_nodes: Dict[str, List[str]] = {}     # grid -> node ids
        self.pending: List[Task] = []
        self.inflight: Dict[str, Task] = {}            # task_id -> task
        self._producer = TaskProducer(broker)
        self.running = False
        self._loop_task: Optional[asyncio.Task] = None
        self.stats = {"submitted": 0, "dispatched": 0, "completed": 0,
                      "failed": 0, "timed_out": 0}

    async def start(self) -> None:
        self.running = True
        self.broker.subscribe(TOPIC_RESULTS, self._handle_result)
        self._loop_task = asyncio.ensure_future(self._dispatch_loop())

    async def stop(self) -> None:
        self.running = False
        if self._loop_task:
            self._loop_task.cancel()
            try:
                await self._loop_task
            except (asyncio.CancelledError, Exception):
                pass

    # ---- node registry (reference :93-135) ----

    def register_node(self, node: NodeInfo) -> None:
        self.nodes[node.node_id] = node
        for gid in node.grid_ids:
            self.grid_nodes.setdefault(gid, []).append(node.node_id)

    def unregister_node(self, node_id: str) -> None:
        node = self.nodes.pop(node_id, None)
        if node:
            for gid in node.grid_ids:
                if node_id in self.grid_nodes.get(gid, []):
                    self.grid_nodes[gid].remove(node_id)

    def update_node_load(self, node_id: str, load: LoadMetrics) -> None:
        if node_id in self.nodes:
            self.nodes[node_id].load = load
            self.nodes[node_id].last_heartbeat = time.time()

    # ---- task submission (reference :149-255) ----

    async def submit_task(self, task: Task) -> str:
        return self.submit_task_nowait(task)

    def submit_task_nowait(self, task: Task) -> str:
        """Sync submission (thread-safe enough: list.append is atomic);
        the dispatch loop picks it up within one poll interval. Used by the
        shared HTTP route core, which runs handlers off the event loop."""
        self.stats["submitted"] += 1
        self.pending.append(task)
        return task.task_id

    def _select_node(self, task: Task) -> Optional[str]:
        """Grid-affine for detection tasks (reference :170-213), else
        least-loaded (:215-232)."""
        active = {nid: n for nid, n in self.nodes.items()
                  if n.status == "active"}
        if not active:
            return None
        if task.task_type == "collision_detection" and task.grid_id:
            affine = [nid for nid in self.grid_nodes.get(task.grid_id, [])
                      if nid in active]
            if affine:
                return min(affine, key=lambda nid: active[nid].load.cpu_usage)
        return min(active, key=lambda nid: active[nid].load.cpu_usage)

    async def _dispatch_loop(self) -> None:
        """Priority dispatch + timeout cleanup (reference :279-350)."""
        while self.running:
            try:
                if self.pending:
                    self.pending.sort(key=lambda t: (-t.priority, t.created_at))
                    still = []
                    for task in self.pending:
                        nid = self._select_node(task)
                        if nid is None:
                            still.append(task)
                            continue
                        await self._producer.send_task({
                            "task_id": task.task_id,
                            "task_type": task.task_type,
                            "payload": task.payload,
                            "priority": task.priority,
                            "grid_id": task.grid_id,
                            "node_id": nid,
                            "created_at": task.created_at,
                            "timeout_s": task.timeout_s,
                        })
                        self.inflight[task.task_id] = task
                        self.stats["dispatched"] += 1
                    self.pending = still
                now = time.time()
                for tid in [tid for tid, t in self.inflight.items()
                            if now - t.created_at > t.timeout_s]:
                    self.inflight.pop(tid)
                    self.stats["timed_out"] += 1
                await asyncio.sleep(0.05)
            except asyncio.CancelledError:
                break
            except Exception as e:  # noqa: BLE001
                logger.error("scheduler loop error: %s", e)
                await asyncio.sleep(0.5)

    async def _handle_result(self, msg: Message) -> None:
        tid = (msg.value or {}).get("task_id")
        if tid in self.inflight:
            self.inflight.pop(tid)
            if (msg.value or {}).get("success", True):
                self.stats["completed"] += 1
            else:
                self.stats["failed"] += 1

    def get_stats(self) -> Dict[str, Any]:
        return {**self.stats, "nodes": len(self.nodes),
                "pending": len(self.pending), "inflight": len(self.inflight)}


class SchedulerClient:
    """Submit tasks + per-task result callbacks (reference
    scheduler.py:353-432)."""

    def __init__(self, broker: MessageBroker, scheduler: Scheduler):
        self.broker = broker
        self.scheduler = scheduler
        self._callbacks: Dict[str, Callable[[dict], Any]] = {}
        broker.subscribe(TOPIC_RESULTS, self._on_result)

    async def submit(self, task_type: str, payload: dict, priority: int = 0,
                     grid_id: Optional[str] = None, timeout_s: float = 30.0,
                     callback: Optional[Callable[[dict], Any]] = None) -> str:
        task = Task(task_id=f"task-{uuid.uuid4()}", task_type=task_type,
                    payload=payload, priority=priority, grid_id=grid_id,
                    timeout_s=timeout_s)
        if callback:
            self._callbacks[task.task_id] = callback
        return await self.scheduler.submit_task(task)

    async def _on_result(self, msg: Message) -> None:
        tid = (msg.value or {}).get("task_id")
        cb = self._callbacks.pop(tid, None)
        if cb:
            r = cb(msg.value)
            if asyncio.iscoroutine(r):
                await r


class TaskWorker:
    """Executes dispatched tasks addressed to this node — the ComputeNode
    task-handling role (reference compute_node.py:435-508) with the actual
    compute delegated to registered handlers (which call the device)."""

    def __init__(self, broker: MessageBroker, node_id: str):
        self.broker = broker
        self.node_id = node_id
        self._handlers: Dict[str, Callable[[dict], Any]] = {}
        self._results = TaskResultProducer(broker)
        broker.subscribe(TOPIC_TASKS, self._on_task)
        self.stats = {"handled": 0, "errors": 0}

    def register_handler(self, task_type: str,
                         handler: Callable[[dict], Any]) -> None:
        self._handlers[task_type] = handler

    async def _on_task(self, msg: Message) -> None:
        v = msg.value or {}
        if v.get("node_id") not in (None, self.node_id):
            return
        handler = self._handlers.get(v.get("task_type"))
        t0 = time.perf_counter()
        try:
            result = handler(v.get("payload", {})) if handler else None
            if asyncio.iscoroutine(result):
                result = await result
            ok, err = True, None
            self.stats["handled"] += 1
        except Exception as e:  # noqa: BLE001
            ok, err, result = False, str(e), None
            self.stats["errors"] += 1
        await self._results.send_result({
            "task_id": v.get("task_id"), "node_id": self.node_id,
            "success": ok, "result": result, "error": err,
            "processing_time_ms": (time.perf_counter() - t0) * 1e3})
