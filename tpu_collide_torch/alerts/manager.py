"""Host-side alert lifecycle — the AlertManager / EarlyWarningSystem analog
(reference warning_system.py:48-727).

The device step emits a deduplicated, priority-sorted AlertBatch each step
(alerts/extract.py). This manager consumes those batches on the host and
provides the reference's stateful alert semantics: create-or-update per
(vehicle, other) pair (:120-197, 259-285), human-readable messages by
severity (:313-329), acknowledge (:347-369), expiry after 30 s or on ack
(:490-517), unacked re-send with a 0.5 s backoff (:403-435), per-vehicle
callback registry (:235-257, 463-488), and stats by priority (:519-549).
Messages are English rather than the reference's Chinese templates, same
fields interpolated.

The port of tpu_collide/alerts/manager.py: process_batch takes a torch
AlertBatch in one device-to-host copy, and alerts leave through the
callbacks only (the JAX package's broker egress rides its runtime, which
the port does not have yet).
"""
from __future__ import annotations

import asyncio
import heapq
import itertools
import threading
import time
import uuid
from typing import Any, Awaitable, Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_collide_torch.alerts.extract import compute_priority
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import to_host
from tpu_collide_torch.core.types import Alert
from tpu_collide_torch.core.utils import get_logger

logger = get_logger(__name__)

AlertCallback = Callable[[Alert], Any]


def _message_for(risk: float, ttc: float, other: str, dist: float,
                 cfg: SystemConfig) -> str:
    """Severity-templated message (reference warning_system.py:313-329)."""
    if risk >= cfg.alerts.risk_high:
        return (f"EMERGENCY: possible collision with vehicle {other} in "
                f"{ttc:.1f} s (distance {dist:.1f} m) — take evasive "
                f"action immediately!")
    if risk >= cfg.alerts.risk_medium:
        return (f"WARNING: possible collision with vehicle {other} in "
                f"{ttc:.1f} s (distance {dist:.1f} m) — please yield.")
    return (f"NOTICE: vehicle {other} is close ({dist:.1f} m) — keep a "
            f"safe distance.")


class AlertManager:
    """Stateful alert registry fed by device AlertBatches."""

    def __init__(self, cfg: SystemConfig, broker=None):
        if broker is not None:
            raise ValueError("the port has no message broker yet: alerts "
                             "leave through register_callback")
        self.cfg = cfg
        self.alerts: Dict[str, Alert] = {}        # alert_id -> Alert
        self.pair_alerts: Dict[tuple, str] = {}   # (veh, other) -> alert_id
        # heap entries are IMMUTABLE snapshots (-priority, timestamp, seq,
        # alert): upserts mutate alert.priority in place, which would break
        # the heap invariant if the live object were the sort key (ADVICE
        # r3) — a stale snapshot is just a lazy re-queue duplicate that
        # pump()/compaction collapse by id
        self._queue: List[tuple] = []
        self._queue_seq = itertools.count()
        self._queue_dupes = 0      # lazy re-queue entries awaiting compaction
        self._callbacks: Dict[str, List[AlertCallback]] = {}
        self._global_callbacks: List[AlertCallback] = []
        self.stats = {"created": 0, "updated": 0, "acknowledged": 0,
                      "expired": 0, "sent": 0, "dropped_low_risk": 0}
        # the device feed (process_batch, executor thread) and the pump loop
        # (asyncio thread) mutate the same heap/dicts — serialize them
        self._lock = threading.RLock()

    # ---- ingestion from the device ----

    def process_batch(self, batch, resolver=None) -> List[Alert]:
        """Consume one device AlertBatch (already thresholded, deduped,
        priority-sorted). Returns the alerts created or updated.
        resolver: optional oid -> external vehicle-id mapping (Scene passes
        its registry)."""
        resolver = resolver or (lambda oid: str(int(oid)))
        # ONE device-to-host copy for the seven columns (each separate
        # fetch waits for the device again); already-fetched numpy batches
        # pass through free
        cols = (batch.valid, batch.vehicle_oid, batch.other_oid,
                batch.risk, batch.ttc, batch.distance, batch.priority)
        if isinstance(batch.valid, torch.Tensor):
            cols = to_host(cols)
        valid, vo, oo, risk, ttc, dist, prio = (np.asarray(a).ravel()
                                                for a in cols)
        idx = np.flatnonzero(valid)
        touched = []
        for i in idx:
            touched.append(self._upsert(
                resolver(vo[i]), resolver(oo[i]), float(risk[i]),
                float(ttc[i]), float(dist[i]), int(prio[i])))
        return touched

    def process_collision_risks(self, risks) -> List[Alert]:
        """Reference-named entry point (warning_system.py:259-285) for host
        CollisionRisk objects (e.g. from the prediction path)."""
        out = []
        for r in risks:
            if r.risk_level < self.cfg.alerts.risk_low:    # :273-274
                self.stats["dropped_low_risk"] += 1
                continue
            p = int(compute_priority(
                torch.tensor(r.risk_level, dtype=torch.float32),
                torch.tensor(r.time_to_collision, dtype=torch.float32),
                self.cfg))
            out.append(self._upsert(r.vehicle_id, r.other_vehicle_id,
                                    r.risk_level, r.time_to_collision,
                                    r.distance, p))
        return out

    def _upsert(self, veh: str, other: str, risk: float, ttc: float,
                dist: float, priority: int) -> Alert:
        with self._lock:
            return self._upsert_locked(veh, other, risk, ttc, dist, priority)

    def _upsert_locked(self, veh: str, other: str, risk: float, ttc: float,
                       dist: float, priority: int) -> Alert:
        msg = _message_for(risk, ttc, other, dist, self.cfg)
        key = (veh, other)
        aid = self.pair_alerts.get(key)
        if aid and aid in self.alerts:                 # update (:161-197)
            a = self.alerts[aid]
            old_priority = a.priority
            a.risk_level, a.time_to_collision = risk, ttc
            a.priority, a.message = priority, msg
            a.timestamp = time.time()
            if a.priority != old_priority:             # re-queue (:188-193)
                # LAZY re-queue: push a duplicate snapshot instead of
                # rebuilding the heap (the old O(queue) rebuild per
                # priority change made 100k-fleet serving seconds-per-step
                # — ~1k updates x ~20k queue each step). pump() collapses
                # duplicates by id each tick; between pumps, compaction
                # keeps the queue bounded.
                self._push_locked(a)
                self._queue_dupes += 1
                if self._queue_dupes > max(64, len(self.alerts)):
                    self._compact_queue_locked()
            self.stats["updated"] += 1
            return a
        a = Alert(id=f"alert-{uuid.uuid4()}", vehicle_id=veh,
                  other_vehicle_id=other, risk_level=risk,
                  time_to_collision=ttc, message=msg, priority=priority)
        self.alerts[a.id] = a
        self.pair_alerts[key] = a.id
        self._push_locked(a)
        self.stats["created"] += 1
        return a

    def _push_locked(self, a: Alert) -> None:
        """Push an immutable priority snapshot of `a` (min-heap: highest
        priority first, older timestamp breaks ties — Alert.__lt__'s order;
        seq keeps full ties from ever comparing Alert objects)."""
        heapq.heappush(self._queue,
                       (-a.priority, a.timestamp, next(self._queue_seq), a))

    # ---- lifecycle ----

    def acknowledge_alert(self, alert_id: str) -> bool:
        with self._lock:
            a = self.alerts.get(alert_id)
            if a is None:
                return False
            a.acknowledged = True
            self.stats["acknowledged"] += 1
            return True

    def cleanup_expired(self, now: Optional[float] = None) -> int:
        """Drop acked or stale alerts (reference :490-517)."""
        now = now if now is not None else time.time()
        expiry = self.cfg.alerts.alert_expiry_s
        with self._lock:
            return self._cleanup_locked(now, expiry)

    def _cleanup_locked(self, now: float, expiry: float) -> int:
        stale = [aid for aid, a in self.alerts.items()
                 if a.acknowledged or now - a.timestamp > expiry]
        for aid in stale:
            a = self.alerts.pop(aid)
            self.pair_alerts.pop((a.vehicle_id, a.other_vehicle_id), None)
            self.stats["expired"] += 1
        if stale:
            self._compact_queue_locked()
        return len(stale)

    def _compact_queue_locked(self) -> None:
        """Rebuild the heap with one live entry per alert (drops lazy
        re-queue duplicates and entries whose alert expired). O(queue),
        amortized across the duplicates that triggered it."""
        seen = set()
        uniq = []
        for _, _, _, a in self._queue:
            if a.id not in seen and a.id in self.alerts:
                seen.add(a.id)
                uniq.append((-a.priority, a.timestamp,
                             next(self._queue_seq), a))
        self._queue = uniq
        heapq.heapify(self._queue)
        self._queue_dupes = 0

    async def pump(self, now: Optional[float] = None) -> List[Alert]:
        """One processing-loop tick (reference :403-435): deliver every
        queued unacked alert not sent within resend_interval_s, re-queue."""
        now = now if now is not None else time.time()
        resend = self.cfg.alerts.resend_interval_s
        sent, keep = [], []
        with self._lock:
            seen = set()
            while self._queue:
                a = heapq.heappop(self._queue)[3]
                if a.id in seen or a.id not in self.alerts:
                    continue          # lazy re-queue duplicate / expired
                seen.add(a.id)
                if not a.acknowledged and now - a.last_sent >= resend:
                    a.last_sent = now
                    sent.append(a)
                if not a.acknowledged:
                    keep.append(a)
            for a in keep:
                self._push_locked(a)
            self._queue_dupes = 0
        for a in sent:                  # deliver outside the lock
            await self._send(a)
        self.cleanup_expired(now)
        return sent

    async def _send(self, a: Alert) -> None:
        self.stats["sent"] += 1
        for cb in (self._callbacks.get(a.vehicle_id, [])
                   + self._global_callbacks):
            try:
                r = cb(a)
                if asyncio.iscoroutine(r):
                    await r
            except Exception as e:  # noqa: BLE001
                logger.error("alert callback error: %s", e)

    # ---- queries / callbacks / stats ----

    def register_callback(self, vehicle_id: Optional[str],
                          cb: AlertCallback) -> None:
        """vehicle_id=None registers a global callback
        (reference :235-257)."""
        if vehicle_id is None:
            self._global_callbacks.append(cb)
        else:
            self._callbacks.setdefault(vehicle_id, []).append(cb)

    def get_vehicle_alerts(self, vehicle_id: str) -> List[Alert]:
        """Alerts involving this vehicle from EITHER side — the device
        dedups unordered pairs (DEVIATIONS.md #7), so the per-vehicle view
        re-expands here."""
        with self._lock:
            return [a for a in self.alerts.values()
                    if vehicle_id in (a.vehicle_id, a.other_vehicle_id)]

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            by_priority = {p: 0 for p in range(4)}
            for a in self.alerts.values():
                by_priority[a.priority] += 1
            return {**self.stats, "active": len(self.alerts),
                    "by_priority": by_priority, "queued": len(self._queue)}
