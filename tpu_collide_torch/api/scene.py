"""Scene: the user-facing state API (the port of tpu_collide/api/scene.py).

Mirrors the reference's REST semantics (api.py:147-380 — ingest a location,
read locations/history, read risks, spatial queries) as a Python class
around the device-resident fleet:

    scene.ingest([...])         <- POST /vehicles/location
    scene.step(n)               <- the EarlyWarningSystem detection loop
    scene.get_location(id)      <- GET /vehicles/{id}/location
    scene.get_history(id)       <- GET /vehicles/{id}/history
    scene.get_vehicle_risks(id) <- GET /vehicles/{id}/risks
    scene.query_radius(p, r)    <- GET /grids/{id}/vehicles (generalized)
    scene.alerts(...)           <- the alerts topic / callbacks
    scene.stats()               <- aggregate get_stats trees

Host <-> device traffic is batched: ingests buffer on the host and apply in
one indexed write per step, and what the host reads of a step lands in one
device-to-host copy (core/device.to_host).

Where the port differs from the JAX Scene on purpose: the fused step's
`overflow` is 0 by construction (exact stencil runs, no windows), so there
are no candidate windows to grow and `window_rows` is accepted and ignored;
the per-object slot ceiling of the self-heals is kernels/fused_detect.K_MAX
(32); `interpret` is accepted and ignored; the physics draws come from one
torch.Generator seeded 0 (a checkpoint does not carry it, as the JAX one
does not carry its key).

The device half of predict is `engine.make_predict`'s call (the predict
kernel; the benchmark drives the same entry) or `_predict_device` (the
grid). Both run a prediction and compact the [N, merge_k] merged risks to
the r_cap highest qualifying entries on the device, so that nothing bigger
than r_cap crosses to the host, as an `engine.Predicted`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from tpu_collide_torch.alerts.extract import AlertBatch, extract_alerts
from tpu_collide_torch.alerts.manager import AlertManager
from tpu_collide_torch.ckpt.checkpoint import CheckpointManager
from tpu_collide_torch.core.config import VEHICLE_TYPES, SystemConfig
from tpu_collide_torch.core.device import (check_on, resolve_device,
                                           to_host, to_host_async)
from tpu_collide_torch.core.state import (ObjectState, conform_fleet,
                                          empty_state)
from tpu_collide_torch.core.types import (Alert, CollisionRisk, LocationData,
                                          Position)
from tpu_collide_torch.core.utils import Timer, get_logger
from tpu_collide_torch.detect.predict import (empty_history,
                                              predict_collisions,
                                              update_history)
from tpu_collide_torch.engine import (Predicted, compact_predicted,
                                      grid_overflow, make_burst_step,
                                      make_detect, make_predict, make_step)
from tpu_collide_torch.index.grid import (build_grid, cell_coords,
                                          query_radius as _query_radius)
from tpu_collide_torch.kernels.fused_detect import K_MAX
from tpu_collide_torch.kernels.tune import (suggest_cell_capacity,
                                            suggest_survivor_cap)

logger = get_logger(__name__)

_TYPE_INDEX = {t: i for i, t in enumerate(VEHICLE_TYPES)}


class HostAlerts(NamedTuple):
    """The columns of an AlertBatch that the AlertManager reads, as numpy
    arrays."""
    valid: np.ndarray
    vehicle_oid: np.ndarray
    other_oid: np.ndarray
    risk: np.ndarray
    ttc: np.ndarray
    distance: np.ndarray
    priority: np.ndarray


def _host_view_tensors(out) -> list:
    """What the host reads of a StepOutput: the counters overflow,
    alert_overflow and num_alive, then the alert columns of HostAlerts."""
    a = out.alerts
    return [out.overflow, out.alert_overflow, out.num_alive,
            *(getattr(a, f) for f in HostAlerts._fields)]


def _host_view(arrays) -> tuple:
    """(overflow, alert_overflow, num_alive, HostAlerts) of the arrays of
    _host_view_tensors."""
    of, ao, alive, *cols = arrays
    return int(of), int(ao), int(alive), HostAlerts(*cols)


def _apply_updates(state: ObjectState, slot: np.ndarray, pos, vel, acc,
                   heading, size, otype, valid: np.ndarray) -> ObjectState:
    """Write a batch of updates into fleet slots: the rows that are valid and
    whose slot lies in the fleet, the last report of a slot winning (rows
    of an out-of-range slot are dropped, as the JAX scatter's mode='drop'
    drops them). Returns a new state; the old one is left as it was."""
    n = state.n
    rows = np.flatnonzero(valid & (slot >= 0) & (slot < n))
    # the last row of each slot: unique over the reversed rows
    _, last = np.unique(slot[rows][::-1], return_index=True)
    rows = rows[::-1][last]
    dev = state.device
    idx = (torch.as_tensor(slot[rows], dtype=torch.int64, device=dev),)
    put = lambda arr, new: arr.index_put(
        idx, torch.as_tensor(new[rows], dtype=arr.dtype, device=dev))
    return state.replace(
        pos=put(state.pos, pos), vel=put(state.vel, vel),
        acc=put(state.acc, acc), heading=put(state.heading, heading),
        size=put(state.size, size), otype=put(state.otype, otype),
        alive=put(state.alive, np.ones(len(slot), bool)))


def _predict_device(state, traj, cfg: SystemConfig, horizon: float,
                    step: float, r_cap: int):
    """Prediction over the grid (detect/predict.predict_collisions),
    compacted to r_cap. The overflow slot carries the grid's bucket
    truncation (engine.grid_overflow): candidates beyond cell_capacity are
    dropped from their bucket's gather, so a non-zero count means the
    list may be missing pairs."""
    index = build_grid(state.pos, state.alive, cfg)
    other, valid, risk, ttc, dist = predict_collisions(
        state, traj, index, cfg, horizon=horizon, step=step)
    other = state.oid[other.to(torch.int64)]
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return Predicted(*compact_predicted(state.oid, other, valid, risk, ttc,
                                        dist, cfg, r_cap),
                     grid_overflow(index, cfg).to(torch.int32), zero, zero)


class SceneHost:
    """The host-only part of the Scene surface, which Scene and
    api.ShardedScene share: each vehicle's last ten reports, the alert and
    risk queries over the alert manager, the checkpoint manager and the
    call timing. It touches no device state. `_init_host` sets what it
    reads: `alert_manager`, `ckpt`, `step_count`, `_history` and
    `stats_timing`."""

    def _init_host(self, cfg: SystemConfig, broker,
                   checkpoint_dir: Optional[str]) -> None:
        self.alert_manager = AlertManager(cfg, broker=broker)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.step_count = 0
        self._history: Dict[str, List[LocationData]] = {}
        self.stats_timing = {"steps": 0, "total_ms": 0.0, "max_ms": 0.0}

    def _remember(self, location: LocationData) -> None:
        hist = self._history.setdefault(location.vehicle_id, [])
        hist.append(location)
        del hist[:-10]                      # last-10 (storage.py:156-191)

    def _time_calls(self, n: int, ms: float) -> None:
        """n steps (or one detect) that took ms in all."""
        self.stats_timing["steps"] += n
        self.stats_timing["total_ms"] += ms
        self.stats_timing["max_ms"] = max(self.stats_timing["max_ms"],
                                          ms / n)

    def _count_steps(self, n: int, ms: float) -> None:
        self.step_count += n
        self._time_calls(n, ms)

    def get_location(self, vehicle_id: str) -> Optional[LocationData]:
        hist = self._history.get(vehicle_id)
        return hist[-1] if hist else None

    def get_history(self, vehicle_id: str) -> List[LocationData]:
        return list(self._history.get(vehicle_id, []))

    def get_vehicle_risks(self, vehicle_id: str) -> List[CollisionRisk]:
        out = []
        for a in self.alert_manager.get_vehicle_alerts(vehicle_id):
            out.append(CollisionRisk(
                id=a.id, vehicle_id=a.vehicle_id,
                other_vehicle_id=a.other_vehicle_id,
                risk_level=a.risk_level,
                time_to_collision=a.time_to_collision,
                distance=float("nan"), timestamp=a.timestamp))
        return out

    def alerts(self, min_risk: float = 0.0,
               vehicle_id: Optional[str] = None) -> List[Alert]:
        src = (self.alert_manager.get_vehicle_alerts(vehicle_id)
               if vehicle_id else list(self.alert_manager.alerts.values()))
        out = [a for a in src if a.risk_level >= min_risk]
        return sorted(out, key=lambda a: (-a.priority, -a.risk_level))

    def _require_ckpt(self) -> CheckpointManager:
        if self.ckpt is None:
            raise RuntimeError(
                f"{type(self).__name__} built without checkpoint_dir")
        return self.ckpt


class Scene(SceneHost):
    """Single-device scene (a sharded fleet: api.ShardedScene)."""

    def __init__(self, cfg: SystemConfig,
                 state: Optional[ObjectState] = None,
                 checkpoint_dir: Optional[str] = None,
                 broker=None, backend: str = "xla",
                 chunk_size: Optional[int] = None,
                 window_rows: Optional[int] = None,
                 auto_window: bool = True, interpret: bool = False,
                 auto_retune_every: int = 0, history_points: int = 16,
                 device=None):
        """backend='fused' runs step() on the cell list and the detection
        kernel (both detection modes, big fleets) and predict() on the
        predict kernel; detect() always uses the exact reference-shaped
        pipeline. The fleet lives on `device`, the card unless another is
        named; a given `state` must lie there.

        auto_window: self-heal counted capacity overflow between steps. On
        the fused backend a step whose alert_overflow > 0 (some object had
        more qualifying pairs / stage-2 survivors than its slots) doubles
        the slots (_grow_slots); on the xla backend counted grid-bucket
        overflow doubles cell_capacity (_grow_buckets). `window_rows` and
        `interpret` are accepted for the JAX signature and ignored.

        auto_retune_every=K (0 = off) additionally runs retune() every K
        steps — the periodic-readjustment analog of the reference's 10 s
        adjust_grid_resolution timer (spatial_index.py:40,302-336),
        covering the SHRINK direction regrow never takes.

        history_points: the length of each object's trajectory ring, which
        record_trajectories() fills and predict() classifies (the
        reference keeps 100 points, collision_detection.py:538-539)."""
        self.device = resolve_device(device)
        fresh = state is None
        if fresh:
            state = empty_state(cfg.num_objects, device=self.device)
        check_on(state, self.device, "Scene")
        self.state = state
        self._backend = backend
        self._chunk_size = chunk_size
        self._auto_window = auto_window and backend == "fused"
        # xla backend: counted grid-bucket overflow (out.overflow =
        # grid_overflow) self-heals by doubling cell_capacity
        self._auto_buckets = auto_window and backend != "fused"
        if (backend == "fused" and cfg.detect.mode == "precise"
                and cfg.detect.precise_survivor_cap is None
                and not fresh):
            # fleet-exact precise survivor cap: the max(4096, 2N) default is
            # often 10-40x oversized for sparse fleets; one survivor-counter
            # probe on the adopted fleet sizes it right. Density drift stays
            # covered: under-sizing is counted (alert_overflow) and
            # _grow_slots doubles the cap; retune() re-derives it in both
            # directions.
            cap = suggest_survivor_cap(cfg, state)
            if cap < cfg.survivor_cap:
                cfg = cfg.replace(detect=dataclasses.replace(
                    cfg.detect, precise_survivor_cap=cap))
        self.cfg = cfg
        self.window_regrows = 0       # times a self-heal resized a capacity
        self.retunes = 0              # times retune() changed a capacity
        self._auto_retune = int(auto_retune_every)
        self._last_retune = 0
        self._rebuild_step()
        self._detect = make_detect(cfg, device=self.device)
        self._init_host(cfg, broker, checkpoint_dir)
        # one generator, drawn from in the same order by step, step_burst
        # and step_pipelined, so that they compute the same trajectories
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._id_to_slot: Dict[str, int] = {}
        self._slot_to_id: Dict[int, str] = {}
        self._pending: List[LocationData] = []
        self._pending_meta: List[tuple] = []
        # All device-touching methods serialize on this lock, so that a
        # concurrent reader (a REST stats/query thread) never sees a state
        # half replaced
        self._device_lock = threading.RLock()
        self._num_alive = 0 if fresh else int(state.alive.sum())
        self._traj = None          # TrajectoryHistory, created on first use
        self._history_points = history_points
        self._traj_clock = 0.0
        self._predict_slots = 8        # fused-predict per-object k_slots
                                       # (self-heals on slot overflow)
        self._pipe = None   # pending step_pipelined output:
                            # (out, k_marker@dispatch, its host copy)
        self._predict_cap_prev = None     # capacity before a predict heal
        self._predict_heal_ceiling = None  # first capacity that ran out
                                           # of memory
        self.last_burst_risks = None      # [n] risks of the last burst
        self.last_predict = None   # the last predict's counters: k_slots,
                                   # risks, overflow, slot_oflow, slot_trunc

    def _rebuild_step(self) -> None:
        self._step = make_step(self.cfg, backend=self._backend,
                               chunk_size=self._chunk_size,
                               device=self.device)

    # ---- identity ----

    def _slot_for(self, vehicle_id: str) -> int:
        if vehicle_id in self._id_to_slot:
            return self._id_to_slot[vehicle_id]
        slot = len(self._id_to_slot)
        if slot >= self.state.n:
            raise ValueError(
                f"fleet capacity {self.state.n} exhausted; raise "
                f"SystemConfig.num_objects")
        self._id_to_slot[vehicle_id] = slot
        self._slot_to_id[slot] = vehicle_id
        return slot

    def vehicle_id_of(self, oid: int) -> str:
        return self._slot_to_id.get(int(oid), str(int(oid)))

    @property
    def ingested_count(self) -> int:
        """Vehicles known via per-vehicle ingest (service loops poll it)."""
        return len(self._id_to_slot)

    # ---- ingest (POST /vehicles/location analog) ----

    def ingest(self, location: LocationData, size: float = 2.0,
               vtype: str = "car") -> None:
        """Buffer one location report; applied on the next step()/flush()."""
        with self._device_lock:     # _flush_locked iterates+clears _pending
            self._pending.append(location)
            self._pending_meta.append((size, _TYPE_INDEX.get(vtype, 0)))
        self._remember(location)

    def flush(self) -> int:
        """Apply buffered ingests to the device in one indexed write."""
        with self._device_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._pending:
            return 0
        n = len(self._pending)
        slot = np.zeros(n, np.int64)
        pos = np.zeros((n, 3), np.float32)
        vel = np.zeros((n, 3), np.float32)
        acc = np.zeros((n, 3), np.float32)
        heading = np.zeros(n, np.float32)
        size = np.full(n, 2.0, np.float32)
        otype = np.zeros(n, np.int32)
        valid = np.zeros(n, bool)
        dropped = 0
        for i, (loc, (sz, ot)) in enumerate(
                zip(self._pending, self._pending_meta)):
            try:
                slot[i] = self._slot_for(loc.vehicle_id)
            except ValueError:
                # fleet capacity exhausted: drop THIS report and keep going —
                # a raise here would leave _pending uncleared and poison
                # every later flush/step/detect
                dropped += 1
                continue
            pos[i] = loc.position.to_tuple()
            vel[i] = (loc.velocity.x, loc.velocity.y, loc.velocity.z)
            acc[i] = (loc.acceleration.x, loc.acceleration.y,
                      loc.acceleration.z)
            heading[i] = loc.heading
            size[i], otype[i] = sz, ot
            valid[i] = True
        if dropped:
            logger.error(
                "dropped %d location reports: fleet capacity %d exhausted "
                "(raise SystemConfig.num_objects)", dropped, self.state.n)
        if not self.cfg.world.is_3d:
            # 2D-world contract: z/vz/az are exactly 0 (DEVIATIONS #16)
            pos[:, 2] = 0.0
            vel[:, 2] = 0.0
            acc[:, 2] = 0.0
        self.state = _apply_updates(self.state, slot, pos, vel, acc,
                                    heading, size, otype, valid)
        self._pending.clear()
        self._pending_meta.clear()
        self._num_alive = int(self.state.alive.sum())
        return n

    def adopt_fleet(self, state: ObjectState,
                    ids: Optional[Sequence[str]] = None) -> None:
        """Replace the fleet wholesale (e.g. from a generator or restore).
        The fleet must lie on the Scene's device and is conformed to the
        config's contracts (2D worlds zero z components) —
        core.state.conform_fleet."""
        check_on(state, self.device, "adopt_fleet")
        state = conform_fleet(state, self.cfg)
        with self._device_lock:
            # a pending step_pipelined output belongs to the OLD fleet:
            # consume it now (alerts in order, counters against the old
            # capacity generation) so the next step/drain doesn't feed
            # pre-adoption alerts or overwrite _num_alive with stale data
            self._drain_locked()
            self.state = state
            self._num_alive = int(state.alive.sum())
            self._id_to_slot.clear()
            self._slot_to_id.clear()
            if ids is not None:
                for slot, vid in enumerate(ids):
                    self._id_to_slot[vid] = slot
                    self._slot_to_id[slot] = vid

    # ---- stepping / detection ----

    def step(self, n: int = 1) -> Any:
        """Advance physics + detection n steps; feeds the AlertManager.
        n must be >= 1."""
        if n < 1:
            raise ValueError(f"step count must be >= 1, got {n}")
        with self._device_lock:
            return self._step_locked(n)

    def _step_locked(self, n: int) -> Any:
        self._drain_locked()
        self._flush_locked()
        out = None
        for i in range(n):
            last = i == n - 1
            with Timer() as t:
                self.state, out = self._step(self.state, self._gen)
                # one device-to-host copy syncs the step AND lands
                # everything the host consumes
                if last:
                    of, ao, alive, alerts = _host_view(
                        to_host(_host_view_tensors(out)))
                else:
                    of, ao = (int(v) for v in to_host(
                        [out.overflow, out.alert_overflow]))
            self._count_steps(1, t.elapsed_ms)
            self._heal(of, ao)
        self._maybe_auto_retune()
        self._num_alive = alive
        self.alert_manager.process_batch(alerts, resolver=self.vehicle_id_of)
        return out

    def _heal(self, overflow: int, alert_overflow: int) -> None:
        if self._auto_buckets and overflow > 0:
            self._grow_buckets(overflow)
        if self._auto_window and alert_overflow > 0:
            self._grow_slots(alert_overflow)

    def step_burst(self, n: int) -> Any:
        """Advance n steps in one call (engine.make_burst_step: n steps of
        the per-step program, drawing from the Scene's generator in the
        same order as n step() calls) with one host wait at the end.

        Trade-off: only the FINAL step's alert list reaches the
        AlertManager (intermediate lists are never fetched);
        overflow / alert_overflow on the returned output are the MAX over
        the burst, so completeness certificates and the self-heals still
        see the worst step. Use step() when every step's alerts matter
        (e.g. alert lifecycle resend/expiry at sub-burst granularity)."""
        if n <= 1:
            return self.step(n)
        with self._device_lock:
            self._drain_locked()
            self._flush_locked()
            fn = make_burst_step(self.cfg, n, backend=self._backend,
                                 chunk_size=self._chunk_size,
                                 device=self.device)
            with Timer() as t:
                self.state, self._gen, out, risks = fn(self.state,
                                                       self._gen)
                # one copy: sync + counters + alerts + per-step risk counts
                *view, risks_np = to_host(_host_view_tensors(out) + [risks])
                of, ao, alive, alerts = _host_view(view)
            self._count_steps(n, t.elapsed_ms)
            self.last_burst_risks = risks_np
            self._heal(of, ao)
            self._maybe_auto_retune()
            self._num_alive = alive
            self.alert_manager.process_batch(alerts,
                                             resolver=self.vehicle_id_of)
            return out

    def step_pipelined(self) -> Optional[Any]:
        """One-behind serving step: run THIS step and start the copy of
        what the host reads of it, then consume the PREVIOUS pipelined
        step's output (alerts to the AlertManager, overflow counters to the
        self-heals). Returns the previous StepOutput — None on the first
        call; call pipeline_drain() when stopping to consume the final
        pending output.

        Unlike step_burst, EVERY step's alert list reaches the AlertManager
        and ingests apply between steps — the trade is one step of alert
        latency. The states and alerts equal step()'s (same program, same
        generator). step()/step_burst()/detect() drain the pipeline first,
        so mixing modes keeps alert order intact. The self-heals are
        guarded by the capacity generation at dispatch time, so two
        in-flight outputs of the same undersized program grow it ONCE.

        The fused step still waits for the device inside (the refine tail's
        data-dependent selections), so the overlap is smaller than the JAX
        package's."""
        with self._device_lock:
            self._flush_locked()
            with Timer() as t:
                self.state, out = self._step(self.state, self._gen)
                pending, self._pipe = self._pipe, (
                    out, self._k_marker(),
                    to_host_async(_host_view_tensors(out)))
                prev = None
                if pending is not None:
                    prev = pending[0]
                    self._consume_out(*pending)
            self._count_steps(1, t.elapsed_ms)
            self._maybe_auto_retune()
            return prev

    def pipeline_drain(self) -> Optional[Any]:
        """Consume a pending step_pipelined output, if any (returns it)."""
        with self._device_lock:
            return self._drain_locked()

    def _drain_locked(self) -> Optional[Any]:
        if self._pipe is None:
            return None
        pending, self._pipe = self._pipe, None
        self._consume_out(*pending)
        return pending[0]

    def _k_marker(self) -> tuple:
        return (self.cfg.alerts.max_alerts_per_object,
                self.cfg.detect.survivor_k,
                self.cfg.survivor_cap,
                self.cfg.grid.cell_capacity)

    def _consume_out(self, out, km_at, copy) -> None:
        """Process one step's output: the self-heals on its counters (only
        if the capacity that produced it is still current — a later output
        of the same undersized program must not double the capacity twice)
        and its alerts to the AlertManager."""
        of, ao, alive, alerts = _host_view(copy.wait())
        if self._k_marker() == km_at:
            self._heal(of, ao)
        self._num_alive = alive
        self.alert_manager.process_batch(alerts,
                                         resolver=self.vehicle_id_of)

    def _grow_slots(self, aoflow: int) -> None:
        """Some object had more qualifying pairs (fast) / stage-2 survivors
        (precise) than its top-k slots — alert_overflow > 0 means the scene
        list may be missing pairs (counted, never silent). Double the
        mode-relevant per-object capacity so the NEXT step's list is
        provably complete again."""
        if self.cfg.detect.mode == "fast":
            a = self.cfg.alerts
            if a.max_alerts_per_object >= K_MAX:
                logger.warning(
                    "alert-slot overflow (%d) persists at the kernel's k=%d "
                    "ceiling; the scene list stays overflow-flagged — "
                    "shard the world or thin the fleet", aoflow, K_MAX)
                return
            new_k = min(a.max_alerts_per_object * 2, K_MAX)
            self.cfg = self.cfg.replace(
                alerts=dataclasses.replace(a, max_alerts_per_object=new_k))
            knob = "max_alerts_per_object"
        else:
            d = self.cfg.detect
            if d.survivor_k >= K_MAX:
                # aoflow can still be COMPACTION overflow (scene-wide cap <
                # survivors), which the cap fixes without touching k; cap
                # growth is bounded by n*k (n_surv = sum(min(emitted, k))
                # can never exceed it), so this converges even when the
                # true cause is the k ceiling
                cap_max = self.cfg.num_objects * d.survivor_k
                if self.cfg.survivor_cap < cap_max:
                    cap = min(2 * self.cfg.survivor_cap, cap_max)
                    self.cfg = self.cfg.replace(detect=dataclasses.replace(
                        d, precise_survivor_cap=cap))
                    self.window_regrows += 1
                    logger.warning(
                        "survivor overflow (%d) at the kernel's k=%d "
                        "ceiling: growing survivor cap to %d (slot-level "
                        "overflow, if any, stays counted)",
                        aoflow, K_MAX, cap)
                    self._rebuild_step()
                    return
                logger.warning(
                    "survivor-slot overflow (%d) persists at the kernel's "
                    "k=%d ceiling; the alert list stays overflow-flagged",
                    aoflow, K_MAX)
                return
            new_k = min(d.survivor_k * 2, K_MAX)
            # aoflow mixes slot overflow (per-object k) and compaction
            # overflow (the scene-wide cap) — grow both so either source
            # converges (the cap's None default materializes here)
            cap = 2 * self.cfg.survivor_cap
            self.cfg = self.cfg.replace(
                detect=dataclasses.replace(d, survivor_k=new_k,
                                           precise_survivor_cap=cap))
            knob = "survivor_k"
        self.window_regrows += 1
        logger.warning(
            "per-object alert-slot overflow (%d beyond capacity): growing "
            "%s to %d", aoflow, knob, new_k)
        self._rebuild_step()

    def _grow_buckets(self, overflow: int) -> None:
        """xla-backend self-heal: counted grid-bucket truncation (objects
        beyond GridConfig.cell_capacity dropped from their bucket's
        candidate gather) doubles cell_capacity, so the NEXT step's
        detection is provably complete again (the overflowing step's misses
        were counted, never silent)."""
        self.window_regrows += 1
        logger.warning(
            "grid-bucket overflow (%d objects beyond cell_capacity): "
            "growing cell_capacity to %d", overflow,
            self.cfg.grid.cell_capacity * 2)
        self._set_cell_capacity(self.cfg.grid.cell_capacity * 2)

    def _set_cell_capacity(self, cap: int) -> None:
        """Rebuild every cfg-bound function at a new gather-bucket capacity
        (shared by the step path's doubling heal and the predict path's
        fleet-exact heal)."""
        self.cfg = self.cfg.replace(
            grid=dataclasses.replace(self.cfg.grid, cell_capacity=cap))
        self._rebuild_step()
        self._detect = make_detect(self.cfg, device=self.device)

    def retune(self) -> bool:
        """Re-derive the static capacities from the LIVE fleet and rebuild
        when the need moved — the runtime analog of the reference's
        density-driven grid-resolution adjustment (spatial_index.py:
        139-160, 302-412). Two knobs, both directions:

          * the fused precise path's survivor cap
            (kernels/tune.suggest_survivor_cap);
          * gather-bucket capacity (GridConfig.cell_capacity): sized to the
            live densest cell (kernels/tune.suggest_cell_capacity) so the
            grid path's step/detect()/predict() report overflow 0.

        Shrinks use 2x hysteresis so density jitter never thrashes.
        Returns True if anything changed. Scene(auto_retune_every=K) runs
        this every K steps. Shrinking trades completeness margin for memory
        — if density rises again between retune ticks, steps can report
        counted overflow (never silent) until a self-heal or the next
        retune re-sizes it."""
        with self._device_lock:
            return self._retune_locked()

    def _retune_locked(self) -> bool:
        changed_step = changed_detect = False
        if self._backend == "fused" and self.cfg.detect.mode == "precise":
            # precise survivor cap, both directions with the same 2x
            # shrink hysteresis (suggest_ returns power-of-two sizes, so
            # the comparison is thrash-free)
            scap_need = suggest_survivor_cap(self.cfg, self.state)
            scap_cur = self.cfg.survivor_cap
            if scap_need > scap_cur or 2 * scap_need <= scap_cur:
                self.cfg = self.cfg.replace(detect=dataclasses.replace(
                    self.cfg.detect, precise_survivor_cap=scap_need))
                changed_step = True
        cap_need = suggest_cell_capacity(self.state, self.cfg)
        cap_cur = self.cfg.grid.cell_capacity
        if cap_need > cap_cur or 2 * cap_need <= cap_cur:
            self.cfg = self.cfg.replace(
                grid=dataclasses.replace(self.cfg.grid,
                                         cell_capacity=cap_need))
            changed_detect = True
            # the xla step shares the gather path; the fused step doesn't
            # touch cell_capacity
            changed_step = changed_step or self._backend != "fused"
        if changed_step:
            self._rebuild_step()
        if changed_detect:
            self._detect = make_detect(self.cfg, device=self.device)
        if changed_step or changed_detect:
            self.retunes += 1
            logger.info(
                "retune: survivor_cap=%d cell_capacity=%d (rebuilt %s)",
                self.cfg.survivor_cap, self.cfg.grid.cell_capacity,
                "+".join(p for p, c in (("step", changed_step),
                                        ("detect", changed_detect)) if c))
        return changed_step or changed_detect

    def _maybe_auto_retune(self) -> None:
        if (self._auto_retune
                and self.step_count - self._last_retune >= self._auto_retune):
            self._last_retune = self.step_count
            self._retune_locked()

    def detect(self) -> Any:
        """Detection only, no physics (externally-driven fleets: ingest ->
        flush -> detect, the EarlyWarningSystem pattern). Returns the
        scene's AlertBatch on the host: each field a numpy array, `count`
        included, fetched in one device-to-host copy (as the JAX Scene
        returns the fetched batch)."""
        with self._device_lock:
            return self._detect_locked()

    def record_trajectories(self, dt: Optional[float] = None) -> None:
        """Append current positions to the trajectory history ring (the
        CollisionPredictionModel.update_trajectory analog,
        collision_detection.py:553-570). Call once per external tick when
        using predict()."""
        with self._device_lock:
            self._flush_locked()
            if self._traj is None:
                self._traj = empty_history(self.state.n,
                                           self._history_points,
                                           device=self.device)
            self._traj_clock += dt if dt is not None else self.cfg.sim.dt
            self._traj = update_history(self._traj, self.state,
                                        self._traj_clock)

    def predict(self, horizon: float = 10.0,
                step: float = 0.5) -> List[CollisionRisk]:
        """Trajectory-based future-collision prediction (the
        CollisionPredictionModel.predict_collisions analog,
        collision_detection.py:572-621): classifies each object's recorded
        trajectory and re-detects along its class-predicted path. Returns
        is_predicted CollisionRisks and feeds them to the AlertManager.
        Requires >= 2 record_trajectories() calls; objects with less history
        are covered by the plain detect() path (reference :590-592).

        The fused backend runs engine.make_predict's call (the predict
        kernel; its overflow is 0 by construction), the xla backend the
        grid path. The call's counters land in self.last_predict
        (slot_oflow == overflow == 0 certifies the predicted list)."""
        a = self.cfg.alerts
        with self._device_lock:
            self._flush_locked()
            if self._traj is None:
                return []
            r_cap = min(a.max_scene_alerts,
                        self.state.n * 32)        # merge_k = 32 (predict.py)
            use_fused = self._backend == "fused"

            def run():
                if use_fused:
                    res = make_predict(
                        self.cfg, horizon, step, k_slots=self._predict_slots,
                        r_cap=r_cap, device=self.device)(self.state,
                                                         self._traj)
                else:
                    res = _predict_device(self.state, self._traj, self.cfg,
                                          horizon, step, r_cap)
                return to_host(res)    # one copy, one wait

            try:
                fetched = run()
                self._predict_cap_prev = None      # healed capacity fits
            except torch.OutOfMemoryError:
                # a bucket-capacity self-heal (below, last call) made the
                # grid path too big for device memory — its footprint is
                # linear in cell_capacity. Revert to the last capacity that
                # ran, remember the ceiling so the heal isn't re-attempted
                # every call, and retry once; the truncation stays counted
                # (never silent).
                prev = self._predict_cap_prev
                if prev is None:
                    raise
                failed = self.cfg.grid.cell_capacity
                self._predict_heal_ceiling = failed
                self._predict_cap_prev = None
                logger.warning(
                    "predict: fleet-exact healed cell_capacity %d does not "
                    "fit device memory; reverting to %d — grid-bucket "
                    "truncation stays counted (backend='fused' covers this "
                    "density without buckets)", failed, prev)
                self._set_cell_capacity(prev)
                fetched = run()
            (top_r, voids, ooids, t_sel, d_sel, total, pred_oflow,
             slot_oflow, slot_trunc) = fetched
            self.last_predict = dict(
                k_slots=self._predict_slots if use_fused else None,
                risks=int(total), overflow=int(pred_oflow),
                slot_oflow=int(slot_oflow), slot_trunc=int(slot_trunc))
            if int(slot_oflow) > 0:
                # some object had more hits at one offset than its k_slots
                # AND the truncation certificate could not prove the drops
                # harmless — the merged list may be missing pairs. Same
                # self-healing as the step path's alert slots, same ceiling.
                if self._predict_slots >= K_MAX:
                    logger.warning(
                        "predict: uncertified per-object slot overflow (%d) "
                        "persists at the kernel's k=%d ceiling; the "
                        "predicted list stays overflow-flagged — shard the "
                        "world or thin the fleet", int(slot_oflow), K_MAX)
                else:
                    self._predict_slots = min(self._predict_slots * 2,
                                              K_MAX)
                    self.window_regrows += 1
                    logger.warning(
                        "predict: uncertified per-object slot overflow (%d "
                        "hits beyond k_slots at one offset, not provably "
                        "below the merged list): growing predict k_slots "
                        "to %d for the next call", int(slot_oflow),
                        self._predict_slots)
            elif int(slot_trunc) > 0:
                # counted truncations whose drops are PROVABLY below every
                # merged entry (refine.fused_predict certificate): results
                # are exactly the grid path's — informational only
                logger.info(
                    "predict: %d per-offset slot truncations, all certified "
                    "harmless (dropped hits provably below the merged "
                    "top-%d)", int(slot_trunc), 32)
            if int(pred_oflow) > 0 and not use_fused:
                self._heal_predict_buckets(int(pred_oflow))
        if int(total) > r_cap:
            logger.warning(
                "predict: %d predicted risks exceed the %d-slot scene "
                "budget; lowest-risk ones are not surfaced "
                "(raise AlertConfig.max_scene_alerts)", int(total), r_cap)
        out = []
        for j in range(len(top_r)):
            if top_r[j] < 0.0:
                break
            out.append(CollisionRisk.new(
                vehicle_id=self.vehicle_id_of(int(voids[j])),
                other_vehicle_id=self.vehicle_id_of(int(ooids[j])),
                risk_level=float(top_r[j]),
                time_to_collision=float(t_sel[j]),
                distance=float(d_sel[j]),
                is_predicted=True))
        self.alert_manager.process_collision_risks(out)
        return out

    def _heal_predict_buckets(self, pred_oflow: int) -> None:
        """Grid path: overflow = grid bucket truncation (objects beyond
        cell_capacity dropped from their bucket's candidate list). Counted,
        never silent — and self-healing, so a predict-only workload heals
        without a step ever running. Unlike the step path's doubling, the
        heal goes fleet-exact at once (overflow counts here can be ~N/2 on
        skewed fleets — doubling would thrash), and it is memory-guarded:
        the gather footprint is linear in capacity, so a heal that runs out
        of memory (caught in predict) sets a ceiling and the truncation
        stays counted instead of retrying forever."""
        cur = self.cfg.grid.cell_capacity
        need = suggest_cell_capacity(self.state, self.cfg)
        ceil = self._predict_heal_ceiling
        if not self._auto_buckets:
            logger.warning(
                "predict: %d objects overflow their grid buckets "
                "(auto-heal disabled) — the predicted-risk list may be "
                "missing pairs; fleet-exact cell_capacity is %d",
                pred_oflow, need)
        elif need <= cur:
            logger.warning(
                "predict: %d objects overflow their grid buckets but the "
                "live fleet already fits cell_capacity %d — density drifted "
                "during the call; the next predict is complete",
                pred_oflow, cur)
        elif ceil is not None and need >= ceil:
            logger.warning(
                "predict: %d objects overflow their grid buckets; the "
                "fleet-exact capacity %d already failed to fit device "
                "memory (ceiling %d) — predicted list stays "
                "overflow-flagged (use backend='fused')",
                pred_oflow, need, ceil)
        else:
            self._predict_cap_prev = cur
            self.window_regrows += 1
            logger.warning(
                "predict: %d objects overflow their grid buckets — growing "
                "cell_capacity to the fleet-exact %d for the next call",
                pred_oflow, need)
            self._set_cell_capacity(need)

    def _detect_locked(self) -> Any:
        self._drain_locked()
        self._flush_locked()
        with Timer() as t:
            pairs = self._detect(self.state)
            batch = extract_alerts(self.state, pairs, self.cfg)
            # one copy: real sync + the whole batch, count included
            fields = [f.name for f in dataclasses.fields(AlertBatch)]
            batch = AlertBatch(**dict(zip(fields, to_host(
                [getattr(batch, f) for f in fields]))))
        self._time_calls(1, t.elapsed_ms)
        self.alert_manager.process_batch(batch, resolver=self.vehicle_id_of)
        return batch

    # ---- queries ----

    def drop_fraction(self, fraction: float) -> int:
        """Fault injection: kill `fraction` of the alive fleet (the
        /admin/inject-failure drop_objects path). Returns the kill count."""
        with self._device_lock:
            alive = self.state.alive.cpu().numpy().copy()
            idx = np.flatnonzero(alive)
            kill = idx[:int(len(idx) * fraction)]
            alive[kill] = False
            self.state = self.state.replace(
                alive=torch.as_tensor(alive, device=self.device))
            self._num_alive = int(alive.sum())
        return int(len(kill))

    def query_radius(self, center, radius: float) -> List[str]:
        """Vehicle ids within `radius` of `center` (alive only)."""
        if isinstance(center, Position):
            center = center.to_tuple()
        with self._device_lock:
            self._flush_locked()
            q = torch.tensor([center], dtype=torch.float32,
                             device=self.device)
            index = build_grid(self.state.pos, self.state.alive, self.cfg)
            cand, ok = _query_radius(index, self.state.pos, self.state.alive,
                                     q, radius, self.cfg)
            oids, ok = to_host([self.state.oid[cand[0].to(torch.int64)],
                                ok[0]])
        return [self.vehicle_id_of(o) for o in oids[ok]]

    def grid_vehicles(self, cx: int, cy: int, cz: int = 0) -> List[str]:
        """Vehicle ids whose CURRENT device position falls in grid cell
        (cx, cy, cz) — exact membership (the GET /grids/{id}/vehicles
        semantics; a radius query would also return neighbors)."""
        with self._device_lock:
            self._flush_locked()
            c3, alive, oids = to_host([cell_coords(self.state.pos, self.cfg),
                                       self.state.alive, self.state.oid])
        hit = alive & (c3[:, 0] == cx) & (c3[:, 1] == cy) & (c3[:, 2] == cz)
        return [self.vehicle_id_of(o) for o in oids[hit]]

    # ---- reliability ----

    def save_checkpoint(self, metadata: Optional[dict] = None) -> str:
        ckpt = self._require_ckpt()
        with self._device_lock:
            return ckpt.save(self.state, self.step_count,
                             metadata={"ids": self._id_to_slot,
                                       **(metadata or {})})

    def save_checkpoint_async(self, metadata: Optional[dict] = None):
        """Non-blocking snapshot: the step loop stalls only for a device-side
        clone; the transfer and the write overlap stepping
        (ckpt.CheckpointManager.save_async). Join/raise via
        self.ckpt.wait_async()."""
        ckpt = self._require_ckpt()
        # join a previous save first: its worker takes the device lock for
        # its copy, so joining it while holding the lock could wait forever
        ckpt.wait_async()
        with self._device_lock:
            return ckpt.save_async(
                self.state, self.step_count,
                metadata={"ids": dict(self._id_to_slot), **(metadata or {})},
                transfer_lock=self._device_lock)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        ckpt = self._require_ckpt()
        with self._device_lock:
            self._drain_locked()   # pre-restore pipelined alerts, in order
            state, meta = ckpt.restore(step, device=self.device)
            self.state = state
            self._num_alive = int(state.alive.sum())
            self.step_count = meta["step"]
            ids = meta.get("metadata", {}).get("ids") or {}
            self._id_to_slot = {k: int(v) for k, v in ids.items()}
            self._slot_to_id = {v: k for k, v in self._id_to_slot.items()}
        return self.step_count

    # ---- stats (get_stats tree, collision_system.py:611-629 analog) ----

    def stats(self) -> Dict[str, Any]:
        # device-free: num_alive is tracked at each flush/step/restore so
        # REST monitors never contend with the step loop for the device
        alive = self._num_alive
        s = self.stats_timing
        return {
            "step_count": self.step_count,
            "num_alive": alive,
            "capacity": self.state.n,
            "avg_step_ms": (s["total_ms"] / s["steps"]) if s["steps"] else 0.0,
            "max_step_ms": s["max_ms"],
            "alerts": self.alert_manager.get_stats(),
            "checkpoints": self.ckpt.stats if self.ckpt else None,
            "window_regrows": self.window_regrows,
            "retunes": self.retunes,
            "config": {"num_objects": self.cfg.num_objects,
                       "cell_size": self.cfg.grid.cell_size,
                       "cell_capacity": self.cfg.grid.cell_capacity,
                       "mode": self.cfg.detect.mode},
        }
