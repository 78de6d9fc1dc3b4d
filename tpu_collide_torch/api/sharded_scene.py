"""ShardedScene: the Scene API over a mesh of shards (the port of
tpu_collide/api/sharded_scene.py).

Gives a sharded fleet the surface of api/scene.Scene (step, alerts, stats,
checkpoint and restore) on top of shard/step.py's sharded step: slab
ownership, halo exchange and migration, one process driving every shard.
Occupancy telemetry and rebalancing ride shard/balance.LoadBalancer;
prediction rides shard/predict.make_sharded_predict; checkpoints collect
the fleet to the host and restore through the same slab distribution,
which doubles as the failover story.

Where the port differs from the JAX ShardedScene on purpose:

  * the port's cell list has no candidate windows, so there is nothing to
    regrow or retune: `window_rows`, `auto_window`, `interpret` and
    `auto_retune_every` are accepted and ignored, `retune()` changes
    nothing, and `window_regrows` / `retunes` stay 0. Like the JAX
    ShardedScene, it heals no alert slots: a step's `alert_overflow` is
    reported, not healed, so a config whose slots overflow is certified
    before it is served;
  * the physics draws come from one torch.Generator per shard
    (shard/step.shard_generators, seeded 0), where the JAX package splits
    `jax.random.key(0)`;
  * the lock is named `_device_lock`, the name the route core takes
    (api/routes.py, POST /step);
  * `save_checkpoint_async` joins the previous save before it takes the
    lock that save's worker needs (the JAX ShardedScene joins it while
    holding the lock, and back-to-back saves can deadlock), and `detect()`
    returns the alert batch on the host in one copy (the JAX one returns
    device arrays, which the route core reads through numpy).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tpu_collide_torch.alerts.extract import AlertBatch
from tpu_collide_torch.api.scene import (_TYPE_INDEX, SceneHost, _compact,
                                         _host_view, _host_view_tensors)
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import to_host, to_host_async
from tpu_collide_torch.core.state import (FIELDS, ObjectState, conform_fleet,
                                          empty_state)
from tpu_collide_torch.core.types import CollisionRisk, LocationData
from tpu_collide_torch.core.utils import Timer, get_logger
from tpu_collide_torch.detect.predict import empty_history, update_history
from tpu_collide_torch.index.grid import cell_coords
from tpu_collide_torch.shard.balance import LoadBalancer, shard_occupancy
from tpu_collide_torch.shard.predict import (distribute_history,
                                             make_sharded_predict)
from tpu_collide_torch.shard.step import (collect_state, distribute_state,
                                          make_mesh, make_sharded_detect,
                                          make_sharded_ingest,
                                          make_sharded_step,
                                          shard_generators, shard_slots)

logger = get_logger(__name__)


def _cat_rows(parts) -> torch.Tensor:
    """Per-shard tensors concatenated on the first one's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


class ShardedScene(SceneHost):
    """A sharded fleet with the Scene surface (step, alerts, stats,
    checkpoints).

    Fleets enter in bulk through `adopt_fleet` (a generator, a checkpoint,
    a collected state) and per vehicle through `ingest` / `flush` (POST
    /vehicles/location): buffered reports apply in one replicated batch
    and a per-shard scatter (update in place, ownership moving across slab
    walls, free-slot insertion, overflow counted)."""

    def __init__(self, cfg: SystemConfig,
                 fleet: Optional[ObjectState] = None,
                 devices=None,
                 checkpoint_dir: Optional[str] = None,
                 auto_rebalance: bool = True,
                 broker=None, backend: str = "xla",
                 window_rows: Optional[int] = None,
                 auto_window: bool = True, interpret: bool = False,
                 auto_retune_every: int = 0, device=None):
        """backend='fused' runs the detection kernel per shard (both
        detection modes) and predict() on the predict kernel per shard.
        The shards lie on `devices` (one per shard) or all on `device` (the
        card unless another is named). `window_rows`, `auto_window`,
        `interpret` and `auto_retune_every` are accepted for the JAX
        signature and ignored (no windows to size)."""
        del window_rows, auto_window, interpret, auto_retune_every
        if cfg.shard.total_shards <= 1:
            raise ValueError("use Scene for a single device")
        self.cfg = cfg
        self.mesh = make_mesh(cfg, devices, device)
        self.slots = shard_slots(cfg)
        self._backend = backend
        self.window_regrows = 0       # nothing to regrow: no windows
        self.retunes = 0              # nothing to retune: no windows
        self._step = make_sharded_step(cfg, self.mesh, backend=backend)
        self._step_h = None           # history-carrying step (lazy)
        self._burst_cache = {}        # (n, with_history) -> burst step
        self._pipe = None             # pending step_pipelined output:
                                      # (out, its host copy)
        self._traj = None             # per-shard TrajectoryHistory
        self._traj_clock = 0.0
        self._predict_cache = {}      # (horizon, step) -> predict fn
        self._apply = make_sharded_ingest(cfg, self.mesh)
        self._detect = None           # make_sharded_detect (lazy)
        self._pending: Dict[int, tuple] = {}      # oid -> update tuple
        self._id_to_oid: Dict[str, int] = {}
        self._oid_to_id: Dict[int, str] = {}
        self._init_host(cfg, broker, checkpoint_dir)
        self.balancer = (LoadBalancer(cfg, self.slots)
                         if auto_rebalance else None)
        self.dropped_total = 0
        self.boundaries = None        # [Dx+1] slab walls (None: equal)
        self.boundaries_y = None      # [Dy+1] walls of the 2D tiling
        self.boundaries_z = None      # [Dz+1] walls of the 3D tiling
        self._gens = shard_generators(self.mesh, 0)
        # every device-touching method serialises on this lock, so that a
        # concurrent reader (a REST thread) never sees a state half replaced
        self._device_lock = threading.RLock()
        self.last_burst_risks = None  # [n] risks of the last burst
        self.last_predict = None      # the last predict's counters
        self.state = None             # tuple of per-shard states
        if fleet is not None:
            self.adopt_fleet(fleet)

    @property
    def _walls(self) -> tuple:
        return self.boundaries, self.boundaries_y, self.boundaries_z

    # ---- fleet management ----

    def _distribute(self, fleet: ObjectState) -> tuple:
        return distribute_state(fleet, self.cfg, self.mesh, *self._walls)

    def adopt_fleet(self, fleet: ObjectState) -> None:
        """Distribute a global fleet across the mesh by slab / tile, after
        conforming it to the config's contracts (2D worlds zero z)."""
        fleet = conform_fleet(fleet, self.cfg)
        with self._device_lock:
            # a pending step_pipelined output belongs to the old fleet:
            # consume it first, as Scene.adopt_fleet does
            self._drain_locked()
            self.state = self._distribute(fleet)

    def collect(self) -> ObjectState:
        """The sharded fleet in the JAX package's [D * slots] layout, on
        the first shard's device."""
        with self._device_lock:
            return collect_state(self.state)

    # ---- per-vehicle ingest (POST /vehicles/location) ----

    def ingest(self, location: LocationData, size: float = 2.0,
               vtype: str = "car") -> None:
        """Buffer one location report; applied on the next flush() or
        step()."""
        vid = location.vehicle_id
        with self._device_lock:
            oid = self._id_to_oid.get(vid)
            if oid is None:
                oid = len(self._id_to_oid)
                if oid >= self.cfg.num_objects:
                    raise ValueError(
                        f"fleet capacity {self.cfg.num_objects} exhausted")
                self._id_to_oid[vid] = oid
                self._oid_to_id[oid] = vid
            p, v, a = location.position, location.velocity, \
                location.acceleration
            self._pending[oid] = (
                (p.x, p.y, p.z), (v.x, v.y, v.z), (a.x, a.y, a.z),
                location.heading, size, _TYPE_INDEX.get(vtype, 0))
            self._remember(location)

    def flush(self) -> int:
        """Apply the buffered reports in one sharded scatter; returns how
        many applied (inserts that found no slot count into
        dropped_total)."""
        with self._device_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._pending:
            return 0
        self._ensure_state()
        oids = sorted(self._pending)
        nb = len(oids)
        b = 16
        while b < nb:
            b *= 2
        upd = {"oid": np.full(b, -1, np.int32),
               "pos": np.zeros((b, 3), np.float32),
               "vel": np.zeros((b, 3), np.float32),
               "acc": np.zeros((b, 3), np.float32),
               "heading": np.zeros(b, np.float32),
               "size": np.full(b, 2.0, np.float32),
               "otype": np.zeros(b, np.int32)}
        for i, oid in enumerate(oids):
            pos, vel, acc, heading, size, otype = self._pending[oid]
            upd["oid"][i] = oid
            upd["pos"][i] = pos
            upd["vel"][i] = vel
            upd["acc"][i] = acc
            upd["heading"][i] = heading
            upd["size"][i] = size
            upd["otype"][i] = otype
        self._pending.clear()
        if not self.cfg.world.is_3d:
            # 2D-world contract: z, vz, az are exactly 0 (DEVIATIONS #16)
            upd["pos"][:, 2] = 0.0
            upd["vel"][:, 2] = 0.0
            upd["acc"][:, 2] = 0.0
        self.state, dropped = self._apply(self.state, upd, *self._walls)
        self.dropped_total += int(dropped.sum())
        return nb

    def vehicle_id_of(self, oid: int) -> str:
        return self._oid_to_id.get(int(oid), str(int(oid)))

    @property
    def ingested_count(self) -> int:
        """Vehicles known through per-vehicle ingest (the service loops
        poll it)."""
        return len(self._id_to_oid)

    def _ensure_state(self) -> None:
        if self.state is None:
            self.state = self._distribute(
                empty_state(self.cfg.num_objects, device="cpu"))

    # ---- stepping ----

    def _step_fn(self, burst_n: Optional[int] = None):
        """The sharded step for the fleet as it is now: with its
        trajectory rings once record_trajectories has run (they migrate
        with their objects), and n steps at once for a burst."""
        hist = self._traj is not None
        if burst_n is not None:
            fn = self._burst_cache.get((burst_n, hist))
            if fn is None:
                fn = make_sharded_step(self.cfg, self.mesh,
                                       backend=self._backend,
                                       with_history=hist, burst_n=burst_n)
                self._burst_cache[(burst_n, hist)] = fn
            return fn
        if not hist:
            return self._step
        if self._step_h is None:
            self._step_h = make_sharded_step(self.cfg, self.mesh,
                                             backend=self._backend,
                                             with_history=True)
        return self._step_h

    def _advance(self, burst_n: Optional[int] = None):
        """One step (or burst) of the fleet and its rings. Returns the
        step's output and dropped [D] (with a burst also the risks per
        step)."""
        fn = self._step_fn(burst_n)
        head = (self.state,) if self._traj is None else (self.state,
                                                         self._traj)
        res = fn(*head, self._gens, *self._walls)
        if self._traj is None:
            self.state, *rest = res
        else:
            self.state, self._traj, *rest = res
        if burst_n is not None:
            self._gens, *rest = rest
        return rest

    def _maybe_rebalance(self) -> None:
        """The balancer's check after a step; a rebalance moves the walls,
        redistributes the fleet and moves the trajectory rings with their
        objects."""
        if self.balancer and self.balancer.should_rebalance(self.state):
            old = self.state
            (self.state, self.boundaries, self.boundaries_y,
             self.boundaries_z) = self.balancer.rebalance(old, self.mesh)
            if self._traj is not None:
                self._traj = self._redistribute_hist(
                    old, self.balancer.last_walls)

    def step(self, n: int = 1) -> Any:
        """Advance physics and detection n steps over the mesh; feeds the
        last step's alerts to the AlertManager. n must be >= 1."""
        if n < 1:
            raise ValueError(f"step count must be >= 1, got {n}")
        with self._device_lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            out = alerts = None
            for i in range(n):
                with Timer() as t:
                    out, dropped = self._advance()
                    # one copy syncs the step and lands what the host reads
                    if i == n - 1:
                        *view, drop = to_host(_host_view_tensors(out)
                                              + [dropped])
                        alerts = _host_view(view)[3]
                    else:
                        (drop,) = to_host([dropped])
                self._count_steps(1, t.elapsed_ms)
                self.dropped_total += int(drop.sum())
                self._maybe_rebalance()
            self.alert_manager.process_batch(alerts,
                                             resolver=self.vehicle_id_of)
        return out

    def step_burst(self, n: int) -> Any:
        """Advance n steps in one call (make_sharded_step with burst_n,
        drawing from the same generators in the same order as n step()
        calls) with one host wait. The walls stay fixed for the burst and
        the balancer checks once at its end. Only the last step's alerts
        reach the AlertManager; overflow / alert_overflow are the
        burst-wide max."""
        if n <= 1:
            return self.step(n)
        with self._device_lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            with Timer() as t:
                out, dropped, risks = self._advance(burst_n=n)
                *view, drop, risks = to_host(_host_view_tensors(out)
                                             + [dropped, risks])
            self._count_steps(n, t.elapsed_ms)
            self.dropped_total += int(drop.sum())
            self.last_burst_risks = risks
            self._maybe_rebalance()
            self.alert_manager.process_batch(_host_view(view)[3],
                                             resolver=self.vehicle_id_of)
            return out

    def step_pipelined(self) -> Optional[Any]:
        """One-behind serving over the mesh: run THIS step and start the
        copy of what the host reads of it, then consume the PREVIOUS
        pipelined step's output (drops, alerts). Returns the previous
        StepOutput, None on the first call; pipeline_drain() consumes the
        last one. step(), step_burst() and detect() drain first, so every
        output is consumed exactly once and in order. The balancer's check
        stays in the dispatch phase, as in the JAX ShardedScene. The
        sharded step waits for the device inside (the refine tails'
        selections), so the overlap is small."""
        with self._device_lock:
            self._flush_locked()
            self._ensure_state()
            with Timer() as t:
                out, dropped = self._advance()
                pending, self._pipe = self._pipe, (
                    out, to_host_async(_host_view_tensors(out)
                                       + [dropped]))
                prev = None
                if pending is not None:
                    prev = pending[0]
                    self._consume_out(*pending)
            self._count_steps(1, t.elapsed_ms)
            self._maybe_rebalance()
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

    def _consume_out(self, out, copy) -> None:
        """One pipelined step's output: its drops and its alerts."""
        *view, drop = copy.wait()
        self.dropped_total += int(drop.sum())
        self.alert_manager.process_batch(_host_view(view)[3],
                                         resolver=self.vehicle_id_of)

    def _redistribute_hist(self, old_states, walls) -> tuple:
        """After a rebalance moved objects to new slots, move their
        trajectory rings the same way: the rings of the old layout's alive
        slots, in the collected order, follow their objects through
        distribute_history under the walls the fleet was placed by (the
        balancer's f64 ones: an object between a wall's f32 and f64 values
        would otherwise go one way and its ring the other). Host-side;
        rebalances are rare."""
        host = collect_state(old_states, device="cpu")
        hist = collect_state(self._traj, device="cpu")
        alive = host.alive
        packed = ObjectState(**{f: getattr(host, f)[alive] for f in FIELDS})
        return distribute_history(
            type(hist)(**{f.name: getattr(hist, f.name)[alive]
                          for f in dataclasses.fields(hist)}),
            self.cfg, self.mesh, packed, *walls)

    def retune(self) -> bool:
        """The JAX ShardedScene re-derives its kernel's window capacity
        here; the port's cell list has no windows, so nothing changes.
        Returns False."""
        return False

    # ---- trajectory prediction on the mesh ----

    def record_trajectories(self, dt: Optional[float] = None) -> None:
        """Append current positions to the per-object trajectory rings
        (sharded with the fleet; they migrate with their objects). Call
        once per external tick when using predict()."""
        with self._device_lock:
            self._flush_locked()
            self._ensure_state()
            if self._traj is None:
                self._traj = tuple(empty_history(st.n, device=st.device)
                                   for st in self.state)
            self._traj_clock += dt if dt is not None else self.cfg.sim.dt
            self._traj = tuple(update_history(h, st, self._traj_clock)
                               for h, st in zip(self._traj, self.state))

    def predict(self, horizon: float = 10.0,
                step: float = 0.5) -> List[CollisionRisk]:
        """Trajectory prediction across the mesh: each shard predicts for
        its owned objects against a halo band widened by the largest
        predicted displacement (shard/predict.py), so the results equal
        the single-device prediction. The fused backend runs the predict
        kernel per shard, the xla backend the grid path. Returns
        is_predicted CollisionRisks, feeds the AlertManager, and leaves
        the call's counters in self.last_predict (dropped and overflow 0
        certify the list)."""
        a = self.cfg.alerts
        with self._device_lock:
            self._flush_locked()
            if self._traj is None:
                return []
            use_fused = self._backend == "fused"
            key = (float(horizon), float(step))
            pfn = self._predict_cache.get(key)
            if pfn is None:
                pfn = make_sharded_predict(
                    self.cfg, self.mesh, horizon=key[0], step=key[1],
                    backend="fused" if use_fused else "xla")
                self._predict_cache[key] = pfn
            r_cap = int(min(a.max_scene_alerts,
                            self.mesh.size * self.slots * 32))
            res = pfn(self.state, self._traj, *self._walls)
            other, valid, risk, ttc, dist = (_cat_rows(c) for c in res[:5])
            row_oid = (_cat_rows(res[5]) if use_fused
                       else _cat_rows([st.oid for st in self.state]))
            dropped, oflow = res[-2:]
            fetched = to_host(list(_compact(row_oid, other, valid, risk,
                                            ttc, dist, self.cfg, r_cap))
                              + [dropped.sum(dtype=torch.int32),
                                 oflow.sum(dtype=torch.int32)])
        top_r, voids, ooids, t_sel, d_sel, total, dropped, oflow = fetched
        self.last_predict = dict(risks=int(total), dropped=int(dropped),
                                 overflow=int(oflow))
        if int(oflow) > 0:
            logger.warning(
                "sharded predict: %d possible candidate misses (fused: "
                "uncertified per-object k_slots truncations; xla: grid "
                "buckets beyond cell_capacity) — the list may be missing "
                "pairs (counted, never silent)", int(oflow))
        if int(dropped) > 0:
            logger.warning(
                "sharded predict: %d halo-band objects beyond capacity "
                "were dropped from candidate visibility this call",
                int(dropped))
        if int(total) > r_cap:
            logger.warning(
                "sharded predict: %d predicted risks exceed the %d-slot "
                "scene budget (raise AlertConfig.max_scene_alerts)",
                int(total), r_cap)
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

    # ---- queries ----

    def detect(self) -> AlertBatch:
        """Detection only, no physics (ingest -> flush -> detect) over the
        mesh: the halo exchange and the reference-shaped tail
        (make_sharded_detect). Returns the alert batch on the host, each
        field a numpy array (`count` per shard), in one copy."""
        with self._device_lock:
            self._drain_locked()
            self._flush_locked()
            self._ensure_state()
            if self._detect is None:
                self._detect = make_sharded_detect(self.cfg, self.mesh)
            with Timer() as t:
                out, dropped = self._detect(self.state, *self._walls)
                fields = [f.name for f in dataclasses.fields(AlertBatch)]
                *cols, drop = to_host([getattr(out.alerts, f)
                                       for f in fields] + [dropped])
                batch = AlertBatch(**dict(zip(fields, cols)))
            self.dropped_total += int(drop.sum())
            self._time_calls(1, t.elapsed_ms)
            self.alert_manager.process_batch(batch,
                                             resolver=self.vehicle_id_of)
        return batch

    def grid_vehicles(self, cx: int, cy: int, cz: int = 0) -> List[str]:
        """Vehicle ids whose current position falls in grid cell
        (cx, cy, cz), collected from the mesh (GET /grids/{id}/vehicles)."""
        with self._device_lock:
            self._flush_locked()
            self._ensure_state()
            host = collect_state(self.state)
            c3, alive, oids = to_host([cell_coords(host.pos, self.cfg),
                                       host.alive, host.oid])
        hit = alive & (c3[:, 0] == cx) & (c3[:, 1] == cy) & (c3[:, 2] == cz)
        return [self.vehicle_id_of(o) for o in oids[hit]]

    def drop_fraction(self, fraction: float) -> int:
        """Fault injection: kill `fraction` of the alive fleet across the
        mesh, in the collected order, keeping every object's slot. Returns
        the kill count."""
        with self._device_lock:
            self._ensure_state()
            alive = np.concatenate(to_host([st.alive for st in self.state]))
            idx = np.flatnonzero(alive)
            kill = idx[:int(len(idx) * fraction)]
            alive[kill] = False
            self.state = tuple(
                st.replace(alive=torch.from_numpy(
                    alive[s * self.slots:(s + 1) * self.slots].copy()).to(
                        st.device))
                for s, st in enumerate(self.state))
        return int(len(kill))

    def occupancy(self) -> np.ndarray:
        with self._device_lock:
            if self.state is None:
                return np.zeros(self.cfg.shard.total_shards, int)
            return shard_occupancy(self.state, self.cfg, self.slots)

    def stats(self) -> Dict[str, Any]:
        occ = self.occupancy()
        s = self.stats_timing
        return {
            "step_count": self.step_count,
            "num_alive": int(occ.sum()),
            "num_shards": self.cfg.shard.num_shards,
            "num_shards_y": self.cfg.shard.num_shards_y,
            "shard_occupancy": occ.tolist(),
            "slots_per_shard": self.slots,
            "dropped_total": self.dropped_total,
            "avg_step_ms": (s["total_ms"] / s["steps"]) if s["steps"] else 0.0,
            "max_step_ms": s["max_ms"],
            "alerts": self.alert_manager.get_stats(),
            "rebalances": (self.balancer.stats["rebalances"]
                           if self.balancer else 0),
            "window_regrows": self.window_regrows,
            "retunes": self.retunes,
        }

    # ---- reliability (checkpointed failover) ----

    def save_checkpoint(self, metadata: Optional[dict] = None) -> str:
        """A blocking snapshot of the collected fleet (the JAX package's
        npz format, [D * slots] rows)."""
        ckpt = self._require_ckpt()
        with self._device_lock:
            self._ensure_state()
            return ckpt.save(collect_state(self.state), self.step_count,
                             metadata=metadata)

    def save_checkpoint_async(self, metadata: Optional[dict] = None):
        """Non-blocking snapshot of the sharded fleet: the collected state
        is cloned on the device under the lock; the copy to the host and
        the write run on a background thread while the mesh keeps stepping
        (ckpt.CheckpointManager.save_async). Join / raise through
        self.ckpt.wait_async()."""
        ckpt = self._require_ckpt()
        # join a previous save first: its worker takes the device lock for
        # its copy, so joining it while holding the lock could wait forever
        ckpt.wait_async()
        with self._device_lock:
            self._ensure_state()
            return ckpt.save_async(collect_state(self.state),
                                   self.step_count, metadata=metadata,
                                   transfer_lock=self._device_lock)

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Failover: reload the latest snapshot (or `step`) and
        redistribute its alive objects across the mesh under the current
        walls."""
        ckpt = self._require_ckpt()
        host, meta = ckpt.restore(step, device="cpu")
        with self._device_lock:
            self._drain_locked()   # pre-restore pipelined alerts, in order
            packed = ObjectState(**{f: getattr(host, f)[host.alive]
                                    for f in FIELDS})
            self.state = self._distribute(packed)
            self.step_count = meta["step"]
        return self.step_count
