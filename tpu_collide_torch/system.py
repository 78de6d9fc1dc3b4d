"""System integration: compose every layer into one runnable service.

The CollisionDetectionSystem analog (reference collision_system.py:29-667).
The reference's integration module never ran — it imported symbols that did
not exist and called constructors with wrong signatures (SURVEY.md §2.9
inconsistency ledger). This one is built from the same parts list and is
exercised by tests: broker, storage, Scene (device engine + alerts),
scheduler + worker, heartbeat/election/replication/failover/throttling,
checkpointing, REST API.

Start order mirrors the reference (:224-257): broker -> storage -> scheduler
-> reliability -> scene loops -> API. Leader duties = periodic checkpoint +
backup (the rebalance+backup analog, :377-386).

The port of tpu_collide/system.py: the Scene lives on `device` (the CUDA
card unless another is named). A sharded configuration gets a ShardedScene
whose shards all lie on that device.

    python -m tpu_collide_torch.system --objects 10000 --backend fused \
        --api-port 8000 [--shards 4 --shards-y 2]
"""
from __future__ import annotations

import asyncio
import signal
import time
from typing import Any, Dict, Optional

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.types import LoadMetrics, NodeInfo
from tpu_collide_torch.core.utils import get_logger, setup_logging
from tpu_collide_torch.api.scene import Scene
from tpu_collide_torch.api.sharded_scene import ShardedScene
from tpu_collide_torch.ckpt.checkpoint import BackupManager
from tpu_collide_torch.runtime.messaging import MessageBroker
from tpu_collide_torch.runtime.scheduler import Scheduler, TaskWorker
from tpu_collide_torch.runtime.reliability import (HeartbeatMonitor,
                                                   LeaderElection,
                                                   ReplicationManager,
                                                   FailoverManager,
                                                   ThrottlingManager,
                                                   AdaptiveThrottling)
from tpu_collide_torch.runtime.storage import (InMemoryStorage, StorageFactory,
                                               VehicleLocationStorage,
                                               CollisionRiskStorage)

logger = get_logger(__name__)

class CollisionSystem:
    """One node of the collision-detection service."""

    def __init__(self, cfg: Optional[SystemConfig] = None,
                 node_id: str = "node-0",
                 known_nodes: Optional[list] = None,
                 storage_url: str = "memory://",
                 checkpoint_dir: Optional[str] = None,
                 detection_hz: float = 2.0,
                 checkpoint_every_s: float = 30.0,
                 api_port: Optional[int] = None,
                 backend: str = "xla",
                 bridge_listen: Optional[tuple] = None,
                 bridge_peers: Optional[list] = None,
                 bridge_relay: bool = False,
                 auto_retune_every: int = 0, device=None):
        self.cfg = cfg or SystemConfig()
        self.node_id = node_id
        self.detection_hz = detection_hz
        self.checkpoint_every_s = checkpoint_every_s
        self.api_port = api_port

        # layer 1: messaging + storage (+ optional multi-host bridge:
        # the control plane of a multi-machine deployment, runtime/bridge.py)
        self.broker = MessageBroker()
        self.bridge = None
        if bridge_listen or bridge_peers:
            from tpu_collide_torch.runtime.bridge import BrokerBridge
            self.bridge = BrokerBridge(self.broker, node_id,
                                       listen=bridge_listen,
                                       peers=bridge_peers or (),
                                       relay=bridge_relay)
        self.storage = StorageFactory.create_storage(storage_url)
        self.location_storage = VehicleLocationStorage(self.storage)
        self.risk_storage = CollisionRiskStorage(self.storage)

        # layer 2: device engine + alerts — a single-device Scene, or the
        # sharded ShardedScene when the config asks for shards (the
        # multi-node deployment runs the same service surface)
        if self.cfg.shard.total_shards > 1:
            self.scene = ShardedScene(self.cfg,
                                      checkpoint_dir=checkpoint_dir,
                                      broker=self.broker, backend=backend,
                                      auto_retune_every=auto_retune_every,
                                      device=device)
        else:
            self.scene = Scene(self.cfg, checkpoint_dir=checkpoint_dir,
                               broker=self.broker, backend=backend,
                               auto_retune_every=auto_retune_every,
                               device=device)

        # layer 3: scheduling
        self.scheduler = Scheduler(self.broker)
        self.worker = TaskWorker(self.broker, node_id)
        self.worker.register_handler("collision_detection",
                                     self._task_detect)
        self.worker.register_handler("checkpoint", self._task_checkpoint)

        # layer 4: reliability
        self.heartbeat = HeartbeatMonitor(self.broker, node_id,
                                          interval=1.0, max_missed=3)
        self.election = LeaderElection(self.broker, node_id,
                                       known_nodes or [node_id],
                                       timeout_range=(0.5, 1.0))
        self.replication = ReplicationManager(self.broker, node_id)
        self.replication.is_leader_fn = self.election.is_current_leader
        self.failover = FailoverManager(self.broker, node_id)
        self.throttling = ThrottlingManager()
        self.adaptive = AdaptiveThrottling(self.throttling, self._cpu_load)
        self.backup = BackupManager(
            (checkpoint_dir or "/tmp/tpu_collide") + "/backups")
        self.backup.register_source(
            "alerts", lambda: self.scene.alert_manager.get_stats(),
            lambda s: None)

        self.running = False
        self._tasks: list = []
        self._started_at = 0.0

        # cross-component callbacks (reference :297-310)
        self.heartbeat.on_node_failure(self._on_node_failure)
        self.election.on_become_leader(self._on_become_leader)

    # ---- lifecycle ----

    async def start(self) -> None:
        self._started_at = time.time()
        await self.broker.start()
        if self.bridge is not None:
            await self.bridge.start()
        await self.storage.connect()
        await self.scheduler.start()
        self.scheduler.register_node(NodeInfo(node_id=self.node_id))
        await self.heartbeat.start()
        await self.election.start()
        await self.replication.start()
        await self.adaptive.start()
        self.running = True
        self._tasks = [
            asyncio.ensure_future(self._detection_loop()),
            asyncio.ensure_future(self._alert_pump_loop()),
            asyncio.ensure_future(self._main_loop()),
        ]
        if self.checkpoint_every_s > 0 and self.scene.ckpt is not None:
            self._tasks.append(
                asyncio.ensure_future(self._checkpoint_loop()))
        logger.info("collision system %s started", self.node_id)

    async def stop(self) -> None:
        self.running = False
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.adaptive.stop()
        await self.replication.stop()
        await self.election.stop()
        await self.heartbeat.stop()
        await self.scheduler.stop()
        await self.storage.disconnect()
        if self.bridge is not None:
            await self.bridge.stop()
        await self.broker.stop()
        logger.info("collision system %s stopped", self.node_id)

    # ---- loops ----

    async def _detection_loop(self) -> None:
        """The EarlyWarningSystem loop (warning_system.py:680-714): run
        detection over the ingested fleet at detection_hz; warn if a sweep
        exceeds the 100 ms SLO."""
        period = 1.0 / self.detection_hz
        while self.running:
            t0 = time.perf_counter()
            try:
                if self.scene.ingested_count or self.scene._pending:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.scene.detect)
            except Exception as e:  # noqa: BLE001
                logger.error("detection loop error: %s", e)
            elapsed = time.perf_counter() - t0
            if elapsed * 1e3 > 100.0:
                logger.warning("detection sweep took %.1f ms (> 100 ms SLO)",
                               elapsed * 1e3)
            await asyncio.sleep(max(0.0, period - elapsed))

    async def _alert_pump_loop(self) -> None:
        """AlertManager processing loop at 10 Hz (warning_system.py:403-435)."""
        while self.running:
            try:
                await self.scene.alert_manager.pump()
            except Exception as e:  # noqa: BLE001
                logger.error("alert pump error: %s", e)
            await asyncio.sleep(0.1)

    async def _main_loop(self) -> None:
        """Load reporting every 5 s (reference :506-520)."""
        while self.running:
            self.scheduler.update_node_load(self.node_id, LoadMetrics(
                cpu_usage=self._cpu_load(),
                queue_size=len(self.scene._pending)))
            await asyncio.sleep(5.0)

    async def _checkpoint_loop(self) -> None:
        """Leader duty: periodic checkpoint + backup (reference :377-386)."""
        while self.running:
            await asyncio.sleep(self.checkpoint_every_s)
            if self.election.is_current_leader():
                try:
                    path = self.scene.save_checkpoint()
                    self.backup.create_backup()
                    logger.info("checkpointed to %s", path)
                except Exception as e:  # noqa: BLE001
                    logger.error("checkpoint failed: %s", e)

    # ---- task handlers / callbacks ----

    def _task_detect(self, payload: dict) -> dict:
        batch = self.scene.detect()
        # a sharded batch counts its alerts per shard
        return {"num_alerts": int(batch.count.sum())}

    def _task_checkpoint(self, payload: dict) -> dict:
        return {"path": self.scene.save_checkpoint()}

    async def _on_node_failure(self, node_id: str) -> None:
        logger.warning("node %s failed; reassigning resources", node_id)
        self.scheduler.unregister_node(node_id)
        survivors = [nid for nid, st in self.heartbeat.status.items()
                     if st == HeartbeatMonitor.ACTIVE]
        await self.failover.handle_node_failure(node_id,
                                                survivors or [self.node_id])

    async def _on_become_leader(self) -> None:
        logger.info("%s became leader", self.node_id)

    def _cpu_load(self) -> float:
        try:
            import psutil
            return psutil.cpu_percent(interval=None) / 100.0
        except ImportError:
            return 0.0

    # ---- stats (reference :611-629) ----

    def get_stats(self) -> Dict[str, Any]:
        return {
            "node_id": self.node_id,
            "uptime_s": time.time() - self._started_at,
            "is_leader": self.election.is_current_leader(),
            "scene": self.scene.stats(),
            "scheduler": self.scheduler.get_stats(),
            "broker": self.broker.get_stats(),
            "bridge": (self.bridge.get_stats() if self.bridge else None),
            "throttling": dict(self.throttling.stats),
            "heartbeat": dict(self.heartbeat.status),
        }


def main(argv=None) -> None:
    """CLI (reference collision_system.py:632-667)."""
    import argparse
    ap = argparse.ArgumentParser(description="tpu-collide service node")
    ap.add_argument("--node-id", default="node-0")
    ap.add_argument("--storage-url", default="memory://")
    ap.add_argument("--api-port", type=int, default=8000)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--objects", type=int, default=1000)
    ap.add_argument("--detection-hz", type=float, default=2.0)
    ap.add_argument("--backend", choices=("xla", "fused"), default="xla",
                    help="step engine: the exact reference-shaped "
                         "pipeline or the fused CUDA kernel (big fleets)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard the world over x slabs (all shards on "
                         "--device)")
    ap.add_argument("--shards-y", type=int, default=None,
                    help="y tiles of a 2D (x, y) grid of shards")
    ap.add_argument("--shards-z", type=int, default=None,
                    help="z tiles of a 3D (x, y, z) grid of shards "
                         "(deep-z worlds / stacked airspace layers)")
    ap.add_argument("--device", default=None,
                    help="torch device of the Scene (default: the CUDA "
                         "card; 'cpu' to run without one)")
    ap.add_argument("--detect-mode", choices=("precise", "fast"),
                    default=None,
                    help="override DetectionConfig.mode")
    ap.add_argument("--bridge-listen", default=None, metavar="HOST:PORT",
                    help="accept multi-host broker links on this address "
                         "(runtime/bridge.py)")
    ap.add_argument("--bridge-peer", action="append", default=[],
                    metavar="HOST:PORT",
                    help="dial a peer node's bridge (repeatable)")
    ap.add_argument("--bridge-relay", action="store_true",
                    help="hub mode: re-forward bridged messages between "
                         "links (star topologies)")
    ap.add_argument("--auto-retune", type=int, default=0, metavar="K",
                    help="re-derive grid/window capacities from the live "
                         "fleet every K steps (0 = off; the runtime "
                         "adaptive-resolution analog, Scene.retune)")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--config", default=None,
                    help="JSON SystemConfig file (overrides --objects)")
    args = ap.parse_args(argv)

    setup_logging(args.log_level)
    if args.config:
        with open(args.config) as fh:
            cfg = SystemConfig.from_json(fh.read())
    else:
        cfg = SystemConfig(num_objects=args.objects)
    if args.detect_mode:
        import dataclasses as _dc
        cfg = cfg.replace(detect=_dc.replace(cfg.detect,
                                             mode=args.detect_mode))
    if args.shards or args.shards_y or args.shards_z:
        import dataclasses as _dc
        cfg = cfg.replace(shard=_dc.replace(
            cfg.shard, num_shards=args.shards or cfg.shard.num_shards,
            num_shards_y=args.shards_y or cfg.shard.num_shards_y,
            num_shards_z=args.shards_z or cfg.shard.num_shards_z))

    def addr(s_):
        host, port = s_.rsplit(":", 1)
        return (host, int(port))

    system = CollisionSystem(cfg, node_id=args.node_id,
                             storage_url=args.storage_url,
                             checkpoint_dir=args.checkpoint_dir,
                             detection_hz=args.detection_hz,
                             api_port=args.api_port,
                             backend=args.backend,
                             bridge_listen=(addr(args.bridge_listen)
                                            if args.bridge_listen else None),
                             bridge_peers=[addr(a) for a in args.bridge_peer],
                             bridge_relay=args.bridge_relay,
                             auto_retune_every=args.auto_retune,
                             device=args.device)

    async def run():
        # SIGTERM / SIGINT end the service through the finally blocks below
        # (server, then system), and the process exits 0
        stop = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            asyncio.get_running_loop().add_signal_handler(sig, stop.set)
        await system.start()
        try:
            import fastapi  # noqa: F401
            from tpu_collide_torch.api.rest import ApiServer
            server = ApiServer(system.scene, broker=system.broker,
                               scheduler=system.scheduler, port=args.api_port)
            await server.serve()
        except ImportError:
            # stdlib fallback keeps the REST surface alive without fastapi
            from tpu_collide_torch.api.stdlib_server import SceneHTTPServer
            server = SceneHTTPServer(system.scene, port=args.api_port,
                                     scheduler=system.scheduler)
            server.start()
            logger.info("serving (stdlib) on port %d", server.port)
            try:
                await stop.wait()
            finally:
                server.stop()
        finally:
            await system.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
