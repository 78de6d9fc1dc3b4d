"""Orchestrated benchmark: service + monitor + simulator + load + analysis.

The run_benchmark.py / benchmark.sh analog (reference run_benchmark.py:
24-223 — which crashed on a wrong module path, SURVEY.md §2.9 #18; this one
runs). Phases:

  1. boot a CollisionSystem + HTTP server in-process
  2. start the PerformanceMonitor
  3. drive a VehicleSimulator feeding the scene
  4. run the LoadGenerator against the REST surface
  5. write artifacts + a combined summary JSON

Usage: python -m tpu_collide_torch.bench.run_benchmark --vehicles 1000
       --tps 200 --duration 20 [--device cpu]

The port of tpu_collide/bench/run_benchmark.py: the service's Scene lies on
--device (the CUDA card unless another is named).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import threading
import time
from datetime import datetime

from tpu_collide_torch.core.utils import get_logger, setup_logging

logger = get_logger(__name__)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vehicles", type=int, default=1000)
    ap.add_argument("--tps", type=int, default=200)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--sim-duration", type=float, default=5.0)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--output-dir", default="results")
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--world", type=float, default=10_000.0,
                    help="square world edge length (m)")
    ap.add_argument("--inject-failure", action="store_true",
                    help="drop 10%% of objects mid-test (chaos phase)")
    ap.add_argument("--device", default=None,
                    help="torch device of the service's Scene (default: "
                         "the CUDA card; 'cpu' to run without one)")
    args = ap.parse_args(argv)
    setup_logging("INFO")

    import tpu_collide_torch as tc
    from tpu_collide_torch.core.config import DetectionConfig
    from tpu_collide_torch.system import CollisionSystem
    from tpu_collide_torch.api.stdlib_server import SceneHTTPServer
    from tpu_collide_torch.bench.monitor import PerformanceMonitor
    from tpu_collide_torch.bench.load_generator import (LoadGenerator,
                                                  FailureInjector)
    from tpu_collide_torch.sim.traffic import VehicleSimulator, scene_sink

    from tpu_collide_torch.core.config import WorldConfig
    cfg = tc.SystemConfig(num_objects=max(args.vehicles * 2, 64),
                          world=WorldConfig(hi=(args.world, args.world, 0.0)),
                          detect=DetectionConfig(mode=args.mode))
    os.makedirs(args.output_dir, exist_ok=True)
    summary = {"started": datetime.now().isoformat(),
               "config": {"vehicles": args.vehicles, "tps": args.tps,
                          "duration": args.duration, "mode": args.mode}}

    async def run():
        system = CollisionSystem(cfg, node_id="bench-node",
                                 detection_hz=2.0, checkpoint_every_s=0,
                                 device=args.device)
        await system.start()
        server = SceneHTTPServer(system.scene, port=args.port)
        port = server.start()
        base = f"http://127.0.0.1:{port}"
        logger.info("service on %s", base)

        monitor = PerformanceMonitor(target=base, interval=1.0,
                                     output_dir=args.output_dir)
        monitor.start()

        # phase: simulator feeds the scene (in-process sink)
        from tpu_collide_torch.sim.traffic import TrafficMap
        tmap = TrafficMap(seed=7).generate_grid_map(
            max(2, int(args.world // 1000)), max(2, int(args.world // 1000)),
            cell_size=1000.0)
        sim = VehicleSimulator(traffic_map=tmap,
                               num_vehicles=args.vehicles,
                               movement_mode="random",
                               distribution="city_centered", seed=7)
        sim.initialize_vehicles()
        logger.info("phase: simulator (%d vehicles)", args.vehicles)
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            None, lambda: sim.run(args.sim_duration, dt=0.5,
                                  sink=scene_sink(system.scene, sim)))
        summary["sim_updates"] = sim.stats["updates"]
        logger.info("phase: load (%d tps, %.0fs)", args.tps, args.duration)

        # phase: HTTP load
        gen = LoadGenerator(target=base)
        result = await loop.run_in_executor(
            None, lambda: gen.run_load_test(args.tps, args.duration,
                                            ramp_up=args.duration * 0.1,
                                            num_vehicles=args.vehicles))
        gen.save_results(result, args.output_dir)
        logger.info("phase: load done: %s", result.summary())
        summary["load"] = result.summary()

        # phase: optional chaos
        if args.inject_failure:
            inj = FailureInjector(base)
            summary["fault"] = inj.inject_object_loss(0.1)
            await asyncio.sleep(2.0)

        # let detection loops catch up, then collect
        await asyncio.sleep(2.0)
        stats = system.get_stats()
        summary["system"] = {
            "num_alive": stats["scene"]["num_alive"],
            "alerts_active": stats["scene"]["alerts"]["active"],
            "alerts_created": stats["scene"]["alerts"]["created"],
            "avg_detect_ms": stats["scene"]["avg_step_ms"],
            "broker_published": stats["broker"]["published"],
        }
        monitor.stop()
        server.stop()
        await system.stop()

    asyncio.run(run())
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(args.output_dir, f"benchmark_{stamp}_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
