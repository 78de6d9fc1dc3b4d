"""Where the time of a POST /step of the port's service node goes, on one
CUDA card.

    python3 tools/torch_service_profile.py

The service of chip_smoke.py's service phase: a CollisionSystem at 100k 2D
fast (main_path's fleet and 1,024 spare slots, 1,000 vehicles ingested)
behind the stdlib server, after 3 warm-up requests. POST /step in blocks of
5 with the alert pump on, and off (its loop keeps ticking, but pump() does
nothing: no alert leaves the node), in turns: on, off, off, on, on, off,
off, on; a block starts once no pump() is under way. One JSON line per
block, medians over its requests: ms per request; the Scene.step call
inside it; the Scene's own step and copy (stats_timing); the alert
manager's process_batch; and the pump() calls that ended in the block (how
many, their ms, the alerts each sent). Then torch.profiler over 5 requests
with the pump on: device busy ms per request and the idle share. Every
line carries nvidia-smi's name and power limit.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from torch_scene_profile import device_profile  # noqa: E402

BLOCK, WARM, ORDER = 5, 3, ("on", "off", "off", "on", "on", "off", "off",
                            "on")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def profile(torch, dev, smi) -> None:
    """The blocks and the device profile, on `dev`."""
    import shutil
    from tpu_collide_torch.core.types import LocationData, Position, Vector
    from tpu_collide_torch.sim import generate_fleet

    runs = list(cs.main_path_runs())
    seed = 100 + [name for name, _, _ in runs].index("100k_2d_fast")
    cfg0, dist = {name: (c, d) for name, c, d in runs}["100k_2d_fast"]
    fleet = generate_fleet(torch.Generator(device=dev).manual_seed(seed),
                           cfg0, dist)
    cfg = cfg0.replace(num_objects=cfg0.num_objects + cs.SERVICE_SPARE)
    cs.SCRATCH.mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="service_profile_", dir=cs.SCRATCH)
    node = None
    try:
        node = cs.ServiceNode(cfg, dev, ckpt_dir)
        sc, am = node.scene, node.scene.alert_manager
        sc.adopt_fleet(cs.padded_fleet(fleet, cs.SERVICE_SPARE, torch),
                       ids=[f"fleet-{i}" for i in range(cfg0.num_objects)])
        g = torch.Generator().manual_seed(7)
        xy = torch.rand((cs.SERVICE_VEHICLES, 2), generator=g) \
            * torch.tensor(cfg.world.extent[:2])
        v = (torch.rand((cs.SERVICE_VEHICLES, 2), generator=g) - 0.5) * 30
        for i in range(cs.SERVICE_VEHICLES):
            sc.ingest(LocationData(f"vehicle-{i}",
                                   Position(*xy[i].tolist(), 0.0),
                                   Vector(*v[i].tolist(), 0.0)))
        state = {"pump": True, "in_pump": False}
        pumps, scene_ms, batch_ms = [], [], []
        pump, scene_step, process = am.pump, sc.step, am.process_batch

        async def switchable_pump(now=None):
            if not state["pump"]:
                return []
            state["in_pump"] = True
            t0 = time.perf_counter()
            try:
                sent = await pump(now)
            finally:
                state["in_pump"] = False
            pumps.append(((time.perf_counter() - t0) * 1e3, len(sent)))
            return sent

        def timed(fn, out):
            def call(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    out.append((time.perf_counter() - t0) * 1e3)
            return call

        am.pump = switchable_pump
        sc.step = timed(scene_step, scene_ms)
        am.process_batch = timed(process, batch_ms)
        step = lambda: cs.http_call(node.base, "POST", "/step", {})[1]
        for _ in range(WARM):
            step()
        med = lambda xs: statistics.median(xs) if xs else None
        for i, mode in enumerate(ORDER):
            state["pump"] = mode == "on"
            deadline = time.perf_counter() + 120
            while state["in_pump"] and time.perf_counter() < deadline:
                time.sleep(0.01)
            t = dict(sc.stats_timing)
            del pumps[:], scene_ms[:], batch_ms[:]
            ms = [step() for _ in range(BLOCK)]
            emit(dict(block=i, pump=mode, requests=BLOCK,
                      post_step_ms=med(ms), scene_step_call_ms=med(scene_ms),
                      step_and_copy_ms=(sc.stats_timing["total_ms"]
                                        - t["total_ms"])
                      / (sc.stats_timing["steps"] - t["steps"]),
                      process_batch_ms=med(batch_ms),
                      pumps_ended=len(pumps),
                      pump_ms=[round(d, 1) for d, _ in pumps],
                      pump_sent=[n for _, n in pumps],
                      active_alerts=len(am.alerts), card=smi))
        state["pump"] = True
        emit(dict(profile="POST /step, pump on", requests=5,
                  **device_profile(torch, step, 5),
                  broker=node.system.broker.get_stats(), card=smi))
    finally:
        if node is not None:
            node.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main() -> None:
    import torch
    from tpu_collide_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch_service_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.load_library()
    profile(torch, dev, smi)


if __name__ == "__main__":
    main()
