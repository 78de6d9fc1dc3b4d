"""The port's twin of tools/big_mesh_dryrun.py: the full sharded step on a
16- or 64-shard grid at 64k objects, backends xla and fused, with the
asserts that make the sharded story credible:

  * conservation: every object accounted for after halo exchange and
    migration across the grid of shards (dropped == 0, num_alive == N);
  * no candidate truncation (overflow == 0);
  * parity: the risk count and, where neither side overflows its alert
    slots, the exact alert set equal the single-device step's
    (make_step(cfg), the reference-shaped step, as in the JAX tool) on the
    same fleet with the same draws (deterministic physics).

The port's Mesh takes one torch.device per shard and one process drives
them all (tpu_collide_torch/shard/collective.py), so `--devices` counts
shards; they all lie on the CUDA card, or on the CPU with --device cpu. The
JAX tool re-executes itself under a virtual CPU mesh; nothing here needs
that.

`compile_s` keeps the JAX key's name: the wall time of the first call, which
here is the kernels' build at first use (nvcc, where the library is not
built yet) plus the first launches. `step_ms` is the best of `--steps`
calls, each from the same state with the same draws (the calls do not
chain, so every one does the same work), each on the host clock up to the
card's synchronisation.

Usage:
    python3 tools/torch_big_mesh_dryrun.py --devices 16 --grid 8x2 --n 65536
    python3 tools/torch_big_mesh_dryrun.py --devices 64 --grid 8x8 \\
        --n 65536 --backend fused [--device cpu]

Runs on the CUDA card unless given --device cpu (without a card it raises).
Prints one JSON line: the JAX tool's keys plus nvidia-smi's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import tpu_collide_torch as tt  # noqa: E402
from tpu_collide_torch.core.config import (AlertConfig,  # noqa: E402
                                           DetectionConfig, GridConfig,
                                           ShardConfig, SimConfig,
                                           WorldConfig)
from tpu_collide_torch.core.device import card, resolve_device  # noqa: E402
from tpu_collide_torch.engine import make_step  # noqa: E402
from tpu_collide_torch.shard import (distribute_state,  # noqa: E402
                                     make_mesh, make_sharded_step,
                                     shard_generators)
from tpu_collide_torch.sim import generate_fleet  # noqa: E402


def deployment(n: int, dx: int, dy: int):
    """tools/big_mesh_dryrun.py:104-115: the 100k bench's world (10 km, 2D,
    100 m cells), uniform. The scene alert budget holds every qualifying
    alert, so that the sharded and single-device alert sets compare
    exactly; cell_capacity 64, so that the reference-shaped step's
    candidates are complete (overflow == 0 on both sides certifies it);
    accel_change_prob 0, so that the physics is deterministic; halo 1,024
    and migration 256."""
    return tt.SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(10000.0, 10000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode="fast", count_checked=False),
        sim=SimConfig(accel_change_prob=0.0),
        alerts=AlertConfig(max_scene_alerts=32768,
                           max_alerts_per_object=8),
        shard=ShardConfig(num_shards=dx, num_shards_y=dy,
                          halo_capacity=1024, migrate_capacity=256),
    )


def setup(cfg, backend: str, dev) -> tuple:
    """(fleet, mesh, sharded states, sharded step) of a dry run: the fleet
    from a generator seeded 0, uniform, on `dev`."""
    fleet = generate_fleet(torch.Generator(device=dev).manual_seed(0), cfg,
                           distribution="uniform")
    mesh = make_mesh(cfg, device=dev)
    return (fleet, mesh, distribute_state(fleet, cfg, mesh),
            make_sharded_step(cfg, mesh, backend=backend))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun(devices: int = 16, grid: str = "8x2", n: int = 65536,
           backend: str = "xla", steps: int = 2, skip_single: bool = False,
           device=None, cfg=None, parts=None) -> dict:
    """One run of the tool (big_mesh_dryrun.py:92-186): returns the JAX
    tool's result dict after its asserts. `cfg` defaults to
    deployment(n, dx, dy); one given must hold n objects on the dx x dy
    grid. `parts` is setup(cfg, backend, device) made by the caller (who
    then holds the mesh, states and step), made here when None."""
    dev = resolve_device(device)
    dx, dy = (int(v) for v in grid.split("x"))
    assert dx * dy == devices, "grid must tile the device count"
    if cfg is None:
        cfg = deployment(n, dx, dy)
    assert cfg.num_objects == n and (cfg.shard.num_shards,
                                     cfg.shard.num_shards_y) == (dx, dy)
    fleet, mesh, st, stepf = parts or setup(cfg, backend, dev)
    gens = lambda: shard_generators(mesh, 1)

    t0 = time.perf_counter()
    _, out, dropped = stepf(st, gens())
    _sync(dev)
    compile_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        stepf(st, gens())
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)

    alive = int(out.num_alive)
    drop = int(dropped.sum())
    res = {
        "devices": devices, "grid": grid, "n": n,
        "backend": backend,
        "compile_s": compile_s,
        "step_ms": min(step_ms),
        "risks": int(out.num_risks),
        "alive": alive, "dropped": drop,
        "overflow": int(out.overflow),
        "alert_overflow": int(out.alert_overflow),
        "conserved": alive == n and drop == 0,
    }
    assert res["conserved"], f"conservation failed: {res}"
    assert res["overflow"] == 0, f"sharded candidate truncation: {res}"

    if not skip_single:
        _, out1 = make_step(cfg, donate=False, device=dev)(
            fleet, torch.Generator(device=dev).manual_seed(1))
        res["risks_single"] = int(out1.num_risks)
        res["single_overflow"] = int(out1.overflow)
        assert res["single_overflow"] == 0, (
            f"single-device reference truncated its candidates: {res}")
        res["risk_parity"] = res["risks"] == res["risks_single"]
        if int(out1.alert_overflow) == 0 and res["alert_overflow"] == 0:
            # the fused tail keeps each object's own side of a pair while
            # the reference-shaped one keeps oid_i < oid_j (DEVIATIONS #10):
            # unordered pairs on the fused backend
            unordered = backend == "fused"

            def aset(o):
                v = o.alerts.valid.reshape(-1).cpu().numpy()
                pairs = zip(
                    o.alerts.vehicle_oid.reshape(-1).cpu().numpy()[v]
                    .tolist(),
                    o.alerts.other_oid.reshape(-1).cpu().numpy()[v]
                    .tolist())
                if unordered:
                    return {(min(a, b), max(a, b)) for a, b in pairs}
                return set(pairs)
            a1, a2 = aset(out1), aset(out)
            res["alert_set_equal"] = a1 == a2
            if a1 != a2:
                pos = fleet.pos.cpu().numpy()
                for tag, diff in (("single-only", a1 - a2),
                                  ("shard-only", a2 - a1)):
                    for p in sorted(diff)[:8]:
                        va, vb = p
                        print(f"# {tag} pair {p}: "
                              f"pos_a={pos[va] if 0 <= va < n else '?'} "
                              f"pos_b={pos[vb] if 0 <= vb < n else '?'}",
                              file=sys.stderr)
            assert a1 == a2, (f"alert sets differ: single-only "
                              f"{len(a1 - a2)}, shard-only {len(a2 - a1)}")
        assert res["risk_parity"], res
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=16,
                    help="shards (all on --device)")
    ap.add_argument("--grid", default="8x2",
                    help="shard grid dx x dy (product == devices)")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--backend", default="xla", choices=["xla", "fused"])
    ap.add_argument("--steps", type=int, default=2,
                    help="steady-state steps to time after the first call")
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-device parity run (timing only)")
    ap.add_argument("--device", default=None,
                    help="torch device of every shard (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = dryrun(args.devices, args.grid, args.n, args.backend, args.steps,
                 args.skip_single, device=dev)
    print(json.dumps(dict(res, card=card(dev))))
    return res


if __name__ == "__main__":
    main()
