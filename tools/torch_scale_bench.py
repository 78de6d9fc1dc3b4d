"""The port's twin of tools/scale_bench.py: the fused step at scale on one
CUDA card, 10M objects fast and precise, and the fused sharded step at 1M-3D
on a one-shard mesh.

Method (the twin of bench.bench_fused_scan, bench.py:118-226): the fleet
from a generator seeded key0, a warm-up chunk of `chunk` steps seeded 1,
then chunk i seeded 2 + i (one torch.Generator a chunk, drawn from by its
steps in turn); per chunk one host read of the chunk's worst `overflow` and
`alert_overflow`; ms per step = the chunk's host-clock time / chunk, and on
a card also the chunk's time between CUDA events / chunk; best = the best
chunk; the last output from one more step seeded 99. adopt_k re-runs up to
twice at a raised slot count when the run's worst alert_overflow is not 0
(bench.py's rule); probe_cap sizes the precise survivor cap first from the
survivor need over the exact sequence of states the timed run steps
through. bench.py folds every StepOutput field into a checksum
(bench._consume) because jit drops outputs nothing reads; an eager PyTorch
step computes every output whether it is read or not, so nothing is folded
here.

Configurations (tools/scale_bench.py:37-61): 10M objects in a 20 x 20 x 1 km
world with 50 m cells (search radius 50 m, stage-1 gate on, count_checked
off, 4,096 scene alerts, k 8), and the 1M-3D bench world (10 x 10 x 0.5 km)
on ShardConfig(num_shards=1, halo_capacity=256, migrate_capacity=64).

Usage:
    python3 tools/torch_scale_bench.py [--which 10m,10mp,1ms] [--steps N]
                                       [--device cpu] [--out PATH]

Runs on the CUDA card unless given --device cpu (without a card it raises).
Prints one JSON line per configuration, each with nvidia-smi's name and
power limit, and writes the rows to --out (results/torch_scale_bench.json by
default).
"""
from __future__ import annotations

import argparse
import dataclasses
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
                                           ShardConfig, WorldConfig)
from tpu_collide_torch.core.device import card, resolve_device  # noqa: E402
from tpu_collide_torch.engine import make_step  # noqa: E402
from tpu_collide_torch.kernels.tune import (  # noqa: E402
    measure_survivor_need, survivor_cap_for)
from tpu_collide_torch.shard import (distribute_state,  # noqa: E402
                                     make_mesh, make_sharded_step,
                                     shard_generators)
from tpu_collide_torch.sim import generate_fleet  # noqa: E402
from tpu_collide_torch.sim.integrator import integrate  # noqa: E402

# bench.py's cap on an adopted slot count (bench.py:186)
K_MAX = 16
DEFAULT_OUT = os.path.join(ROOT, "results", "torch_scale_bench.json")


def seeded(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def cfg_10m(mode="fast"):
    return tt.SystemConfig(
        num_objects=10_000_000,
        world=WorldConfig(hi=(20000., 20000., 1000.)),
        grid=GridConfig(cell_size=50.0),
        detect=DetectionConfig(mode=mode, search_radius=50.0,
                               count_checked=False, gate_stage1=True),
        alerts=AlertConfig(max_scene_alerts=4096,
                           max_alerts_per_object=8))


def cfg_1m():
    return tt.SystemConfig(
        num_objects=1_000_000,
        world=WorldConfig(hi=(10000., 10000., 500.)),
        grid=GridConfig(cell_size=50.0),
        detect=DetectionConfig(mode="fast", search_radius=50.0,
                               count_checked=False, gate_stage1=True),
        alerts=AlertConfig(max_scene_alerts=4096))


class Clock:
    """One timed region: the host clock, and on a card CUDA events."""

    def __init__(self, dev):
        self.events = None
        if dev.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        if self.events:
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def stop(self):
        """Ends the region's device side (call before the host read that
        ends it)."""
        if self.events:
            self.events[1].record()

    def __exit__(self, *exc):
        self.host_ms = (time.perf_counter() - self.t0) * 1e3
        self.event_ms = None
        if self.events:
            self.events[1].synchronize()
            self.event_ms = self.events[0].elapsed_time(self.events[1])


@dataclasses.dataclass
class ScanInfo:
    """What fused_scan knows beyond bench.bench_fused_scan's tuple: the
    last attempt's CUDA-event ms per step (None on the CPU), the state
    after the last step, the survivor need and cap the probe found (None
    without one) and one entry per attempt."""
    event_avg_ms: float | None
    event_best_ms: float | None
    state: object
    probed_need: int | None
    probed_cap: int | None
    tries: list


def schedule(steps: int, chunk: int) -> list:
    """The generator seeds of a scan's chunks: the warm-up chunk, then the
    timed ones."""
    return [1] + [2 + i for i in range(max(1, steps // chunk))]


def scan_chunks(step, make_gen, state, steps, chunk, dev) -> tuple:
    """The scan method's chunk loop over step(state, gen) -> (state,
    counters), counters a tuple of the step's 0-dim device tensors: the
    warm-up chunk from make_gen(1), then chunk i from make_gen(2 + i), its
    steps drawing from that one generator in turn, and one host read a
    chunk of its steps' counters. Returns (the state after the last chunk,
    the warm-up steps' counters, the timed steps' counters, the ms per
    step: avg_ms and best_ms on the host clock, event_avg_ms and
    event_best_ms between CUDA events, None on the CPU)."""
    def run(state, seed):
        gen, flat = make_gen(seed), []
        for _ in range(chunk):
            state, counters = step(state, gen)
            flat.extend(counters)
        return state, torch.stack(flat).reshape(chunk, -1)

    seeds = schedule(steps, chunk)
    state, v = run(state, seeds[0])
    warm = v.tolist()                                # first build + sync
    rows, lat, ev = [], [], []
    for seed in seeds[1:]:
        with Clock(dev) as clock:
            state, v = run(state, seed)
            clock.stop()
            rows += v.tolist()                       # one host read a chunk
        lat.append(clock.host_ms / chunk)
        if clock.event_ms is not None:
            ev.append(clock.event_ms / chunk)
    return state, warm, rows, dict(
        avg_ms=sum(lat) / len(lat), best_ms=min(lat),
        event_avg_ms=sum(ev) / len(ev) if ev else None,
        event_best_ms=min(ev) if ev else None)


def scan_states(cfg, steps, chunk, key0, distribution, dev):
    """The states whose detection the scan's steps compute, in order: the
    fleet of key0 integrated chunk after chunk, each chunk's steps drawing
    from its generator (the warm-up chunk's, then the timed chunks')."""
    state = generate_fleet(seeded(key0, dev), cfg, distribution)
    for seed in schedule(steps, chunk):
        gen = seeded(seed, dev)
        for _ in range(chunk):
            state = integrate(state, cfg, gen)
            yield state


def probe_survivor_need(cfg, steps, chunk, key0, distribution, dev) -> int:
    """bench.py's probe_cap (bench.py:187-196): the largest survivor need
    (kernels/tune.measure_survivor_need) over the states the scan steps
    through; survivor_cap_for turns it into the cap."""
    return max(measure_survivor_need(cfg, s)
               for s in scan_states(cfg, steps, chunk, key0, distribution,
                                    dev))


def _fused_scan_once(cfg, steps, chunk, key0, distribution, dev):
    """One run of the scan method: (the ms per step by clock, last_out,
    worst_of, worst_ao, state). worst_of / worst_ao are the largest
    per-step overflow and alert_overflow over every timed step, kept
    apart, so both 0 certify every timed step's alert list."""
    state = generate_fleet(seeded(key0, dev), cfg, distribution)
    step = make_step(cfg, backend="fused", device=dev)

    def counted(state, gen):
        state, out = step(state, gen)
        return state, (out.overflow, out.alert_overflow)

    state, _, rows, ms = scan_chunks(counted, lambda s: seeded(s, dev),
                                     state, steps, chunk, dev)
    state, out = step(state, seeded(99, dev))
    out.num_risks.item()
    return (ms, out, max(r[0] for r in rows), max(r[1] for r in rows),
            state)


def fused_scan(cfg, steps, chunk, key0=0, distribution="uniform",
               adopt_k=True, probe_cap=False, device=None):
    """Per-step ms of make_step(cfg, backend="fused") by the scan method
    (module docstring). Returns (avg_ms, best_ms, last_out, worst_of,
    worst_ao, cfg_used, ScanInfo).

    adopt_k: bench.py's rule (bench.py:199-226). While the run's worst
    alert_overflow is not 0, at most twice: fast mode raises
    max_alerts_per_object by it up to K_MAX and stops when it cannot rise;
    precise mode raises survivor_k the same way and doubles the survivor
    cap alongside (its certificate also counts survivors beyond the cap),
    stopping when survivor_k cannot rise on the last retry. Detection never
    feeds back into physics, so every attempt steps the same trajectories.

    probe_cap (precise mode): the survivor cap sized first by
    survivor_cap_for(probe_survivor_need(...)) over the scan's own
    sequence of states."""
    dev = resolve_device(device)
    need = probed = None
    if probe_cap and cfg.detect.mode == "precise":
        need = probe_survivor_need(cfg, steps, chunk, key0, distribution,
                                   dev)
        probed = survivor_cap_for(need)
        cfg = cfg.replace(detect=dataclasses.replace(
            cfg.detect, precise_survivor_cap=probed))
    tries = []

    def attempt(cfg):
        res = _fused_scan_once(cfg, steps, chunk, key0, distribution, dev)
        tries.append(dict(k=cfg.alerts.max_alerts_per_object,
                          survivor_k=cfg.detect.survivor_k,
                          cap=cfg.survivor_cap, avg_ms=res[0]["avg_ms"],
                          overflow=res[2], aoflow=res[3]))
        return res

    ms, out, worst_of, worst_ao, state = attempt(cfg)
    retries = 2 if adopt_k else 0
    while worst_ao > 0 and retries > 0:
        retries -= 1
        if cfg.detect.mode == "fast":
            k0 = cfg.alerts.max_alerts_per_object
            new_k = min(K_MAX, k0 + worst_ao)
            if new_k == k0:
                print(f"# adopt_k: aoflow {worst_ao} persists at the "
                      f"k={K_MAX} ceiling; publishing the flagged row",
                      file=sys.stderr)
                break
            cfg = cfg.replace(alerts=dataclasses.replace(
                cfg.alerts, max_alerts_per_object=new_k))
        else:
            k0 = cfg.detect.survivor_k
            new_k = min(K_MAX, k0 + worst_ao)
            if new_k == k0 and retries == 0:
                print(f"# adopt_k: precise aoflow {worst_ao} persists at "
                      f"the k={K_MAX} ceiling with a doubled cap; "
                      "publishing the flagged row", file=sys.stderr)
                break
            cfg = cfg.replace(detect=dataclasses.replace(
                cfg.detect, survivor_k=new_k,
                precise_survivor_cap=2 * cfg.survivor_cap))
        ms, out, worst_of, worst_ao, state = attempt(cfg)
    return (ms["avg_ms"], ms["best_ms"], out, worst_of, worst_ao, cfg,
            ScanInfo(ms["event_avg_ms"], ms["event_best_ms"], state, need,
                     probed, tries))


def fused_row(tag, cfg, res, card_name) -> dict:
    """tools/scale_bench.py's row of a fused_scan result, plus the
    CUDA-event ms, the survivor caps, the attempts and the card."""
    avg, best, out, wof, wao, cfg_used, info = res
    row = {"config": tag, "avg_ms": avg, "best_ms": best,
           "overflow": wof, "aoflow": wao,
           "risks_last": int(out.num_risks.item()),
           "k": (cfg_used.detect.survivor_k
                 if cfg.detect.mode == "precise"
                 else cfg_used.alerts.max_alerts_per_object),
           "event_avg_ms": info.event_avg_ms,
           "event_best_ms": info.event_best_ms,
           "attempts": len(info.tries), "tries": info.tries}
    if cfg.detect.mode == "precise":
        row.update(cap=cfg_used.survivor_cap, probed_need=info.probed_need,
                   probed_cap=info.probed_cap, default_cap=cfg.survivor_cap)
    row["card"] = card_name
    return row


def run_fused(tag, cfg, steps, chunk, probe_cap=False, device=None):
    dev = resolve_device(device)
    res = fused_scan(cfg, steps=steps, chunk=chunk, probe_cap=probe_cap,
                     device=dev)
    row = fused_row(tag, cfg, res, card(dev))
    print(json.dumps(row), flush=True)
    return row


def sharded_1m_config():
    """cfg_1m on a one-shard mesh (tools/scale_bench.py:89-91)."""
    return cfg_1m().replace(shard=ShardConfig(num_shards=1,
                                              halo_capacity=256,
                                              migrate_capacity=64))


def sharded_scan(cfg, steps, chunk, device=None) -> tuple:
    """The scan method over make_sharded_step(cfg, mesh, backend="fused"):
    the fleet seeded 0, a warm-up chunk from shard_generators(mesh, 1), then
    chunk i from shard_generators(mesh, 2 + i). Returns (a dict of avg_ms,
    best_ms, the CUDA-event ms, worst overflow and alert_overflow of the
    timed steps, dropped summed over every step and the least num_alive,
    the states after the last step, the mesh)."""
    dev = resolve_device(device)
    mesh = make_mesh(cfg, device=dev)
    fleet = generate_fleet(seeded(0, dev), cfg, distribution="uniform")
    step = make_sharded_step(cfg, mesh, backend="fused")

    def counted(states, gens):
        states, out, drop = step(states, gens)
        return states, (out.overflow, out.alert_overflow, out.num_alive,
                        drop.sum().to(out.num_alive.dtype))

    states, warm, rows, res = scan_chunks(
        counted, lambda s: shard_generators(mesh, s),
        distribute_state(fleet, cfg, mesh), steps, chunk, dev)
    res.update(overflow=max(r[0] for r in rows),
               aoflow=max(r[1] for r in rows),
               alive=min(r[2] for r in warm + rows),
               dropped=sum(r[3] for r in warm + rows))
    return res, states, mesh


def sharded_row(cfg, res, card_name) -> dict:
    """tools/scale_bench.py's sharded row of a sharded_scan result, plus
    conservation, the CUDA-event ms and the card."""
    return {"config": "1m_sharded_fused_1dev", "avg_ms": res["avg_ms"],
            "best_ms": res["best_ms"], "overflow": res["overflow"],
            "aoflow": res["aoflow"], "dropped": res["dropped"],
            "alive": res["alive"],
            "conserved": res["dropped"] == 0
            and res["alive"] == cfg.num_objects,
            "event_avg_ms": res["event_avg_ms"],
            "event_best_ms": res["event_best_ms"], "card": card_name}


def run_sharded_1m(steps=12, chunk=4, device=None):
    """The fused sharded step at 1M-3D on the one-shard mesh: what the
    sharded wrapper (migration, halo, the per-shard tail, the reductions)
    costs over the unsharded step. `dropped` is summed over every step,
    warm-up included, and `conserved` says that nothing was dropped and
    every object stayed alive."""
    dev = resolve_device(device)
    cfg = sharded_1m_config()
    res, _, _ = sharded_scan(cfg, steps, chunk, device=dev)
    row = sharded_row(cfg, res, card(dev))
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="10m,10mp,1ms")
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the rows are written")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    which = set(args.which.split(","))
    rows = []
    if "10m" in which:
        rows.append(run_fused("10m_3d_fast", cfg_10m("fast"),
                              steps=args.steps, chunk=3, device=dev))
    if "10mp" in which:
        rows.append(run_fused("10m_3d_precise", cfg_10m("precise"),
                              steps=6, chunk=2, probe_cap=True, device=dev))
    if "1ms" in which:
        rows.append(run_sharded_1m(device=dev))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"# wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
