"""The readings that the warn cell's limits are set from.

    python3 perfbench/calibrate_predict.py \
        --workload drones_1m_3d_warn.warn_2hz --seeds 1,2,3 \
        --seconds 4 [--out FILE]

For each seed, in one process: a run of the cell with a short window
(set-up, window, judge), whose compared numbers are the program's
readings, and two controls on the same judged predict ticks, each put in
the program's place (the physics with the draws the judge took from the
program's generator):

  bfloat16    the reference itself in bfloat16, the precision below the
              configuration's float32: the physics, the step's detection,
              the ring's update and the prediction
  ring_16     the reference in float32 with a 16-point ring (the port's
              default) in the place of the configuration's 100 points: the
              ring after the tick, and the prediction on it

Prints one JSON line a seed. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(res: dict, torch) -> dict:
    """{control: the worst of its readings} over the judged predict ticks
    of a run of the warn loop."""
    from perfbench.drivers import common
    from perfbench.drivers.warn_loop import ring
    from perfbench.reference import compare, physics
    from perfbench.reference import predict as rp
    system, pred = res["system"], res["pred"]
    sim, world = system["sim"], system["world"]
    out = {}
    for name, low, points in (("bfloat16", torch.bfloat16,
                               pred["history_points"]),
                              ("ring_16", torch.float32, 16)):
        readings = []
        for i, item in res["samples"].sample():
            before, hist_before, _, after, out_step, _, _, at = item
            b, a = common.as_dict(before), common.as_dict(after)
            acc = res["accs"][i]
            r = physics.judge(b, physics.advance(b, acc, sim, world,
                                                 dtype=low),
                              acc, sim, world)
            r.update(compare.judge_detection(
                a, compare.stand_in(a, system, low)
                if name == "bfloat16" else common.produced(out_step),
                system))
            got_ring = rp.advance_ring(ring(hist_before), a, at, points,
                                       dtype=low)
            got = rp.stand_in(a, got_ring, system, pred, dtype=low)
            r.update(rp.judge(a, ring(hist_before), got_ring, at, got,
                              system, pred))
            readings.append(r)
        out[name] = compare.worst(readings)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import harness
    cell = harness.resolve(args.workload, harness.manifest(ROOT))
    device = torch.device("cuda")
    driver = harness.load_module(harness.PKG / "drivers"
                                 / (cell.traffic["driver"] + ".py"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        res = driver.run(dict(cell=cell, seed=seed, seconds=args.seconds,
                              trace=False, torch=torch, device=device,
                              t_start=t0))
        line = dict(workload=cell.name, seed=seed, program=res["checks"],
                    attempted=res["attempted"], failed=res["failed"],
                    e2e=res["e2e"], info=res["info"],
                    memory_peak_bytes=res["memory_peak_bytes"],
                    control=control(res, torch),
                    seconds=time.perf_counter() - t0)
        del res
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
