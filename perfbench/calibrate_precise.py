"""The readings that the precise cell's limits are set from.

    python3 perfbench/calibrate_precise.py \
        --workload drones_10m_3d_precise.step_precise --seeds 1,2,3 \
        --seconds 4 [--out FILE]

For each seed, in one process: a run of the cell with a short window
(set-up, window, judge), whose compared numbers are the program's
readings, and two controls on the same judged steps, each put in the
program's place with the draws the judge took from the program's
generator:

  bfloat16     the reference itself (physics, and detection with the
               sampled sweep) computed in bfloat16, the precision below
               the configuration's float32
  closed_form  the physics in float32 and fast mode's closed-form
               constant-velocity stage 3 (reference/detect.py) in the
               sweep's place

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
    """{control: the worst of its readings} over the judged steps of a
    run of the precise step loop."""
    from perfbench.drivers import common
    from perfbench.reference import compare, physics, precise
    system = res["system"]
    sim, world = system["sim"], system["world"]
    out = {}
    for name, low in (("bfloat16", torch.bfloat16),
                      ("closed_form", torch.float32)):
        readings = []
        for i, item in res["samples"].sample():
            before = common.as_dict(item[0])
            acc = res["accs"][i]
            after = physics.advance(before, acc, sim, world, dtype=low)
            r = physics.judge(before, after, acc, sim, world)
            got = (precise.stand_in(after, system, low) if name == "bfloat16"
                   else compare.stand_in(after, system, low))
            r.update(precise.judge(after, got, system))
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
