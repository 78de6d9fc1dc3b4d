"""The readings that the limits in perfbench/limits/ are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--control] [--out FILE]

For each seed, in one process: a run of the cell with a short window
(set-up, window, judge), whose compared numbers are the program's
readings; with --control, also the control's readings on the same judged
steps: the reference itself put in the program's place, computed in
bfloat16 (the precision below the configuration's float32) with the
draws the judge took from the program's generator. Prints one JSON line a
seed. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control(res: dict, cell, torch) -> dict:
    """The control's readings on the judged steps of a run."""
    from perfbench.drivers import common
    from perfbench.reference import compare, physics, serving
    low = torch.bfloat16
    system = res["system"]
    sim, world = system["sim"], system["world"]
    is3d = world["hi"][2] > world["lo"][2]
    readings = []
    for i, item in res["samples"].sample():
        before = common.as_dict(item[0])
        r = {}
        if len(item) == 6:                       # a tick: ingest first
            rep = item[4]
            want = serving.ingest(before, rep, cell.config["vehicle_sizes"],
                                  res["otypes"], is3d)
            before = serving.ingest(before, rep,
                                    cell.config["vehicle_sizes"],
                                    res["otypes"], is3d, dtype=low)
            r["ingest_err"] = serving.judge_ingest(want, before)
        acc = res["accs"][i]
        after = physics.advance(before, acc, sim, world, dtype=low)
        r.update(physics.judge(before, after, acc, sim, world))
        r.update(compare.judge_detection(
            after, compare.stand_in(after, system, low), system))
        readings.append(r)
    out = compare.worst(readings)
    if "batches" in res:
        name = lambda o: res["names"][int(o)]
        reg, cre, upd = serving.registry(res["batches"], name, dtype=low)
        out["manager_miss"] = serving.judge_registry(
            serving.registry(res["batches"], name),
            (reg, cre, upd, len(reg)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
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
                    memory_peak_bytes=res["memory_peak_bytes"])
        if args.control:
            line["control"] = control(res, cell, torch)
        line["seconds"] = time.perf_counter() - t0
        del res
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
