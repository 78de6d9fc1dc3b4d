"""The readings that the city-skew cell's limits are set from.

    python3 perfbench/calibrate_cover.py --workload <cell> --seeds 1,2,3 \
        --seconds 4 [--out FILE]

For each seed, in one process: a run of the cell with a short window
(set-up, window, judge), whose compared numbers are the program's
readings, and two controls on the same judged steps:

  bfloat16  the reference itself in the program's place, computed in
            bfloat16 (calibrate.control)
  count     the program's own fused detection of the state each judged
            step detected on, under hot_cover 'count' at the adopted
            slots, with its certificate ignored: the rule that the cell's
            'cut' replaces. Its list can miss only pairs of rows that reach
            the list and that it leaves uncovered; where no row reaches,
            its list is the best and only its certificate (alert_overflow,
            reported beside) fails, which the cell counts in `failed`

Prints one JSON line a seed. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def count_control(res: dict) -> dict:
    """The 'count' rule's readings on the judged steps of a run."""
    from perfbench.drivers import common
    from perfbench.reference import compare
    from tpu_collide_torch.core.config import SystemConfig
    from tpu_collide_torch.engine import detect_and_alerts_fused
    system = res["system"]
    cfg = SystemConfig.from_json(json.dumps(system))
    cfg = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                 hot_cover="count"))
    readings = []
    for _, (_, after, _, _) in res["samples"].sample():
        out = detect_and_alerts_fused(after, cfg)
        r = compare.judge_detection(common.as_dict(after),
                                    common.produced(out), system)
        r["alert_overflow"] = int(out.alert_overflow)
        readings.append(r)
    return compare.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import calibrate, harness
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
                    control=calibrate.control(res, cell, torch),
                    control_count=count_control(res))
        line["seconds"] = time.perf_counter() - t0
        del res
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
