"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 perfbench/run.py --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. It needs a CUDA card; without one, or with
fewer cards than the cell asks for, it exits 1 and prints no result. The
program's kernel build stays in tpu_collide_torch/_build/ and the CUDA and
compiler caches go to .perfbench_cache/, both inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    cell = harness.resolve(args.workload, harness.manifest(ROOT))

    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            torch, device, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
