"""What the deterministic tie order of the fused tail costs, on one CUDA card.

    python3 tools/torch_tie_order.py

The fused tail (kernels/refine.py) selects hot rows and the scene top-A
(fast and precise) with core/ops.topk_low_index, which takes ties by the
lower index; the survivor compaction, whose cap is a large share of its
input, always takes core/ops.stable_topk. This tool drives chip_smoke.py's
four main_path configurations (the precise ones at the survivor_k and
survivor cap that chip_smoke.certified adopts) with three
selections at those three sites in turns, first in the order given and
then reversed, inside one process:

  torch_topk   torch.topk as it is (ties in no promised order): the tail
               before the repair
  composite    core/ops.topk_low_index: one torch.topk over an int64 key of
               (value bits, 2^31 - 1 - index)
  stable_sort  core/ops.stable_topk: a full stable descending sort

Per configuration one JSON line: the median ms per step of 10 fused steps
(CUDA events) for each selection in both orders, the certificates, and
whether the three alert lists of the last step are equal as ordered lists.
Every line carries nvidia-smi's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from tpu_collide_torch.core.ops import stable_topk, topk_low_index
    from tpu_collide_torch.kernels import refine
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    selections = {"torch_topk": lambda x, k: tuple(torch.topk(x, k)),
                  "composite": topk_low_index,
                  "stable_sort": stable_topk}
    for seed, (name, cfg, dist) in enumerate(cs.main_path_runs()):
        drive = lambda c: cs.fused_steps(c, dist, 100 + seed, torch, dev)
        attempts = 1
        if cfg.detect.mode == "precise":
            cfg, _, _, attempts = cs.certified(cfg, drive)
        line = dict(phase="tie_order", config=name,
                    survivor_k=cfg.detect.survivor_k,
                    survivor_cap=cfg.survivor_cap, attempts=attempts,
                    card=smi)
        lists = {}
        for tag, order in (("ms", list(selections)),
                           ("ms_reversed", list(selections)[::-1])):
            for sel in order:
                refine.topk_low_index = selections[sel]
                try:
                    worst_ao, (_, out, worst_of, ms, _) = drive(cfg)
                finally:
                    refine.topk_low_index = topk_low_index
                line[f"{sel}_{tag}"] = ms
                line[f"{sel}_certificates"] = [worst_of, worst_ao]
                a = out.alerts
                lists[sel] = [a.vehicle_oid.tolist(), a.other_oid.tolist()]
        line["alert_lists_equal"] = {
            sel: lists[sel] == lists["composite"] for sel in selections}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
