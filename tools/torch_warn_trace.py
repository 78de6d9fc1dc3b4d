"""The warn cell's loop (perfbench/drivers/warn_loop.py) seen from inside:
its host waits, its device's idle and its allocator.

    python3 tools/torch_warn_trace.py [--tree DIR] [--seed N] [--seconds S]
        [--objects N] [--device cpu] [--out FILE]

Runs the cell's set-up (the step's certification, the ring's fill, the
predict slots' certification) on the program of --tree (this checkout by
default; a `git archive` of another commit to compare it with), then:

  * an untraced window of --seconds: each tick's host ms, predict and plain
    ticks apart, and torch.cuda.memory_stats()'s counts of device
    allocations, frees and allocation retries before and after it;
  * the cell's profile_ticks ticks under perfbench/trace.Window: the same
    counts across them, each tick's host ms, every per-layer reader of the
    cell (this checkout's perfbench/metrics, whatever the tree), each
    cudaMalloc and cudaFree with the innermost tc.* span around it, the
    synchronising runtime calls inside tc.step, tc.predict or tc.history
    that lie outside every tc.host_wait, and each prediction's launched
    device ms beside the part that the spans inside it launched.

--objects cuts the fleet, the world shrunk to keep its density (the CPU
takes a few thousand). Prints one JSON line, and writes it to --out."""
from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL = "drones_1m_3d_warn.warn_2hz"
ALLOC = ("cudaMalloc", "cudaFree")
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
         "cudaMemcpy3D", "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol"}
OUTER = ("tc.step", "tc.predict", "tc.history")
CHILDREN = ("tc.classify", "tc.cell_list", "tc.host_wait",
            "tc.predict_kernel", "tc.predict_merge", "tc.predict_topup",
            "tc.predict_compact")
COUNTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def innermost(t: float, spans) -> str:
    holds = [s for s in spans if s[1] <= t <= s[2]]
    return min(holds, key=lambda s: s[2] - s[1])[0] if holds else "none"


def runtime(host, launched) -> dict:
    """What the traced window's host operations say of the allocator, of
    the waits, and of how much of each prediction's launched device time
    the spans inside it launched."""
    base = lambda name: re.sub(r"_v\d+$", "", name)
    spans = [h for h in host if h[0].startswith("tc.")]
    outer = [s for s in spans if s[0] in OUTER]
    waits = [s for s in spans if s[0] == "tc.host_wait"]
    within = lambda t, xs: any(s[1] <= t <= s[2] for s in xs)
    cover = []
    for call in (s for s in spans if s[0] == "tc.predict"):
        kids = [s for s in spans if s[0] in CHILDREN
                and call[1] <= s[1] and s[2] <= call[2]]
        mine = [us for t, us in launched if call[1] <= t <= call[2]]
        cover.append([sum(mine) * 1e-3, sum(
            us for t, us in launched if within(t, kids)) * 1e-3])
    return dict(
        predict_launched_and_covered_ms=cover,
        alloc=[[base(n), innermost(s, spans), (e - s) * 1e-3]
               for n, s, e in host if base(n) in ALLOC],
        unmarked_syncs=[[base(n), innermost(s, spans)]
                        for n, s, e in host if base(n) in SYNCS
                        and within(s, outer) and not within(s, waits)],
        syncs=sum(base(n) in SYNCS for n, _, _ in host))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 404)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--objects", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from perfbench import harness
    from perfbench.drivers import common
    from perfbench.drivers.step_loop import certified
    from perfbench.drivers.warn_loop import Ticks
    from perfbench.launched import links
    from perfbench.trace import Window, summary
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.device import resolve_device, to_host
    from tpu_collide_torch.detect.predict import (empty_history,
                                                  update_history)
    from tpu_collide_torch.engine import make_predict

    bench = harness.manifest(ROOT)
    cell = harness.resolve(CELL, bench, pkg=ROOT / "perfbench")
    if args.objects:
        s = cell.config["system"]
        f = (args.objects / s["num_objects"]) ** (1 / 3)
        s["world"]["hi"] = [h * f for h in s["world"]["hi"]]
        s["num_objects"] = args.objects
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tr, pc = cell.traffic, cell.config["predict"]
    t0 = time.perf_counter()
    cfg, state, gen, _, _ = certified(
        common.system_config(cell), common.fleet_state(cell, args.seed, dev),
        tr["certify_steps"], args.seed, torch, dev)

    def predictor(k):
        return make_predict(cfg, pc["horizon"], pc["step"],
                            sub_window=pc["sub_window"],
                            merge_k=pc["merge_k"], k_slots=k,
                            r_cap=pc["r_cap"], device=dev)

    loop = Ticks(tt.make_step(cfg, backend="fused", device=dev), predictor,
                 pc["k_slots"], state, empty_history(
                     cfg.num_objects, pc["history_points"], device=dev),
                 gen, cfg.sim.dt, tr["predict_every"], torch)
    del state
    certify_from = tr["fill_ticks"] - tr["predict_every"] * \
        tr["certify_predicts"]
    for _ in range(tr["fill_ticks"]):
        _, _, got = loop.run(update_history, to_host)
        if got is not None and loop.tick > certify_from:
            loop.certify(got, to_host)
    common.sync(torch, dev)
    setup_s = time.perf_counter() - t0

    def counts() -> dict:
        if dev.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(dev)
        return {c: st.get(c, 0) for c in COUNTS}

    def ticks(n=None, seconds=None) -> dict:
        """n ticks, or ticks for `seconds`: their host ms, predict and
        plain apart."""
        ms = {"predict": [], "plain": []}
        end = time.perf_counter() + (seconds or 0.0)
        while (len(ms["predict"]) + len(ms["plain"]) < n if n is not None
               else time.perf_counter() < end):
            t = time.perf_counter()
            _, _, got = loop.run(update_history, to_host)
            ms["plain" if got is None else "predict"].append(
                (time.perf_counter() - t) * 1e3)
        return ms

    def medians(ms) -> dict:
        return {f"{k}_ms_median": statistics.median(v) if v else None
                for k, v in ms.items()} | {
            f"{k}_ticks": len(v) for k, v in ms.items()}

    before = counts()
    window_ms = ticks(seconds=args.seconds)
    untraced = dict(medians(window_ms), counts_before=before,
                    counts_after=counts())

    window = Window(torch, dev)
    before = counts()
    window.start()
    traced_ms = ticks(n=tr["profile_ticks"])
    window.stop(tr["profile_ticks"])
    after = counts()
    trace = summary(window)
    trace["launched"] = links(window)
    readers = {}
    for m in harness.for_cell(bench["per_layer"], CELL):
        readers[m["name"]] = harness.load_module(
            ROOT / "perfbench" / "metrics" / f"{m['name']}.py").read(trace)
    line = dict(tree=str(tree), seed=args.seed, device=str(dev),
                card=harness.card_line(dev), setup_s=setup_s,
                k_slots=loop.k_slots, untraced=untraced,
                traced=dict(medians(traced_ms), counts_before=before,
                            counts_after=after, busy_s=trace["busy_s"],
                            window_s=trace["window_s"],
                            idle_gaps=trace["breakdown"]["idle_gaps"],
                            **runtime(trace["host"], trace["launched"])),
                readers=readers)
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
