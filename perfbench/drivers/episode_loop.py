"""The episode loop: step_loop's closed loop of the fused stepper
(tpu_collide_torch.make_step(cfg, backend="fused") flat out, the next step
starting when the host has read the last one's overflow, alert_overflow
and num_risks), on a fleet that is set back to the seeded one every
`episode_steps` steps, so that a fleet whose density profile the motion
dissolves (cities of the upstream's city_centered distribution) keeps it
through the whole window, however many steps the window holds.

Set-up: the fleet from the seed on the card; the slot count adopted by
step_loop.certified's rule on the first `certify_steps` steps from the
seeded fleet (an episode's first steps, its densest); those steps also
warm every shape.

Window: it opens on a fresh episode. The reset is one assignment between
two timed steps, outside both; the step's generator runs on across it.
obj_steps_per_s and step_ms_p95 as in step_loop; a step with a non-zero
certificate, or one that raises, counts in `failed`. The traced run
profiles `profile_steps` more steps, with resets on the same schedule,
and keeps the states of the first `work_steps` for the detection kernel's
roofline and the hot top-up's rows, which it reports under info
(traced_info).

Judge: as step_loop's, on a sample of the window's steps drawn from the
seed.
"""
from __future__ import annotations

import time

from perfbench.drivers import common
from perfbench.drivers.step_loop import certified, read, traced
from perfbench.launched import links
from perfbench.reference import compare, physics
from perfbench.stats import percentile
from perfbench.trace import Window

# the detection kernel's share of its roofline, read from the traced run
# for the result's info by the benchmark's own reader
ROOFLINE = "detect_kernel.roofline_pct"
KERNEL = "fused_topk_kernel"


def run(ctx: dict) -> dict:
    import tpu_collide_torch as tt
    torch, device, cell, seed = (ctx["torch"], ctx["device"], ctx["cell"],
                                 ctx["seed"])
    tr = cell.traffic
    every = tr["episode_steps"]
    cfg = common.system_config(cell)
    fleet = common.fleet_state(cell, seed, device)
    cfg, _, gen, cert_worst, tries = certified(
        cfg, fleet, tr["certify_steps"], seed, torch, device)
    step = tt.make_step(cfg, backend="fused", device=device)
    common.sync(torch, device)

    clock = common.Clock(ctx["seconds"])
    setup_s = time.perf_counter() - ctx["t_start"]
    samples = common.sampler(cell, seed)
    attempted = failed = done = 0
    state = fleet
    clock.start()
    while clock.open():
        if attempted and attempted % every == 0:
            state = fleet
        slot = samples.offer()
        before = state
        drawn = gen.get_state() if slot is not None else None
        attempted += 1
        t = time.perf_counter()
        try:
            state, out = step(state, gen)
            of, ao, _ = read(torch, out)
        except RuntimeError:
            failed += 1
            continue
        clock.lat.append(time.perf_counter() - t)
        done += 1
        failed += bool(of or ao)
        if slot is not None:
            samples.put(slot, attempted - 1, (before, state, out, drawn))
    window_s = clock.close()
    peak = common.memory_peak(torch, device)
    if ctx["trace"]:
        window, profiled = profile(step, fleet, gen, tr, torch, device)
    del step, state
    n = cfg.num_objects
    lat_ms = [x * 1e3 for x in clock.lat]
    e2e = dict(obj_steps_per_s=n * done / window_s,
               step_ms_p95=percentile(lat_ms, 0.95),
               setup_s=setup_s)

    system = common.as_system(cfg)
    t_judge = time.perf_counter()
    readings, accs = [], {}
    for i, (before, after, out, drawn) in samples.sample():
        b, a = common.as_dict(before), common.as_dict(after)
        g = torch.Generator(device=device)
        g.set_state(drawn)
        accs[i] = physics.draw_acc(b, system["sim"], system["world"], g)
        r = physics.judge(b, a, accs[i], system["sim"], system["world"])
        r.update(compare.judge_detection(a, common.produced(out), system))
        readings.append(r)
    info = dict(k=cfg.alerts.max_alerts_per_object, certify_tries=tries,
                certify_worst=cert_worst, steps=done, window_s=window_s,
                episode_steps=every, episodes=-(-attempted // every),
                judged=[i for i, _ in samples.sample()],
                step_ms_median=percentile(lat_ms, 0.5),
                step_ms_q={f"p{round(p * 100)}": percentile(lat_ms, p)
                           for p in (0.1, 0.75, 0.9, 0.99, 1.0)},
                setup_s=setup_s,
                host=clock.host)
    res = dict(attempted=attempted, failed=failed, e2e=e2e,
               memory_peak_bytes=peak, checks=compare.worst(readings),
               info=info, samples=samples, accs=accs, system=system)
    if ctx["trace"]:
        s = traced(window, profiled, cfg, system)
        s["launched"] = links(window)
        res["trace"] = s
        info.update(traced_info(s, profiled, cfg))
    info["judge_s"] = time.perf_counter() - t_judge
    return res


def profile(step, fleet, gen, tr, torch, device) -> tuple:
    """`profile_steps` more steps under the profiler, from a fresh episode
    and reset every `episode_steps`, and the states that the first
    `work_steps` of them detected on."""
    window = Window(torch, device)
    profiled = []
    state = fleet
    window.start()
    for i in range(tr["profile_steps"]):
        if i and i % tr["episode_steps"] == 0:
            state = fleet
        state, out = step(state, gen)
        read(torch, out)
        if i < tr["work_steps"]:
            profiled.append(state)
    window.stop(tr["profile_steps"])
    return window, profiled


def traced_info(s: dict, states, cfg) -> dict:
    """What the traced run adds to the result's info: the detection
    kernel's device ms a step and its share of its roofline, and on the
    first profiled steps' states the rows whose hot top-up the program's
    rule asks for (its own _hot_rows choice: the candidates, the rows
    covered, and the pairs their stencils hold)."""
    from perfbench.harness import PKG, load_module
    from tpu_collide_torch.kernels import refine
    from tpu_collide_torch.kernels.cell_list import (build_cell_list,
                                                     stencil_runs)
    from tpu_collide_torch.kernels.fused_detect import fused_topk
    kernel = [(a, b) for n, a, b in s["device"] if KERNEL in n]
    roofline = load_module(PKG / "metrics" / (ROOFLINE + ".py"))
    out = {ROOFLINE: roofline.read(s),
           "detect_kernel_ms": (sum(b - a for a, b in kernel) * 1e-3
                                / s["units"] if s["units"] else None),
           "cover": []}
    for st in states:
        cl = build_cell_list(st, cfg)
        slots = fused_topk(cl, cfg, mode="hits")
        k = slots.keys.shape[1]
        hot = cl.own & (slots.qual > k)
        cand = (refine._reaching_rows(slots.keys, cl.own, hot,
                                      cfg.alerts.max_scene_alerts)
                if cfg.detect.hot_cover == "cut" else hot)
        covered, rows = refine._hot_rows(cl, cfg, slots.qual, k, cand)
        start, end = stencil_runs(cl, rows)
        out["cover"].append(dict(
            hot_rows=int(hot.sum()), candidates=int(cand.sum()),
            covered=int(covered.sum()), pairs=int((end - start).sum())))
    return out
