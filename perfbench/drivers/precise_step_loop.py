"""The precise step loop: step_loop's closed loop (the next step starts when
the host has read the last one's overflow, alert_overflow and num_risks)
over the fused stepper of tpu_collide_torch.make_step(cfg,
backend="fused") with detect.mode "precise": the detection kernel in
survivors mode, the survivor compaction and the sampled sweep.

Set-up: the fleet from the seed on the card; the survivor cap and
survivor_k adopted by bench.py's precise branch (bench.py:179-226, frozen
here as chip_smoke.certified runs it): the survivor need probed over the
first `certify_steps` steps on the run's fleet and generator
(kernels/tune.measure_survivor_need), the cap survivor_cap_for(need); then
those steps replayed and, while the worst alert_overflow is not 0, at most
twice, survivor_k raised by it up to the kernel's 32 and the cap doubled.
The replays warm every shape.

Window: as step_loop's (obj_steps_per_s, step_ms_p95; a step with a
non-zero certificate, or one that raises, counts in `failed`). The traced
run profiles `profile_steps` more steps after the window.

Judge: as step_loop's, the physics by reference/physics and the detection
by reference/precise.judge (the sampled stage 3).
"""
from __future__ import annotations

import dataclasses
import time

from perfbench.drivers import common
from perfbench.drivers.step_loop import ADOPT_TRIES, K_CEILING, profile, read
from perfbench.fleet import STEP_STREAM
from perfbench.launched import links
from perfbench.reference import compare, physics, precise
from perfbench.reference.detect import stencil_counts
from perfbench.roofline_precise import survivors_bound, sweep_bound
from perfbench.stats import percentile
from perfbench.trace import summary


def with_survivors(cfg, k: int, cap: int):
    return cfg.replace(detect=dataclasses.replace(
        cfg.detect, survivor_k=k, precise_survivor_cap=cap))


def certified(cfg, fleet, steps, seed, torch, device):
    """(cfg adopted, state and generator after its replay, worst
    alert_overflow, attempts, probed survivor need)."""
    import tpu_collide_torch as tt
    from tpu_collide_torch.kernels.tune import (measure_survivor_need,
                                                survivor_cap_for)

    def generator():
        return torch.Generator(device=device).manual_seed(
            seed * 16 + STEP_STREAM)

    def replay(cfg):
        gen = generator()
        step = tt.make_step(cfg, backend="fused", device=device)
        state, worst = fleet, 0
        for _ in range(steps):
            state, out = step(state, gen)
            worst = max(worst, read(torch, out)[1])
        return state, gen, worst

    need = measure_survivor_need(cfg, fleet, generator(), steps)
    cfg = with_survivors(cfg, cfg.detect.survivor_k, survivor_cap_for(need))
    state, gen, worst = replay(cfg)
    tries = 1
    while worst > 0 and tries <= ADOPT_TRIES:
        cfg = with_survivors(
            cfg, min(K_CEILING, cfg.detect.survivor_k + worst),
            2 * cfg.survivor_cap)
        state, gen, worst = replay(cfg)
        tries += 1
    return cfg, state, gen, worst, tries, need


def run(ctx: dict) -> dict:
    """step_loop.run (step_loop.py:80-151, copied) with this module's
    certification, the survivor fields under `info` and the precise
    judge."""
    import tpu_collide_torch as tt
    torch, device, cell, seed = (ctx["torch"], ctx["device"], ctx["cell"],
                                 ctx["seed"])
    tr = cell.traffic
    cfg = common.system_config(cell)
    fleet = common.fleet_state(cell, seed, device)
    cfg, state, gen, cert_worst, tries, need = certified(
        cfg, fleet, tr["certify_steps"], seed, torch, device)
    del fleet
    step = tt.make_step(cfg, backend="fused", device=device)
    common.sync(torch, device)

    clock = common.Clock(ctx["seconds"])
    setup_s = time.perf_counter() - ctx["t_start"]
    samples = common.sampler(cell, seed)
    attempted = failed = done = 0
    clock.start()
    while clock.open():
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
        window, profiled = profile(step, state, gen, tr, torch, device)
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
        r.update(precise.judge(a, common.produced(out), system))
        readings.append(r)
    info = dict(survivor_k=cfg.detect.survivor_k,
                survivor_cap=cfg.survivor_cap, survivor_need=need,
                certify_tries=tries, certify_worst=cert_worst, steps=done,
                window_s=window_s,
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
        res["trace"] = traced(window, profiled, cfg, system)
    info["judge_s"] = time.perf_counter() - t_judge
    return res


def work(state, cfg, system) -> dict:
    """The counts the bounds of roofline_precise.py take, by the reference,
    on the state a step detected on."""
    d = common.as_dict(state)
    ref = precise.detect(d, system, qualifying=False)
    return dict(alive=int(d["alive"].sum()), cells=cfg.num_cells,
                k=cfg.detect.survivor_k, is3d=cfg.world.is_3d,
                walked=stencil_counts(d["pos"], d["alive"], system["world"],
                                      cfg.grid.cell_size),
                stage1=ref["stage1"], stage2=ref["stage2"],
                samples=int(ref["samples"].sum()))


def traced(window, states, cfg, system) -> dict:
    """The trace summary, each device operation's link to the host
    operation that launched it, and the bounds of the detection kernel in
    survivors mode (`bounds_ms`) and of the sweep (`sweep_bounds_ms`) on
    the states of the first profiled steps."""
    s = summary(window)
    s["launched"] = links(window)
    s["work"] = [work(st, cfg, system) for st in states]
    s["bounds_ms"] = [survivors_bound(w)["bound_ms"] for w in s["work"]]
    s["sweep_bounds_ms"] = [sweep_bound(w)["bound_ms"] for w in s["work"]]
    return s
