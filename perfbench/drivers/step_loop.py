"""The step loop: the fused stepper of tpu_collide_torch.make_step(cfg,
backend="fused") flat out on the run's fleet, closed (the next step starts
when the host has read the last one's overflow, alert_overflow and
num_risks).

Set-up: the fleet from the seed on the card; the slot count adopted by
the certification rule (frozen copy of chip_smoke.certified, bench.py:199-
226: replay the first `certify_steps` steps from the fleet and, while the
worst alert_overflow is not 0, raise max_alerts_per_object by it, at most
twice, up to the kernel's 32); those steps also warm every shape.

Window: obj_steps_per_s = fleet size x steps completed / window seconds;
step_ms_p95 over every step. A step with a non-zero certificate, or one
that raises, counts in `failed`. The traced run profiles `profile_steps`
more steps after the window.

Judge: a sample of the window's steps drawn from the seed; for each, the
state after it against the reference's physics from the state before it,
with the draws of a generator identical to the one handed to the step
(its state kept before the step), and its counters and scene alert list
against the reference's detection on the state it detected on.
"""
from __future__ import annotations

import dataclasses
import time

from perfbench.drivers import common
from perfbench.fleet import STEP_STREAM
from perfbench.reference import compare, detect, physics
from perfbench.roofline import detect_bound
from perfbench.stats import percentile
from perfbench.trace import Window, summary

K_CEILING = 32      # the detection kernel's most slots (fused_detect.K_MAX)
ADOPT_TRIES = 2     # bench.py's retries


def read(torch, out) -> tuple:
    """(overflow, alert_overflow, num_risks) of a step, in one copy."""
    v = torch.stack([out.overflow.to(torch.int64),
                     out.alert_overflow.to(torch.int64),
                     out.num_risks.to(torch.int64)]).tolist()
    return v[0], v[1], v[2]


def with_k(cfg, k):
    return cfg.replace(alerts=dataclasses.replace(
        cfg.alerts, max_alerts_per_object=k))


def certified(cfg, fleet, steps, seed, torch, device):
    """(cfg adopted, state and generator after its replay, worst
    alert_overflow, attempts)."""
    import tpu_collide_torch as tt

    def replay(cfg):
        gen = torch.Generator(device=device).manual_seed(
            seed * 16 + STEP_STREAM)
        step = tt.make_step(cfg, backend="fused", device=device)
        state, worst = fleet, 0
        for _ in range(steps):
            state, out = step(state, gen)
            worst = max(worst, read(torch, out)[1])
        return state, gen, worst

    state, gen, worst = replay(cfg)
    tries = 1
    while worst > 0 and tries <= ADOPT_TRIES:
        k = cfg.alerts.max_alerts_per_object
        k_new = min(K_CEILING, k + worst)
        if k_new == k:
            break
        cfg = with_k(cfg, k_new)
        state, gen, worst = replay(cfg)
        tries += 1
    return cfg, state, gen, worst, tries


def run(ctx: dict) -> dict:
    import tpu_collide_torch as tt
    torch, device, cell, seed = (ctx["torch"], ctx["device"], ctx["cell"],
                                 ctx["seed"])
    tr = cell.traffic
    cfg = common.system_config(cell)
    fleet = common.fleet_state(cell, seed, device)
    cfg, state, gen, cert_worst, tries = certified(
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
        r.update(compare.judge_detection(a, common.produced(out), system))
        readings.append(r)
    info = dict(k=cfg.alerts.max_alerts_per_object, certify_tries=tries,
                certify_worst=cert_worst, steps=done, window_s=window_s,
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


def profile(step, state, gen, tr, torch, device) -> tuple:
    """`profile_steps` more steps after the window under the profiler, and
    the states of the first `work_steps` of them."""
    window = Window(torch, device)
    profiled = []
    window.start()
    for i in range(tr["profile_steps"]):
        state, out = step(state, gen)
        read(torch, out)
        if i < tr["work_steps"]:
            profiled.append(state)
    window.stop(tr["profile_steps"])
    return window, profiled


def traced(window, states, cfg, system) -> dict:
    """The trace summary with the detection kernel's work on the states of
    the first profiled steps (it changes by far less than a percent from
    one step to the next)."""
    s = summary(window)
    k = cfg.alerts.max_alerts_per_object
    s["work"] = []
    for st in states:
        d = common.as_dict(st)
        ref = detect.detect(d, system, qualifying=False)
        s["work"].append(dict(
            alive=int(d["alive"].sum()), cells=cfg.num_cells, k=k,
            is3d=cfg.world.is_3d,
            walked=detect.stencil_counts(d["pos"], d["alive"],
                                         system["world"], cfg.grid.cell_size),
            stage1=ref["stage1"], stage2=ref["stage2"]))
    s["bounds_ms"] = [detect_bound(w)["bound_ms"] for w in s["work"]]
    return s
