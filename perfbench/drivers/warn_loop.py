"""The warning loop: the upstream's EarlyWarningSystem (warning_system.py:
680-714) over a fleet that reports at 10 Hz. A closed loop of ticks of
sim.dt (0.1 s); each tick is one fused step (tpu_collide_torch.make_step(
cfg, backend="fused")), the trajectory ring's update on the step's state
at the tick's time (detect.predict.update_history) and one host read of
the step's overflow, alert_overflow and num_risks; every
`predict_every`-th tick (5: 2 Hz) also runs engine.make_predict's call on
that state and ring, its list and certificate copied to the host once, as
Scene.predict does. The configuration's "predict" section gives the ring's
length, the offsets, the sub-window, merge_k, the first k_slots and r_cap.

Set-up: the fleet from the seed on the card; the step's slots by
step_loop's certification rule on `certify_steps` steps; then `fill_ticks`
ticks fill the ring (100 ticks: 100 points), and the last
`certify_predicts` predict ticks of the fill certify the predict slots by
Scene.predict's rule: while slot_oflow is not 0, k_slots doubles, up to
the kernel's 32, and the tick's prediction runs again. The fill warms
every shape.

Window: step_ms_p95 = the 95th percentile of every tick's host time (the
predict ticks, a fifth of all, hold it). A tick that raises, or whose
certificate is not 0 (the step's overflow or alert_overflow, the
prediction's overflow or slot_oflow), counts in `failed`. The traced run
profiles `profile_ticks` more ticks.

Judge: `judged` predict ticks drawn from the seed, each from the program's
own state and ring before it: the physics by reference/physics, the
step's detection by reference/detect (as step_loop's), the ring against
reference/predict's update, and the predicted list and count against
reference/predict's prediction on that ring.
"""
from __future__ import annotations

import time

from perfbench.drivers import common
from perfbench.drivers.step_loop import K_CEILING, certified, read
from perfbench.launched import links
from perfbench.reference import compare, physics
from perfbench.reference import predict as ref_predict
from perfbench.roofline_predict import predict_bound
from perfbench.stats import percentile
from perfbench.trace import Window, summary


class Ticks:
    """The loop's state (the fleet, its generator, the ring, the tick) and
    one tick of it."""

    def __init__(self, step, predictor, k_slots, state, hist, gen, dt, every,
                 torch):
        self.step, self.predictor, self.k_slots = step, predictor, k_slots
        self.predict = predictor(k_slots)
        self.state, self.hist, self.gen = state, hist, gen
        self.dt, self.every, self.torch = dt, every, torch
        self.tick = 0

    def time(self) -> float:
        return self.tick * self.dt

    def is_predict(self) -> bool:
        return (self.tick + 1) % self.every == 0

    def fetch(self, to_host) -> dict:
        """The prediction on the current state and ring, copied to the host
        once: {engine.Predicted's field: numpy}."""
        res = self.predict(self.state, self.hist)
        return dict(zip(res._fields, to_host(list(res))))

    def run(self, update_history, to_host) -> tuple:
        """One tick: ((overflow, alert_overflow, num_risks) of the step,
        its StepOutput, the fetched prediction or None)."""
        self.tick += 1
        self.state, out = self.step(self.state, self.gen)
        self.hist = update_history(self.hist, self.state, self.time())
        counters = read(self.torch, out)
        got = self.fetch(to_host) if self.tick % self.every == 0 else None
        return counters, out, got

    def certify(self, got: dict, to_host) -> list:
        """Scene.predict's rule on the current tick, whose prediction was
        `got`: while slot_oflow is not 0 and k_slots is below the kernel's
        K_MAX, double k_slots and predict again. The slot_oflow of each
        attempt."""
        seen = [int(got["slot_oflow"])]
        while int(got["slot_oflow"]) > 0 and self.k_slots < K_CEILING:
            self.k_slots = min(2 * self.k_slots, K_CEILING)
            self.predict = self.predictor(self.k_slots)
            got = self.fetch(to_host)
            seen.append(int(got["slot_oflow"]))
        return seen


def uncertified(counters, got) -> bool:
    return bool(counters[0] or counters[1] or (got is not None and (
        int(got["overflow"]) or int(got["slot_oflow"]))))


def run(ctx: dict) -> dict:
    # the prediction's entry first: a program without it fails at once
    from tpu_collide_torch.engine import make_predict
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.device import to_host
    from tpu_collide_torch.detect.predict import (empty_history,
                                                  predict_offsets,
                                                  sub_window_config,
                                                  update_history)
    torch, device, cell, seed = (ctx["torch"], ctx["device"], ctx["cell"],
                                 ctx["seed"])
    tr = cell.traffic
    pc = cell.config["predict"]
    cfg = common.system_config(cell)
    fleet = common.fleet_state(cell, seed, device)
    cfg, state, gen, cert_worst, tries = certified(
        cfg, fleet, tr["certify_steps"], seed, torch, device)
    del fleet

    def predictor(k):
        return make_predict(cfg, pc["horizon"], pc["step"],
                            sub_window=pc["sub_window"],
                            merge_k=pc["merge_k"], k_slots=k,
                            r_cap=pc["r_cap"], device=device)

    loop = Ticks(tt.make_step(cfg, backend="fused", device=device),
                 predictor, pc["k_slots"], state,
                 empty_history(cfg.num_objects, pc["history_points"],
                               device=device), gen, cfg.sim.dt,
                 tr["predict_every"], torch)
    del state
    fill_worst, predict_seen = 0, []
    certify_from = tr["fill_ticks"] - tr["predict_every"] * \
        tr["certify_predicts"]
    for _ in range(tr["fill_ticks"]):
        counters, _, got = loop.run(update_history, to_host)
        fill_worst = max(fill_worst, counters[1])
        if got is not None and loop.tick > certify_from:
            predict_seen.append(loop.certify(got, to_host))
    common.sync(torch, device)

    clock = common.Clock(ctx["seconds"])
    setup_s = time.perf_counter() - ctx["t_start"]
    samples = common.sampler(cell, seed)
    attempted = failed = done = 0
    pred_lat, tick_lat, counts, trunc = [], [], [], 0
    clock.start()
    while clock.open():
        slot = samples.offer() if loop.is_predict() else None
        before, hist_before = loop.state, loop.hist
        drawn = loop.gen.get_state() if slot is not None else None
        attempted += 1
        t = time.perf_counter()
        try:
            counters, out, got = loop.run(update_history, to_host)
        except RuntimeError:
            failed += 1
            continue
        lat = time.perf_counter() - t
        clock.lat.append(lat)
        (pred_lat if got is not None else tick_lat).append(lat * 1e3)
        done += 1
        failed += uncertified(counters, got)
        if got is not None:
            trunc = max(trunc, int(got["slot_trunc"]))
            counts.append(int(got["count"]))
        if slot is not None:
            samples.put(slot, attempted - 1, (
                before, hist_before, drawn, loop.state, out, loop.hist, got,
                loop.time()))
    window_s = clock.close()
    peak = common.memory_peak(torch, device)
    if ctx["trace"]:
        window, profiled = profile(loop, tr, update_history, to_host, torch,
                                   device)
    k_slots, points = loop.k_slots, loop.hist.capacity
    del loop
    lat_ms = [x * 1e3 for x in clock.lat]
    e2e = dict(step_ms_p95=percentile(lat_ms, 0.95), setup_s=setup_s)

    system = common.as_system(cfg)
    t_judge = time.perf_counter()
    readings, accs = [], {}
    for i, item in samples.sample():
        before, hist_before, drawn, after, out, hist_after, got, at = item
        b, a = common.as_dict(before), common.as_dict(after)
        g = torch.Generator(device=device)
        g.set_state(drawn)
        accs[i] = physics.draw_acc(b, system["sim"], system["world"], g)
        r = physics.judge(b, a, accs[i], system["sim"], system["world"])
        r.update(compare.judge_detection(a, common.produced(out), system))
        r.update(ref_predict.judge(a, ring(hist_before), ring(hist_after), at,
                                   produced(got, torch, device), system,
                                   pc))
        readings.append(r)
    judged = [i for i, _ in samples.sample()]
    info = dict(
        k=cfg.alerts.max_alerts_per_object, certify_tries=tries,
        certify_worst=cert_worst, fill_worst=fill_worst,
        k_slots=k_slots, predict_certify=predict_seen, ticks=done,
        window_s=window_s, judged=judged,
        history_points=points,
        offsets=len(predict_offsets(pc["horizon"], pc["step"])),
        sub_steps=sub_window_config(cfg.detect,
                                    pc["sub_window"]).num_time_steps,
        predict_calls=len(pred_lat), slot_trunc_max=trunc,
        count_median=percentile(counts, 0.5) if counts else None,
        step_ms_median=percentile(lat_ms, 0.5),
        step_ms_q={f"p{round(p * 100)}": percentile(lat_ms, p)
                   for p in (0.1, 0.75, 0.9, 0.99, 1.0)},
        predict_tick_ms_median=(percentile(pred_lat, 0.5) if pred_lat
                                else None),
        plain_tick_ms_median=(percentile(tick_lat, 0.5) if tick_lat
                              else None),
        setup_s=setup_s, host=clock.host)
    res = dict(attempted=attempted, failed=failed, e2e=e2e,
               memory_peak_bytes=peak, checks=compare.worst(readings),
               info=info, samples=samples, accs=accs, system=system,
               pred=pc)
    if ctx["trace"]:
        res["trace"] = traced(window, profiled, cfg, system, pc, k_slots)
    info["judge_s"] = time.perf_counter() - t_judge
    return res


def ring(hist) -> dict:
    """The program's ring as reference/predict reads it."""
    return ref_predict.unroll(hist.pos, hist.t, hist.count, hist.head)


def produced(got: dict, torch, device) -> dict:
    """A fetched prediction as reference/predict.judge reads it."""
    out = {f: torch.as_tensor(got[f], device=device)
           for f in ("risk", "vehicle_oid", "other_oid", "ttc")}
    out["count"] = int(got["count"])
    return out


def profile(loop: Ticks, tr, update_history, to_host, torch,
            device) -> tuple:
    """`profile_ticks` more ticks under the profiler, and the (state,
    ring) of the first `work_calls` predictions."""
    window = Window(torch, device)
    profiled = []
    window.start()
    for _ in range(tr["profile_ticks"]):
        _, _, got = loop.run(update_history, to_host)
        if got is not None and len(profiled) < tr["work_calls"]:
            profiled.append((loop.state, loop.hist))
    window.stop(tr["profile_ticks"])
    return window, profiled


def work(state, hist, cfg, system, pred, k_slots: int) -> dict:
    """The counts of roofline_predict.predict_bound, by the reference, on
    the state and ring a prediction ran on."""
    d = common.as_dict(state)
    ref = ref_predict.predict(d, ring(hist), system, pred)
    return dict(alive=int(d["alive"].sum()), cells=cfg.num_cells,
                k=k_slots, is3d=cfg.world.is_3d,
                **{f: ref[f] for f in ("rows", "walked", "pairs", "samples",
                                       "hits")})


def traced(window, profiled, cfg, system, pred, k_slots: int) -> dict:
    """The trace summary, each device operation's link to the host
    operation that launched it, and the predict kernel's bound on the
    states of the first profiled predictions (`predict_bounds_ms`)."""
    s = summary(window)
    s["launched"] = links(window)
    s["work"] = [work(st, h, cfg, system, pred, k_slots)
                 for st, h in profiled]
    s["predict_bounds_ms"] = [predict_bound(w)["bound_ms"]
                              for w in s["work"]]
    return s
