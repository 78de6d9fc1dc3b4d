"""The serve loop: ticks back to back over a Scene(cfg, state=fleet,
backend="fused") that holds the run's fleet, with vehicle ids v0 ... adopted
in set-up. A tick hands the Scene that tick's location reports
(`Scene.ingest`, one LocationData each, as the REST route builds them),
then `Scene.flush()` and `Scene.step()`, and ends when the alert manager has
processed the step's alerts. The tick's reports are turned into
LocationData once, in set-up, for a pool of `report_pool_ticks` ticks
that the run cycles through.

Set-up: the Scene, the fleet and `warmup_ticks` ticks of the same traffic,
in which the Scene's own self-heal (`_grow_slots`) raises the slots.

Window: ticks_per_s = ticks completed / window seconds; tick_ms_p95 over
every tick. A tick whose step certificate is not 0, or that raises, counts
in `failed`. The benchmark's own spans: the ingest and flush of each tick
(serve.ingest_ms) and, in the traced run only, a timer around the Scene's
alert_manager.process_batch (serve.alerts_ms). The traced run profiles
`profile_ticks` more ticks after the window.

Judge: a sample of the window's ticks drawn from the seed, each judged on
its ingest (the state after flush against the reference's ingest of the
tick's reports into the state before), its physics (the draws replayed
from a generator seeded as the Scene's, one step's draws a tick since the
first warm-up tick) and its detection (as the step loop's); then the alert
manager's registry after the run against the reference's upserts of every
listed alert of every tick.
"""
from __future__ import annotations

import time

from perfbench.drivers import common
from perfbench.fleet import make_reports
from perfbench.reference import compare, physics, serving
from perfbench.stats import percentile
from perfbench.trace import Window, summary


def locations(reports: dict, t: int, names: list, sizes, types, otypes):
    """[(LocationData, size, vehicle type name)] of tick t's reports."""
    from tpu_collide_torch.core.types import LocationData, Position, Vector
    slots = reports["slot"][t]
    kinds = otypes[slots].tolist()
    return [(LocationData(vehicle_id=names[s], position=Position(*p),
                          velocity=Vector(*v), acceleration=Vector(),
                          heading=h), sizes[k], types[k])
            for s, p, v, h, k in zip(slots.tolist(),
                                     reports["pos"][t].tolist(),
                                     reports["vel"][t].tolist(),
                                     reports["heading"][t].tolist(), kinds)]


def tick_reports(reports: dict, t: int) -> dict:
    return {k: reports[k][t] for k in ("slot", "pos", "vel", "heading")}


class Timed:
    """A callable that adds its target's wall seconds to `total`."""

    def __init__(self, fn):
        self.fn, self.total = fn, 0.0

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            self.total += time.perf_counter() - t


def run(ctx: dict) -> dict:
    from tpu_collide_torch.api.scene import Scene
    torch, device, cell, seed = (ctx["torch"], ctx["device"], ctx["cell"],
                                 ctx["seed"])
    tr, conf = cell.traffic, cell.config
    cfg = common.system_config(cell)
    n = cfg.num_objects
    fleet = common.fleet_state(cell, seed, device)
    otypes = fleet.otype.cpu().numpy()
    names = [f"v{i}" for i in range(n)]
    sizes, types = conf["vehicle_sizes"], conf["vehicle_types"]
    pool = tr["report_pool_ticks"]
    reports = make_reports(conf["system"], tr["reports"], pool, seed)
    scene = Scene(cfg, state=fleet, backend="fused", device=device)
    scene.adopt_fleet(fleet, names)
    del fleet
    outs = []                       # every tick's StepOutput, in order
    ingest_s = [0.0]

    def tick(locs) -> tuple:
        """(state before, after flush, after step, output) of one tick."""
        s0 = scene.state
        t0 = time.perf_counter()
        for loc, size, vtype in locs:
            scene.ingest(loc, size=size, vtype=vtype)
        scene.flush()
        ingest_s[0] += time.perf_counter() - t0
        s1 = scene.state
        out = scene.step()
        outs.append(out)
        return s0, s1, scene.state, out

    # every tick's LocationData built once, before the window
    book = [locations(reports, t, names, sizes, types, otypes)
            for t in range(pool)]
    t = 0
    for _ in range(tr["warmup_ticks"]):
        tick(book[t % pool])
        t += 1
    common.sync(torch, device)
    warm_k = scene.cfg.alerts.max_alerts_per_object
    ingest_s[0] = 0.0

    clock = common.Clock(ctx["seconds"])
    setup_s = time.perf_counter() - ctx["t_start"]
    samples = common.sampler(cell, seed)
    timed = None
    if ctx["trace"]:
        timed = Timed(scene.alert_manager.process_batch)
        scene.alert_manager.process_batch = timed
    first = len(outs)
    attempted = failed = done = 0
    clock.start()
    while clock.open():
        slot = samples.offer()
        attempted += 1
        t0 = time.perf_counter()
        try:
            s0, s1, s2, out = tick(book[t % pool])
        except RuntimeError:
            failed += 1
            t += 1
            continue
        clock.lat.append(time.perf_counter() - t0)
        done += 1
        if slot is not None:
            samples.put(slot, attempted - 1, (
                s0, s1, s2, out, tick_reports(reports, t % pool), t))
        t += 1
    window_s = clock.close()
    peak = common.memory_peak(torch, device)
    spans = dict(ingest_ms=1e3 * ingest_s[0] / max(done, 1),
                 alerts_ms=1e3 * timed.total / max(done, 1) if timed else 0)
    certs = torch.stack([torch.stack([o.overflow.to(torch.int64),
                                      o.alert_overflow.to(torch.int64)])
                         for o in outs[first:]]).cpu() if done else None
    failed += int((certs > 0).any(1).sum()) if done else 0
    if ctx["trace"]:
        window = Window(torch, device)
        window.start()
        for _ in range(tr["profile_ticks"]):
            tick(book[t % pool])
            t += 1
        window.stop(tr["profile_ticks"])
    lat_ms = [x * 1e3 for x in clock.lat]
    e2e = dict(ticks_per_s=done / window_s,
               tick_ms_p95=percentile(lat_ms, 0.95), setup_s=setup_s)
    am = scene.alert_manager
    got_reg = ({(a.vehicle_id, a.other_vehicle_id):
                (a.risk_level, a.time_to_collision, a.priority)
                for a in am.alerts.values()},
               am.stats["created"], am.stats["updated"],
               len({a.id for a in am.alerts.values()}))
    k_end = scene.cfg.alerts.max_alerts_per_object
    batches = [host_batch(o) for o in outs]
    del scene

    system = common.as_system(cfg)
    is3d = cfg.world.is_3d
    t_judge = time.perf_counter()
    drawn = scene_draws(samples, n, system, torch, device)
    readings, accs = [], {}
    for i, (s0, s1, s2, out, rep, t) in samples.sample():
        b, m, a = (common.as_dict(s) for s in (s0, s1, s2))
        r = dict(ingest_err=serving.judge_ingest(
            serving.ingest(b, rep, sizes, otypes, is3d), m))
        redraw, new = drawn[t]
        accs[i] = torch.where(redraw, new, m["acc"])
        r.update(physics.judge(m, a, accs[i], system["sim"],
                               system["world"]))
        r.update(compare.judge_detection(
            a, common.produced(out), system))
        readings.append(r)
    checks = compare.worst(readings)
    checks["manager_miss"] = serving.judge_registry(
        serving.registry(batches, lambda o: names[int(o)]), got_reg)
    info = dict(k_warm=warm_k, k_end=k_end, ticks=done, window_s=window_s,
                judged=[i for i, _ in samples.sample()],
                tick_ms_median=percentile(lat_ms, 0.5),
                tick_ms_first_tenth=tenth(lat_ms, 0),
                tick_ms_last_tenth=tenth(lat_ms, 9),
                alerts_active=len(got_reg[0]), setup_s=setup_s,
                host=clock.host)
    res = dict(attempted=attempted, failed=failed, e2e=e2e,
               memory_peak_bytes=peak, checks=checks, info=info,
               samples=samples, accs=accs, system=system, batches=batches,
               names=names, otypes=otypes, got_registry=got_reg)
    if ctx["trace"]:
        res["trace"] = dict(summary(window), **spans)
    info["judge_s"] = time.perf_counter() - t_judge
    return res


def scene_draws(samples, n: int, system: dict, torch, device) -> dict:
    """{tick: (redraw, new)} of the judged ticks, from a generator seeded as
    the Scene's and drawn from once a tick, in order, from the first tick
    on."""
    want = {item[-1] for _, item in samples.sample()}
    gen = torch.Generator(device=device).manual_seed(physics.SCENE_SEED)
    out = {}
    for t in range(max(want, default=-1) + 1):
        d = physics.draws(n, system["sim"], system["world"], gen)
        if t in want:
            out[t] = d
    return out


def tenth(lat_ms: list, which: int) -> float | None:
    """The median of one tenth of the window's ticks, in order."""
    m = len(lat_ms) // 10
    part = lat_ms[which * m:(which + 1) * m]
    return percentile(part, 0.5) if part else None


def host_batch(out) -> dict:
    a = out.alerts
    return {f: getattr(a, f).cpu().numpy()
            for f in ("valid", "vehicle_oid", "other_oid", "risk", "ttc",
                      "priority")}
