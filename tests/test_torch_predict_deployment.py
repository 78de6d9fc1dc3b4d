"""The port's trajectory prediction (engine.make_predict: the trajectory
classes from 100-point rings, the predict kernel's plain version, the
recompute, the merge per pair, the certificate and the compaction) against
the benchmark's plain reference of the upstream's prediction model
(perfbench/reference/predict.py), on the CPU at the density of the
1M-drone warn deployment (perfbench/configs/drones_1m_3d_warn.json).

The fleets are cut to N drones in a world shrunk to keep the density; the
rings are filled over 100 ticks of the port's integrator and fused step,
as the warn loop fills them. The limits are the warn cell's own
(perfbench/limits/drones_1m_3d_warn.warn_2hz.json). Also: the reference's
imports, the predict kernel's bound against a hand count, the cell's
readers on synthetic traces, the prediction's spans, and a whole run of
the cell at a small size.
"""
import ast
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, roofline_predict
from perfbench.drivers import common, warn_loop
from perfbench.fleet import make_fleet
from perfbench.reference import predict as rp
from tpu_collide_torch import make_step
from tpu_collide_torch.api.scene import Scene
from tpu_collide_torch.core import device as core_device
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.detect import predict as tp
from tpu_collide_torch.detect.pipeline import (_norm, _pair_safe_distance,
                                               _precise_sweep, _risk_score)
from tpu_collide_torch.engine import make_predict
from tpu_collide_torch.kernels import refine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "drones_1m_3d_warn.warn_2hz"
CONF = json.loads((ROOT / "perfbench" / "configs" / "drones_1m_3d_warn.json")
                  .read_text())
PC = CONF["predict"]
LIMITS = json.loads((ROOT / "perfbench" / "limits" / f"{CELL}.json")
                    .read_text())
PRED_LIMITS = {k: v for k, v in LIMITS.items()
               if k == "ring_err" or k.startswith("pred_")}
CPU = torch.device("cpu")
N = 2000
SEEDS = [3, 2 ** 31 + 5]
TICKS = PC["history_points"]


def small_system(n: int = N) -> dict:
    """The deployment's system at n drones, the world shrunk to keep the
    density."""
    s = json.loads(json.dumps(CONF["system"]))
    f = (n / s["num_objects"]) ** (1 / 3)
    s["world"]["hi"] = [h * f for h in s["world"]["hi"]]
    s["num_objects"] = n
    return s


def config(system: dict) -> SystemConfig:
    return SystemConfig.from_json(json.dumps(system))


def fleet(seed: int, system: dict) -> ObjectState:
    return ObjectState(**make_fleet(system, CONF["vehicle_sizes"],
                                    {"speed": [5.0, 20.0]}, seed, CPU))


@dataclasses.dataclass
class Filled:
    cfg: SystemConfig
    state: ObjectState      # after the last tick's step
    before: dict            # {points: the ring before the last tick}
    after: dict             # {points: the ring after it}
    time: float             # the last tick's time


@pytest.fixture(scope="module")
def filled():
    """{seed: Filled}: TICKS ticks of the fused step, each followed by the
    update of a 100-point ring and of a 16-point one."""
    system = small_system()
    cfg = config(system)
    step = make_step(cfg, backend="fused", device=CPU)
    out = {}
    for seed in SEEDS:
        state, gen = fleet(seed, system), torch.Generator().manual_seed(seed)
        rings = {p: tp.empty_history(N, p, device=CPU) for p in (TICKS, 16)}
        for tick in range(1, TICKS + 1):
            state, _ = step(state, gen)
            before = dict(rings)
            rings = {p: tp.update_history(h, state, tick * cfg.sim.dt)
                     for p, h in rings.items()}
        out[seed] = Filled(cfg, state, before, rings, TICKS * cfg.sim.dt)
    return out


def predictor(cfg, **kw):
    args = dict(sub_window=PC["sub_window"], merge_k=PC["merge_k"],
                k_slots=PC["k_slots"], r_cap=PC["r_cap"], device=CPU)
    args.update(kw)
    return make_predict(cfg, PC["horizon"], PC["step"], **args)


def as_produced(got) -> dict:
    return dict(risk=got.risk, vehicle_oid=got.vehicle_oid,
                other_oid=got.other_oid, ttc=got.ttc, count=int(got.count))


def judged(f: Filled, got, points: int = TICKS, r_cap: int = PC["r_cap"]):
    return rp.judge(common.as_dict(f.state), warn_loop.ring(f.before[points]),
                    warn_loop.ring(f.after[points]), f.time,
                    as_produced(got), common.as_system(f.cfg),
                    dict(PC, r_cap=r_cap))


@pytest.mark.parametrize("r_cap", [PC["r_cap"], 64])
@pytest.mark.parametrize("seed", SEEDS)
def test_make_predict_matches_reference(filled, seed, r_cap):
    f = filled[seed]
    got = predictor(f.cfg, r_cap=r_cap)(f.state, f.after[TICKS])
    assert int(got.overflow) == int(got.slot_oflow) == 0
    assert int(got.count) > 100
    if r_cap < int(got.count):
        assert int((got.risk >= 0).sum()) == r_cap
    r = judged(f, got, r_cap=r_cap)
    assert harness.verdict(r, PRED_LIMITS)[0], r


def test_rings_hold_the_configured_points(filled):
    f = filled[SEEDS[0]]
    assert f.after[TICKS].capacity == TICKS == 100
    assert int(f.after[TICKS].count.min()) == TICKS
    assert tp.predict_offsets(PC["horizon"], PC["step"]) == [
        0.5 * k for k in range(20)]
    assert tp.sub_window_config(f.cfg.detect,
                                PC["sub_window"]).num_time_steps == 10


def test_scene_predict_gives_make_predicts_list():
    system = small_system()
    cfg = config(system)
    sc = Scene(cfg, state=fleet(11, system), backend="fused", device=CPU,
               history_points=TICKS)
    for _ in range(12):
        sc.step()
        sc.record_trajectories()
    assert sc._traj.capacity == TICKS
    risks = sc.predict()
    k = sc.last_predict["k_slots"]
    got = make_predict(cfg, 10.0, 0.5, k_slots=k, r_cap=min(
        cfg.alerts.max_scene_alerts, N * 32), device=CPU)(sc.state, sc._traj)
    listed = int((got.risk >= 0).sum())
    assert len(risks) == listed > 0
    assert sc.last_predict["risks"] == int(got.count)
    want = [(str(int(v)), str(int(o)), float(r), float(t)) for v, o, r, t in
            zip(got.vehicle_oid[:listed], got.other_oid[:listed],
                got.risk[:listed], got.ttc[:listed])]
    assert [(x.vehicle_id, x.other_vehicle_id, x.risk_level,
             x.time_to_collision) for x in risks] == want


def classes_constant_velocity(hist):
    return torch.full((hist.pos.shape[0],), tp.CLASS_CONST_VEL,
                      dtype=torch.int32)


def candidate_not_advanced(o, c, pred, t, det, sub_det):
    """predict_pair_risks with the candidate left at its current position
    (no advance to the offset)."""
    ok = (o.alive & c.alive & (o.id != c.id)
          & (_norm(c.pos - pred) <= det.search_radius))
    safe = _pair_safe_distance(o.size, c.size, det)
    sep_vel = c.vel - o.vel
    hit, t_hit, d_hit = _precise_sweep(c.pos - pred, sep_vel, c.acc - o.acc,
                                       safe, sub_det)
    hit = hit & ok
    zero = torch.zeros_like(t_hit)
    inf = torch.full_like(t_hit, float("inf"))
    risk = _risk_score(torch.where(hit, d_hit, zero),
                       torch.where(hit, t_hit, zero), _norm(sep_vel),
                       o.heading, c.heading, o.otype, c.otype, safe, det)
    return (hit, torch.where(hit, risk, zero),
            torch.where(hit, t_hit + t, inf), torch.where(hit, d_hit, inf))


def offsets_shifted(horizon, step):
    return [o + step for o in tp.predict_offsets(horizon, step)]


@pytest.mark.parametrize("fault", [
    "constant_velocity", "not_advanced", "offsets_shifted",
    "half_sub_window", "ring_16", "risk_altered", "total_altered"])
def test_fault_is_not_correct(filled, monkeypatch, fault):
    f = filled[SEEDS[0]]
    points, kw = TICKS, {}
    if fault == "constant_velocity":
        monkeypatch.setattr(refine, "classify_trajectories",
                            classes_constant_velocity)
    elif fault == "not_advanced":
        monkeypatch.setattr(refine, "predict_pair_risks",
                            candidate_not_advanced)
    elif fault == "offsets_shifted":
        monkeypatch.setattr(refine, "predict_offsets", offsets_shifted)
    elif fault == "half_sub_window":
        kw = dict(sub_window=PC["sub_window"] / 2)
    elif fault == "ring_16":
        points = 16
    got = predictor(f.cfg, **kw)(f.state, f.after[points])
    if fault == "risk_altered":
        got = got._replace(risk=got.risk.clone())
        got.risk[0] += 0.01
    elif fault == "total_altered":
        got = got._replace(count=got.count + 1)
    r = judged(f, got, points)
    assert not harness.verdict(r, PRED_LIMITS)[0], r


def imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_neither_port_nor_jax():
    path = ROOT / "perfbench" / "reference" / "predict.py"
    assert not imports(path) & {"tpu_collide_torch", "tpu_collide", "jax",
                                "jaxlib"}
    code = ("import sys; import perfbench.reference.predict; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tpu_collide_torch', 'tpu_collide', 'jax', 'jaxlib'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                       capture_output=True, text=True, timeout=300)
    assert r.stdout.strip() == "[]"
    assert "allow_tf32 = False" in path.read_text()


def hand_fleet():
    """Three drones of size 2 m (safe 7 m) in a 300 x 300 x 100 m world:
    A at rest, B 12.5 m from it closing at 10 m/s (a ring of two samples
    0.1 s apart: constant velocity), C alone in a far cell; every ring
    holds 2 samples."""
    c = [100.0, 100.0, 50.0]
    t = lambda rows: torch.tensor(rows, dtype=torch.float32)
    state = dict(
        pos=t([c, [c[0] + 12.5, c[1], c[2]], [275.0, 275.0, 50.0]]),
        vel=t([[0.0] * 3, [-10.0, 0.0, 0.0], [0.0] * 3]),
        acc=torch.zeros(3, 3), heading=torch.zeros(3),
        size=torch.full((3,), 2.0), otype=torch.zeros(3, dtype=torch.int32),
        alive=torch.ones(3, dtype=torch.bool),
        oid=torch.arange(3, dtype=torch.int32))
    ring = dict(pos=torch.stack([state["pos"] - state["vel"] * 0.1,
                                 state["pos"]], 1),
                t=t([[0.0, 0.1]] * 3), count=torch.full((3,), 2))
    system = small_system(3)
    system["world"]["hi"] = [300.0, 300.0, 100.0]
    return state, ring, system


# hand counts, 3D, 6 x 6 x 2 cells of 50 m, offsets 0 and 0.5 s, 10
# samples of 0.1 s. Rows: 3 drones x 2 offsets. Walked: A and B walk each
# other and themselves, C itself: 5 an offset. Pairs: A-B both ways at
# each offset. At t = 0, B 12.5 m off closing at 10 m/s is inside 7 m at
# the sample t_s = 0.6 (7 samples); at t = 0.5, B predicted (and
# advanced) 7.5 m off is inside at t_s = 0.1 (2 samples): 18 samples and
# 4 hits.
def test_predict_bound_counts_by_hand():
    state, ring, system = hand_fleet()
    pred = dict(PC, horizon=1.0)
    ref = rp.predict(state, ring, system, pred)
    assert rp.classify(ring).tolist() == [rp.STATIONARY, rp.CONST_VEL,
                                         rp.STATIONARY]
    w = dict(alive=3, cells=72, k=8, is3d=True,
             **{f: ref[f] for f in ("rows", "walked", "pairs", "samples",
                                    "hits")})
    assert (w["rows"], w["walked"], w["pairs"], w["samples"], w["hits"]) \
        == (6, 10, 4, 18, 4)
    assert ref["total"] == 2
    assert ref["ttc"].tolist() == pytest.approx([0.6, 0.6])
    b = roofline_predict.predict_bound(w)
    assert b["operations"] == 6 * 33 + 10 * 9 + 4 * 30 + 18 * 20 + 4 * 31
    assert b["bytes"] == 3 * (48 + 4) + 73 * 4 + 6 * (8 * 8 + 4)


def reader(name):
    return harness.load_module(ROOT / "perfbench" / "metrics"
                               / f"{name}.py").read


def synthetic(spans=True) -> dict:
    """Four profiled ticks, two of them predicting: each tc.predict span
    (100 us) launches 10 + 27 + 2 + 1 ms (the kernel 8 ms of them; the
    last two inside its two tc.predict_compact spans) and holds two host
    waits of 10 us; each tc.history span launches 1.5 ms; one wait
    outside. The device runs 60 us of the first call's 100 (two stretches
    of 30) and 70 of the second's (50 from before it, then 20 of a stretch
    that runs past it)."""
    host = [("tc.step", 0.0, 90.0), ("tc.host_wait", 95.0, 96.0)]
    launched = []
    device = [("void fused_predict_kernel<true>", 1e3, 9e3),
              ("void fused_predict_kernel<true>", 10e3, 18e3)]
    if spans:
        for s in (100.0, 300.0):
            host += [("tc.predict", s, s + 100.0),
                     ("tc.host_wait", s + 10.0, s + 20.0),
                     ("tc.host_wait", s + 50.0, s + 60.0),
                     ("tc.predict_compact", s + 70.0, s + 75.0),
                     ("tc.predict_compact", s + 85.0, s + 95.0)]
            launched += [(s + 5.0, 10_000.0), (s + 40.0, 27_000.0),
                         (s + 72.0, 2_000.0), (s + 90.0, 1_000.0)]
        for s in (0.0, 205.0, 230.0, 410.0):
            host.append(("tc.history", s + 1.0, s + 3.0))
            launched.append((s + 2.0, 1_500.0))
        device += [("elementwise", 100.0, 130.0),
                   ("elementwise", 160.0, 190.0),
                   ("elementwise", 290.0, 350.0),
                   ("elementwise", 380.0, 420.0)]
    launched.append((95.5, 7_000.0))
    return dict(host=host, units=4, launched=sorted(launched),
                device=sorted(device, key=lambda d: d[1]),
                predict_bounds_ms=[0.2, 0.6])


@pytest.mark.parametrize("name,want", [
    ("predict.device_ms.warn", 40.0),
    ("predict.host_waits.warn", 2.0),
    ("history.device_ms.warn", 1.5),
    ("predict_kernel.roofline_pct.warn", 100 * 0.4 / 8.0),
    ("predict_compact.device_ms.warn", 2.0 + 1.0),
    ("predict.wait_ms.warn", (10.0 + 10.0) * 1e-3),
    ("predict.idle_ms.warn", ((100 - 60) + (100 - 70)) / 2 * 1e-3)])
def test_reader_reads_a_synthetic_trace(name, want):
    assert math.isclose(reader(name)(synthetic()), want, rel_tol=1e-12)


@pytest.mark.parametrize("name", ["predict.device_ms.warn",
                                  "predict.host_waits.warn",
                                  "history.device_ms.warn",
                                  "predict_kernel.roofline_pct.warn",
                                  "predict_compact.device_ms.warn",
                                  "predict.wait_ms.warn",
                                  "predict.idle_ms.warn"])
def test_reader_is_silent_without_its_span(name):
    assert reader(name)(synthetic(spans=False)) is None


def test_prediction_spans():
    system = small_system(400)
    cfg = config(system)
    state = fleet(5, system)
    hist = tp.empty_history(400, 8, device=CPU)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for tick in range(3):
            hist = tp.update_history(hist, state, 0.1 * tick)
        predictor(cfg)(state, hist)
    ev = [(e.name, e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith("tc.")]
    names = [n for n, _, _ in ev]
    assert names.count("tc.history") == 3 and names.count("tc.predict") == 1
    (ps, pe), = [(s, e) for n, s, e in ev if n == "tc.predict"]
    # the compaction: the scatter to object order, then the top r_cap
    for name, count in (("tc.classify", 1), ("tc.predict_kernel", 1),
                        ("tc.predict_merge", 1), ("tc.predict_topup", 1),
                        ("tc.predict_compact", 2)):
        got = [(s, e) for n, s, e in ev if n == name]
        assert len(got) == count, name
        assert all(ps <= s and e <= pe for s, e in got), name


# The waits of a prediction on a card (core/device.host_wait), by place:
# the offsets' copy, the cell list's three constants, in the merge span the
# occupied slots' count and the recompute's two constants, in the top-up
# span its check. When the top-up recomputes (k_slots 1: every row with two
# hits at an offset is past its slots) it adds the pair count of the
# flagged entries' runs, their cells' three constants, the recompute's two,
# the hits and the kept entries: 8 more.
WAITS = {"tc.predict": 1, "tc.cell_list": 3, "tc.predict_merge": 3,
         "tc.predict_topup": 1}


@pytest.mark.parametrize("k_slots,topup_waits", [(PC["k_slots"], 0),
                                                 (1, 8)])
def test_prediction_marks_each_wait(monkeypatch, k_slots, topup_waits):
    """Each read on which a prediction waits for a card opens one
    tc.host_wait span, the CPU run standing in for the card's (the
    helper's device check patched). The plain predict kernel's own reads
    (inside tc.predict_kernel) are the CPU's, not the card kernel's."""
    monkeypatch.setattr(core_device, "_waits_on", lambda dev: True)
    system = small_system(400)
    cfg = config(system)
    assert cfg.detect.hot_topup == 8
    state = fleet(5, system)
    hist = tp.empty_history(400, 8, device=CPU)
    for tick in range(3):
        hist = tp.update_history(hist, state, 0.1 * tick)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = predictor(cfg, k_slots=k_slots)(state, hist)
    ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("tc.")),
                key=lambda x: x[1])
    assert int(got.slot_oflow) == 0
    assert (int(got.slot_trunc) > 0) == (topup_waits > 0)

    def inner(w):
        """The innermost span around wait w."""
        holds = [x for x in ev if x[0] != "tc.host_wait"
                 and x[1] <= w[1] and w[2] <= x[2]]
        return min(holds, key=lambda x: x[2] - x[1])[0]

    where = {}
    for w in ev:
        if w[0] == "tc.host_wait" and inner(w) != "tc.predict_kernel":
            where[inner(w)] = where.get(inner(w), 0) + 1
    want = dict(WAITS, **{"tc.predict_topup": 1 + topup_waits})
    assert where == want
    assert sum(want.values()) == 8 + topup_waits


def test_small_run_is_correct():
    cell = harness.resolve(CELL, harness.manifest())
    conf = json.loads(json.dumps(cell.config))
    conf["system"] = small_system(600)
    cell = dataclasses.replace(cell, config=conf, traffic=dict(
        cell.traffic, profile_ticks=5, work_calls=1))
    line = harness.run_cell(cell, 2 ** 31 + 11, 2.0, True, torch, CPU,
                            time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(LIMITS)
    info = line["info"]
    assert (info["history_points"], info["offsets"], info["sub_steps"]) == \
        (100, 20, 10)
    assert info["k_slots"] == 8 and info["predict_calls"] >= 2
    # no device on the CPU: the device readers are silent
    assert set(line["metrics"]) <= {"predict.host_waits.warn",
                                    "predict.wait_ms.warn"}
