"""The port's twin of tools/scale_bench.py (tools/torch_scale_bench.py)
against the JAX package, on the CPU, where the fused path takes the
detection kernel's plain version; and what both twins share (imports, the
card, where they write). The big-mesh twin's own tests are in
tests/test_torch_big_mesh_tool.py.

Each configuration is the twin's own, cut in scale only: cfg_10m (10M
objects in 20 x 20 x 1 km) to 500 objects in 400 x 400 x 125 m, the same
density (2.5e-5 a m^3); cfg_1m (1M in 10 x 10 x 0.5 km) to 400 objects in
the same small world (2e-5 a m^3, cfg_1m's); accel_change_prob 0, so that
the physics is deterministic and both packages step the same trajectories
whatever their draws; the scan at 4 steps in chunks of 2 (the tool's: 9 in
chunks of 3, 6 in chunks of 2); k 1 (fast) and survivor_k 1 (precise),
both with the hot top-up off (the JAX package has none in precise mode), so
that the certificates compared are not 0 and the adopt rule runs. The probe's comparison with the JAX package packs the 500
objects into 160 x 160 x 50 m at survivor_k 8 (cfg_10m's), so that the
survivor need exceeds the 1,024 floor of the cap's rule; at the config's
density 500 objects need about 100 and every cap is the floor.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

import tpu_collide as tc
from tpu_collide.kernels import tune as jax_tune
from tpu_collide_torch.core.config import SimConfig, WorldConfig
from tpu_collide_torch.kernels import tune
from chip_smoke import load_tool
from tests.torch_parity import (alert_map, assert_alerts_equal,
                                hand_out_fleet, jax_state_of,
                                jax_uniform_fleet, record_steps)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


tsb = load_tool("torch_scale_bench")
tbm = load_tool("torch_big_mesh_dryrun")

SMALL_WORLD = WorldConfig(hi=(400.0, 400.0, 125.0))
# the probe's test packs N_10M objects 16 times denser, so that their
# survivor need (about 1,400) lifts the cap past the rule's floor of 1024
DENSE_WORLD = WorldConfig(hi=(160.0, 160.0, 50.0))
N_10M, N_1M = 500, 400
STEPS, CHUNK = 4, 2
# the steps of one scan attempt: the warm-up chunk, the timed chunks and
# the step seeded 99
TIMED = slice(CHUNK, CHUNK + STEPS)
N_SCAN = CHUNK + STEPS + 1
# tools/scale_bench.py's row keys (:66-76, :118-120)
JAX_FUSED_KEYS = {"config", "avg_ms", "best_ms", "overflow", "aoflow",
                  "risks_last", "k"}
JAX_SHARDED_KEYS = {"config", "avg_ms", "best_ms", "overflow", "aoflow"}


CFG_10M, CFG_1M = tsb.cfg_10m, tsb.cfg_1m


def shrunk_10m(mode="fast"):
    """cfg_10m(mode) at N_10M objects and the same density, deterministic."""
    return CFG_10M(mode).replace(num_objects=N_10M, world=SMALL_WORLD,
                                 sim=SimConfig(accel_change_prob=0.0))


def small_10m(mode):
    """shrunk_10m(mode) at one slot, without the hot top-up."""
    cfg = shrunk_10m(mode)
    if mode == "fast":
        return cfg.replace(
            alerts=dataclasses.replace(cfg.alerts, max_alerts_per_object=1),
            detect=dataclasses.replace(cfg.detect, hot_topup=0))
    return cfg.replace(detect=dataclasses.replace(cfg.detect, survivor_k=1,
                                                  hot_topup=0))


def small_1m():
    return CFG_1M().replace(num_objects=N_1M, world=SMALL_WORLD,
                            sim=SimConfig(accel_change_prob=0.0))


def jax_cfg_of(cfg):
    return tc.SystemConfig.from_json(cfg.to_json())


def counters(out):
    return tuple(int(x) for x in (out.num_risks, out.overflow,
                                  out.alert_overflow))


def jax_steps(cfg, d, n=N_SCAN):
    """n JAX fused steps (interpret mode) of the fleet d: each step's
    (num_risks, overflow, alert_overflow) and the last step's alerts."""
    stepf = tc.make_step(jax_cfg_of(cfg), donate=False, backend="fused",
                         interpret=True)
    st, rows = jax_state_of(d), []
    for i in range(n):
        st, out = stepf(st, jax.random.key(i))
        rows.append(counters(out))
    return rows, alert_map(out.alerts)


@pytest.fixture(scope="module")
def fast_scan():
    """The twin's fused_scan of small_10m('fast') on the JAX fleet, every
    step recorded, and the JAX package's steps of the same fleet."""
    return _scan("fast")


@pytest.fixture(scope="module")
def precise_scan():
    """The same in precise mode with the survivor cap sized by probe, and
    the JAX package's probe over the states the scan steps through."""
    return _scan("precise")


def _scan(mode):
    cfg = small_10m(mode)
    d = jax_uniform_fleet(cfg)
    res = {"cfg": cfg}
    with pytest.MonkeyPatch.context() as mp:
        hand_out_fleet(mp, tsb, d)
        made = record_steps(mp, tsb)
        res["twin"] = tsb.fused_scan(cfg, STEPS, CHUNK, probe_cap=True,
                                     device="cpu")
    res["made"] = made
    res["jax"] = jax_steps(made[0][0], d)
    return res


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_fused_scan_steps_equal_the_jax_steps(mode, request):
    """The twin's first attempt, step by step (warm-up chunk, timed chunks,
    the step seeded 99): num_risks, overflow and alert_overflow equal the
    JAX package's fused step in interpret mode on the same fleet; the
    worst certificates of the timed steps are the JAX steps' worst; the
    last step's alerts equal as unordered pairs, values within 1e-5."""
    scan = request.getfixturevalue(f"{mode}_scan")
    (cfg0, outs), *_ = scan["made"]
    want, want_alerts = scan["jax"]
    got = [counters(o) for o in outs]
    assert len(got) == N_SCAN
    assert got == want
    first = scan["twin"][6].tries[0]
    assert (first["overflow"], first["aoflow"]) == (
        max(r[1] for r in want[TIMED]), max(r[2] for r in want[TIMED]))
    assert first["aoflow"] > 0 and sum(r[0] for r in want) > 0
    assert_alerts_equal(want_alerts, alert_map(outs[-1].alerts))


@pytest.mark.parametrize("mode", ["fast", "precise"])
def test_fused_scan_adopts_the_slots_of_bench_rule(mode, request):
    """bench.py:199-226's arithmetic from JAX's counted shortfall: the
    second attempt runs at min(16, 1 + the worst alert_overflow of JAX's
    timed steps) slots (precise: survivor_k, with the survivor cap
    doubled), and the adopted configuration certifies every timed step."""
    scan = request.getfixturevalue(f"{mode}_scan")
    avg, best, out, worst_of, worst_ao, cfg_used, info = scan["twin"]
    want, _ = scan["jax"]
    shortfall = max(r[2] for r in want[TIMED])
    slots = lambda c: (c.alerts.max_alerts_per_object if mode == "fast"
                       else c.detect.survivor_k)
    (cfg0, _), (cfg1, outs1), *_ = scan["made"]
    assert slots(cfg0) == 1
    assert slots(cfg1) == min(tsb.K_MAX, 1 + shortfall)
    if mode == "precise":
        assert cfg1.survivor_cap == 2 * cfg0.survivor_cap
    assert len(info.tries) == len(scan["made"]) <= 3
    assert cfg_used == scan["made"][-1][0]
    assert worst_of == worst_ao == 0 and avg > 0 and best <= avg
    if mode == "fast":
        # num_risks does not depend on the slots in fast mode
        assert [counters(o)[0] for o in outs1] == [r[0] for r in want]


def test_probed_cap_equals_the_jax_probe(precise_scan, monkeypatch):
    """probe_cap: the survivor need the twin finds over the scan's states
    equals kernels/tune.measure_survivor_need of the JAX package (Pallas
    kernel in interpret mode) over the same key schedule, and the cap it
    sizes equals the JAX package's suggest_survivor_cap, above the rule's
    floor of 1024 (DENSE_WORLD); the scan's first attempt steps at the
    probed cap."""
    info = precise_scan["twin"][6]
    assert precise_scan["made"][0][0].survivor_cap == info.probed_cap
    assert info.probed_cap == tune.survivor_cap_for(info.probed_need)

    cfg = shrunk_10m("precise").replace(world=DENSE_WORLD)
    d = jax_uniform_fleet(cfg)
    hand_out_fleet(monkeypatch, tsb, d)
    need = tsb.probe_survivor_need(cfg, STEPS, CHUNK, 0, "uniform",
                                   torch.device("cpu"))
    jax_needs = []
    real = jax_tune.measure_survivor_need

    def measured(*args, **kw):
        jax_needs.append(real(*args, **kw))
        return jax_needs[-1]
    monkeypatch.setattr(jax_tune, "measure_survivor_need", measured)
    keys = jax.numpy.concatenate(
        [jax.random.split(jax.random.key(s), CHUNK)
         for s in tsb.schedule(STEPS, CHUNK)])
    jax_cap = jax_tune.suggest_survivor_cap(jax_cfg_of(cfg), jax_state_of(d),
                                            keys, interpret=True)
    assert jax_needs == [need]
    assert tune.survivor_cap_for(need) == jax_cap > 1024


def test_probe_walks_the_states_the_scan_steps(monkeypatch):
    """The probe's states are the ones the scan's steps detect on, bit for
    bit: the fleet of key0, the warm-up chunk's generator, then each timed
    chunk's (random acceleration changes on, so that every draw shows),
    integrated and not stepped; their needs are measured one by one."""
    cfg = shrunk_10m("precise").replace(sim=SimConfig())
    states = []
    real = tsb.make_step

    def recording(cfg, **kw):
        stepf = real(cfg, **kw)

        def step(state, gen):
            res = stepf(state, gen)
            states.append(res[0])
            return res
        return step
    monkeypatch.setattr(tsb, "make_step", recording)
    tsb.fused_scan(cfg, STEPS, CHUNK, adopt_k=False, device="cpu")
    walked = list(tsb.scan_states(cfg, STEPS, CHUNK, 0, "uniform",
                                  torch.device("cpu")))
    assert len(walked) == CHUNK + STEPS
    for got, want in zip(walked, states):
        for f in ("pos", "vel", "acc", "heading", "alive"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(walked[-1].acc, walked[0].acc)
    needs = [tune.measure_survivor_need(cfg, st) for st in walked]
    assert tsb.probe_survivor_need(cfg, STEPS, CHUNK, 0, "uniform",
                                   torch.device("cpu")) == max(needs) > 0


def test_one_shard_sharded_scan_equals_the_unsharded_scan(monkeypatch):
    """run_sharded_1m on small_1m: the one-shard mesh passes make_mesh (a
    halo of 100 m over a 50 m radius; 3 m a step across a 400 m slab), is
    conserved and certified, and each step's num_risks equals the
    unsharded fused step's on the same fleet."""
    d = jax_uniform_fleet(small_1m())
    monkeypatch.setattr(tsb, "cfg_1m", small_1m)
    hand_out_fleet(monkeypatch, tsb, d)
    sharded = record_steps(monkeypatch, tsb, "make_sharded_step")
    row = tsb.run_sharded_1m(steps=STEPS, chunk=CHUNK, device="cpu")
    assert JAX_SHARDED_KEYS <= set(row)
    assert row["conserved"] and row["dropped"] == 0
    assert row["alive"] == N_1M
    assert row["overflow"] == row["aoflow"] == 0
    plain = record_steps(monkeypatch, tsb)
    tsb.fused_scan(small_1m(), STEPS, CHUNK, adopt_k=False, device="cpu")
    got = [int(o.num_risks) for o in sharded[0][1]]
    want = [int(o.num_risks) for o in plain[0][1]]
    assert len(got) == CHUNK + STEPS and sum(got) > 0
    assert got == want[:CHUNK + STEPS]


def test_twins_import_neither_jax_nor_the_jax_package():
    code = ("import json, sys; sys.path.insert(0, 'tools'); "
            "import torch_scale_bench, torch_big_mesh_dryrun; "
            "print(json.dumps([m for m in ('jax', 'tpu_collide') "
            "if m in sys.modules]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_twins_need_a_card_unless_told_cpu(monkeypatch, tmp_path):
    """Without a card, naming no device raises in both twins; nothing is
    written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "rows.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.main(["--which", "1ms", "--out", str(out)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbm.main(["--n", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.fused_scan(small_1m(), STEPS, CHUNK)
    assert not out.exists()


def test_scale_main_writes_its_out_and_no_pre_port_file(monkeypatch,
                                                        tmp_path):
    """main() with --device cpu runs its three rows (configurations cut
    to the small world) and writes them to --out; the JAX tool's
    results/scale_bench_r5.json keeps its bytes, and the twin's default
    output is not touched."""
    r5 = os.path.join(ROOT, "results", "scale_bench_r5.json")
    with open(r5, "rb") as f:
        before = f.read()
    default_stat = (os.stat(tsb.DEFAULT_OUT).st_mtime_ns
                    if os.path.exists(tsb.DEFAULT_OUT) else None)
    monkeypatch.setattr(tsb, "cfg_10m", shrunk_10m)
    monkeypatch.setattr(tsb, "cfg_1m", small_1m)
    out = tmp_path / "sub" / "rows.json"
    rows = tsb.main(["--device", "cpu", "--steps", "3", "--out", str(out)])
    with open(out) as f:
        written = json.load(f)
    assert [r["config"] for r in written] == [
        "10m_3d_fast", "10m_3d_precise", "1m_sharded_fused_1dev"]
    assert written == json.loads(json.dumps(rows))
    assert JAX_FUSED_KEYS <= set(written[0])
    assert JAX_FUSED_KEYS | {"cap"} <= set(written[1])
    assert JAX_SHARDED_KEYS <= set(written[2])
    assert all(r["card"] is None for r in written)
    with open(r5, "rb") as f:
        assert f.read() == before
    assert default_stat == (os.stat(tsb.DEFAULT_OUT).st_mtime_ns
                            if os.path.exists(tsb.DEFAULT_OUT) else None)
