"""The reference against brute force and against hand-worked cases, on the
CPU at small sizes."""
import itertools
import math

import numpy as np
import pytest
import torch

from perfbench.fleet import make_fleet
from perfbench.reference import detect as rd
from perfbench.reference import physics, serving

SIZES = [2.0, 4.0, 5.0, 1.0]


def system(n, hi, radius=100.0, cell=100.0):
    return dict(
        num_objects=n,
        world=dict(lo=[0.0, 0.0, 0.0], hi=list(hi)),
        grid=dict(cell_size=cell),
        detect=dict(search_radius=radius, time_window=10.0, time_step=0.1,
                    safe_distance_base=5.0, max_warning_time=10.0,
                    max_relative_speed=50.0, min_relative_speed=0.1,
                    weight_distance=0.3, weight_time=0.3, weight_speed=0.2,
                    weight_angle=0.1, weight_type=0.1, same_type_factor=0.5,
                    diff_type_factor=0.8, mode="fast"),
        alerts=dict(risk_low=0.3, risk_medium=0.6, risk_high=0.8,
                    ttc_critical=3.0, ttc_high=5.0, max_scene_alerts=64,
                    max_alerts_per_object=8),
        sim=dict(dt=0.1, accel_change_prob=0.1, accel_range=1.0,
                 max_speed=30.0, min_heading_speed=0.1))


def fleet(sys_, seed, cities=None):
    spec = {"speed": [5.0, 20.0]}
    if cities:
        spec.update(cities=cities, city_fraction=0.8)
    return make_fleet(sys_, SIZES, spec, seed, "cpu")


def brute(state, sys_):
    """Every ordered pair through pair_stages, no grid."""
    alive = state["alive"]
    idx = torch.nonzero(alive).squeeze(1)
    i, j = (t.reshape(-1) for t in torch.meshgrid(idx, idx, indexing="ij"))
    keep = i != j
    i, j = i[keep], j[keep]
    g = lambda f: (state[f][i], state[f][j])
    rel = state["pos"][j] - state["pos"][i]
    near = (rel * rel).sum(1) <= sys_["detect"]["search_radius"] ** 2
    i, j = i[near], j[near]
    out = rd.pair_stages(*g("pos"), *g("vel"), *g("acc"), *g("size"),
                         *g("heading"), *g("otype"), sys_["detect"],
                         sys_["alerts"])
    pass2, hit, risk = out[0], out[1], out[2]
    q = hit & (risk >= sys_["alerts"]["risk_low"])
    oid = state["oid"].long()
    return dict(stage1=int(i.numel()), stage2=int(pass2.sum()),
                hits=int(hit.sum()),
                codes=set((oid[i[q]] * (1 << 32) + oid[j[q]]).tolist()))


@pytest.mark.parametrize("hi,cities,block", [
    ((1500.0, 1500.0, 0.0), None, 1 << 25),
    ((1500.0, 1500.0, 0.0), [[0.5, 0.5, 300.0]], 5000),
    ((600.0, 600.0, 300.0), None, 3000),
])
def test_detect_matches_all_pairs(monkeypatch, hi, cities, block):
    sys_ = system(2000, hi, radius=50.0 if hi[2] else 100.0,
                  cell=50.0 if hi[2] else 100.0)
    st = fleet(sys_, 3, cities)
    st["alive"][::17] = False
    monkeypatch.setattr(rd, "BLOCK_SLOTS", block)
    got = rd.detect(st, sys_)
    want = brute(st, sys_)
    assert want["hits"] > 0
    for k in ("stage1", "stage2", "hits"):
        assert got[k] == want[k]
    assert set(got["code"].tolist()) == want["codes"]


def test_head_on_pair_ttc():
    """Two cars 100 m apart closing at 20 m/s with a safe distance of 7 m:
    inside from t = 4.65 s, so the hit lands on the lattice at 4.7 s."""
    sys_ = system(2, (200.0, 200.0, 0.0))
    z = torch.zeros
    st = dict(pos=torch.tensor([[0.0, 0, 0], [100.0, 0, 0]]),
              vel=torch.tensor([[10.0, 0, 0], [-10.0, 0, 0]]),
              acc=z((2, 3)), heading=torch.tensor([0.0, math.pi]),
              size=torch.tensor([2.0, 2.0]),
              otype=z(2, dtype=torch.int32),
              alive=torch.ones(2, dtype=torch.bool),
              oid=torch.arange(2, dtype=torch.int32))
    got = rd.detect(st, sys_)
    assert got["hits"] == 2
    assert got["ttc"].tolist() == pytest.approx([4.7, 4.7], abs=1e-5)
    # risk: distance 0.3 * (1 - 6/7), time 0.3 * 0.53, speed 0.2 * 0.4,
    # angle ~0, type 0.1 * 0.5
    want = 0.3 * (1 - 6 / 7) + 0.3 * (1 - 0.47) + 0.2 * 0.4 + 0.05
    assert got["risk"].tolist() == pytest.approx([want, want], abs=1e-5)


def test_stencil_counts_match_brute_force():
    sys_ = system(500, (700.0, 700.0, 0.0))
    st = fleet(sys_, 5, [[0.3, 0.3, 200.0]])
    st["alive"][::7] = False
    got = rd.stencil_counts(st["pos"], st["alive"], sys_["world"], 100.0)
    c = torch.floor(st["pos"][st["alive"]] / 100.0).long()[:, :2]
    d = (c[:, None, :] - c[None, :, :]).abs().max(-1).values
    assert got == int((d <= 1).sum())


def test_physics_judges_the_step_and_its_faults():
    sys_ = system(3000, (2000.0, 2000.0, 0.0))
    sim, world = sys_["sim"], sys_["world"]
    st = fleet(sys_, 9)
    st["pos"][:5, 0] = 1999.5          # some bounce off the border
    gen = torch.Generator().manual_seed(1)
    kept = gen.get_state()
    acc = physics.draw_acc(st, sim, world, gen)
    after = physics.advance(st, acc, sim, world)
    again = torch.Generator()
    again.set_state(kept)
    assert torch.equal(physics.draw_acc(st, sim, world, again), acc)
    judge = lambda got: physics.judge(st, got, acc, sim, world)["integ_err"]
    assert judge(after) == 0
    assert judge(st) > 0.4                                 # unchanged
    never = physics.advance(st, st["acc"], sim, world)     # no redraw
    assert judge(never) > 0.4
    every = physics.advance(st, physics.draws(3000, sim, world, gen)[1],
                            sim, world)                    # all redrawn
    assert judge(every) > 0.4
    other = physics.advance(st, physics.draw_acc(st, sim, world, gen),
                            sim, world)                    # other draws
    assert judge(other) > 0.4
    assert judge(dict(after, acc=after["acc"] * 3)) > 0.5
    low = physics.advance(st, acc, sim, world, dtype=torch.bfloat16)
    assert judge(low) > 1.0


def test_ingest_and_registry():
    sys_ = system(100, (500.0, 500.0, 0.0))
    st = fleet(sys_, 2)
    otypes = st["otype"].numpy()
    rep = dict(slot=np.array([3, 7]), pos=np.array([[1.0, 2, 3], [4, 5, 6]]),
               vel=np.array([[1.0, 1, 1], [2, 2, 2]]),
               heading=np.array([0.5, 1.5]))
    got = serving.ingest(st, rep, SIZES, otypes, False)
    assert got["pos"][3].tolist() == [1.0, 2.0, 0.0]
    assert got["vel"][7].tolist() == [2.0, 2.0, 0.0]
    assert serving.judge_ingest(got, st) > 0
    assert serving.judge_ingest(got, got) == 0
    b = lambda v, o, r: dict(valid=np.array([True]), vehicle_oid=np.array(
        [v]), other_oid=np.array([o]), risk=np.array([r], np.float32),
        ttc=np.array([1.0], np.float32), priority=np.array([2]))
    reg = serving.registry([b(1, 2, 0.5), b(1, 2, 0.6), b(2, 1, 0.4)], str)
    assert reg[1:] == (2, 1)
    assert reg[0][("1", "2")][0] == pytest.approx(0.6)
    assert serving.judge_registry(reg, reg + (2,)) == 0
    assert serving.judge_registry(reg, (reg[0], 3, 0, 2)) == 2


@pytest.mark.parametrize("n", list(itertools.product([0, 5], [1, 3])))
def test_reservoir_keeps_a_uniform_sample(n):
    from perfbench.stats import Reservoir
    offset, size = n
    r = Reservoir(size, 7 + offset)
    for i in range(50):
        slot = r.offer()
        if slot is not None:
            r.put(slot, i, i * 10)
    got = r.sample()
    assert len(got) == size
    assert all(v == i * 10 for i, v in got)
