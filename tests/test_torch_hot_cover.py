"""The fast tail's cut-aware hot cover (DetectionConfig.hot_cover 'cut',
kernels/refine._reaching_rows) on the CPU, on city-skewed fleets of the
upstream's city_centered distribution (perfbench/fleet.make_fleet: 80% in
five cities, radius drawn uniformly) cut to a 1 km world, where nearly
every city row holds more qualifying pairs than slots.

  * soundness: at k 1, 2 and 4, 'cut' certifies (alert_overflow 0), and
    its list and num_risks pass the benchmark's judge against every
    ordered pair (perfbench/reference), where 'count' certifies nothing;
  * the bound: the rows that reach the list are at most (A + the ties at
    the slots' cut) / k, and all of them are covered;
  * faults: with one reaching row left out of the cover, alert_overflow
    counts it and the list, its certificate ignored, misses pairs;
  * 'count' is the JAX package's rule as it was;
  * refusals: 'cut' in precise mode, in the sharded step, and an unknown
    rule."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from perfbench.drivers.common import as_dict, as_system, produced
from perfbench.fleet import make_fleet
from perfbench.reference import compare, detect
from tpu_collide_torch.core.config import DetectionConfig, SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.engine import detect_and_alerts_fused
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tpu_collide_torch.shard.step import make_mesh, make_sharded_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
CONF = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                   / "configs" / "ground_100k_2d.json").read_text())
# the five cities of the upstream's city_centered fleet, radii cut with the
# 10 km world to 1 km
CITIES = [[0.25, 0.25, 100.0], [0.75, 0.25, 100.0], [0.25, 0.75, 100.0],
          [0.75, 0.75, 100.0], [0.5, 0.5, 200.0]]
# (objects, k, A, seed): 16 and 11 rows reach at k 1 and 2; none at k 4,
# where the list is exact with no row covered
CASES = {"k1": (3000, 1, 16, 2), "k2": (3000, 2, 64, 1),
         "k4": (4000, 4, 64, 1)}


def city_case(n, k, a, seed, rule="cut"):
    """(cfg, state) of a city-skewed fleet of n on a 1 km world, k slots,
    a scene alerts, hot_topup 2a / k (twice the most rows that can reach
    the list)."""
    s = json.loads(json.dumps(CONF["system"]))
    s["num_objects"] = n
    s["world"]["hi"] = [1000.0, 1000.0, 0.0]
    s["alerts"].update(max_alerts_per_object=k, max_scene_alerts=a)
    s["detect"].update(hot_cover=rule, hot_topup=2 * a // k)
    spec = dict(speed=[5.0, 20.0], cities=CITIES, city_fraction=0.8)
    state = ObjectState(**make_fleet(s, CONF["vehicle_sizes"], spec, seed,
                                     CPU))
    return SystemConfig.from_json(json.dumps(s)), state


def with_rule(cfg, rule):
    return cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                  hot_cover=rule))


def reaching(cl, slots, a):
    """The rows that reach a list of `a` (refine._reaching_rows)."""
    hot = cl.own & (slots.qual > slots.keys.shape[1])
    return refine._reaching_rows(slots.keys, cl.own, hot, a)


def judge(cfg, state, out):
    return compare.judge_detection(as_dict(state), produced(out),
                                   as_system(cfg))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """A case's config, state, cell list, slots, reaching rows and both
    rules' outputs."""
    cfg, state = city_case(*CASES[request.param])
    cl = build_cell_list(state, cfg)
    slots = fused_topk(cl, cfg, "hits")
    reach = reaching(cl, slots, cfg.alerts.max_scene_alerts)
    return dict(cfg=cfg, state=state, cl=cl, slots=slots, reach=reach,
                cut=detect_and_alerts_fused(state, cfg),
                count=detect_and_alerts_fused(state,
                                              with_rule(cfg, "count")))


def test_cut_certifies_the_best_list(case):
    cfg, out = case["cfg"], case["cut"]
    assert int(out.overflow) == 0
    assert int(case["count"].alert_overflow) > 10_000
    assert int(out.alert_overflow) == 0
    got = judge(cfg, case["state"], out)
    assert got["alert_miss"] == 0, got
    assert got["risks_gap"] == 0.0, got
    assert got["alert_key_gap"] < compare.KEY_TIE, got
    assert int(out.alerts.count) == cfg.alerts.max_scene_alerts
    assert int(out.num_risks) == int(case["count"].num_risks)


def test_reaching_rows_are_bounded_and_covered(case):
    cfg, cl, slots, reach = (case["cfg"], case["cl"], case["slots"],
                             case["reach"])
    k = slots.keys.shape[1]
    a = cfg.alerts.max_scene_alerts
    own_keys = slots.keys[cl.own].reshape(-1)
    floor = torch.sort(own_keys, descending=True).values[a - 1]
    assert floor >= 0.0                   # a slot keys qualify
    at_or_above = int((own_keys >= floor).sum())
    assert int(reach.sum()) <= at_or_above // k
    assert torch.equal(reach, cl.own & (slots.qual > k)
                       & (slots.keys[:, k - 1] >= floor))
    covered, rows = refine._hot_rows(cl, cfg, slots.qual, k, reach)
    assert torch.equal(covered, reach)
    assert rows.numel() == int(reach.sum())


def test_a_reaching_row_left_out_is_counted_and_missed(monkeypatch):
    """The row left out is one whose dropped pairs the reference's list
    holds: the certificate counts its pairs past k, and the list, its
    certificate ignored, misses them."""
    cfg, state = city_case(*CASES["k2"])
    cl = build_cell_list(state, cfg)
    slots = fused_topk(cl, cfg, "hits")
    k = slots.keys.shape[1]
    reach = reaching(cl, slots, cfg.alerts.max_scene_alerts)
    ref = detect.detect(as_dict(state), as_system(cfg))
    top = detect.scene_list(ref, cfg.alerts.max_scene_alerts)["code"]
    needed = None
    for r in torch.nonzero(reach).flatten().tolist():
        oid = int(cl.oid[r])
        kept = {int(cl.oid[c]) for c in slots.idx[r].tolist()}
        mine = [int(c) & 0xFFFFFFFF for c in top.tolist() if c >> 32 == oid]
        if any(o not in kept for o in mine):
            needed = r
            break
    assert needed is not None

    real = refine._hot_rows

    def leave_out(cl, cfg, count, k, hot=None):
        covered, rows = real(cl, cfg, count, k, hot)
        covered = covered.clone()
        covered[needed] = False
        return covered, rows[rows != needed]

    monkeypatch.setattr(refine, "_hot_rows", leave_out)
    out = detect_and_alerts_fused(state, cfg)
    assert int(out.alert_overflow) == int(slots.qual[needed]) - k > 0
    assert judge(cfg, state, out)["alert_miss"] > 0


def test_count_rule_is_the_jax_packages(case):
    """'count' covers the hot_topup own rows of most qualifying pairs
    (ties by the lower sorted row) and counts every other own row's pairs
    past k; its config crosses to JSON without the port's field, and a
    config read from that JSON gives bit-equal outputs."""
    cfg, cl, slots = with_rule(case["cfg"], "count"), case["cl"], case["slots"]
    k = slots.keys.shape[1]
    q, own = slots.qual, cl.own
    hot = torch.nonzero(own & (q > k)).flatten()
    order = sorted(hot.tolist(), key=lambda r: (-int(q[r]), r))
    want = torch.zeros_like(own)
    want[order[:cfg.detect.hot_topup]] = True
    covered = refine._hot_topup(cl, cfg, q, k)[0]
    assert torch.equal(covered, want)
    out = case["count"]
    assert int(out.alert_overflow) == int(
        torch.clamp_min(q - k, 0)[own & ~want].sum())
    assert "hot_cover" not in json.loads(cfg.to_json())["detect"]
    again = detect_and_alerts_fused(case["state"],
                                    SystemConfig.from_json(cfg.to_json()))
    for f in ("num_pairs_checked", "num_risks", "max_risk", "num_alive",
              "overflow", "alert_overflow"):
        assert torch.equal(getattr(again, f), getattr(out, f)), f
    for f in dataclasses.fields(out.alerts):
        assert torch.equal(getattr(again.alerts, f.name),
                           getattr(out.alerts, f.name)), f.name


def test_cut_is_refused_where_it_is_not_a_rule():
    cfg, state = city_case(400, 2, 16, 1)
    assert json.loads(cfg.to_json())["detect"]["hot_cover"] == "cut"
    precise = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                     mode="precise"))
    with pytest.raises(ValueError, match="fast mode only"):
        refine.fused_scene_precise(build_cell_list(state, precise), precise)
    sharded = cfg.replace(shard=dataclasses.replace(cfg.shard,
                                                    num_shards=2))
    mesh = make_mesh(sharded, device=CPU)
    for backend in ("fused", "xla"):
        with pytest.raises(ValueError, match="sharded step"):
            make_sharded_step(sharded, mesh, backend=backend)
    with pytest.raises(ValueError, match="hot_cover"):
        DetectionConfig(hot_cover="all")
