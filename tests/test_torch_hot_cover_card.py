"""The cut-aware hot cover on a CUDA card at the city-skew cell's own fleet
(perfbench/configs/ground_100k_2d_cityskew.json, traffic step_cityskew):
100k vehicles on a 10 x 10 km 2D world, 80% in the upstream's five
cities, k 8, 1,024 scene alerts, hot_cover 'cut' with hot_topup 256.
The fused step certifies the first steps of three episodes from the
seeded fleet (the generator running on across them, as the cell's loop
runs it), the rows that reach the list stay within (A + ties) / k, and
the first step's list of each episode passes the benchmark's judge
against every ordered pair. Off the card every test skips. This file
imports no JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_hot_cover_card.py
"""
import json
from pathlib import Path

import pytest
import torch

from perfbench.drivers.common import as_dict, as_system, produced
from perfbench.fleet import make_fleet
from perfbench.reference import compare
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.engine import make_step
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk

pytestmark = pytest.mark.card

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
CONF = json.loads((BENCH / "configs" / "ground_100k_2d_cityskew.json")
                  .read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "step_cityskew.json").read_text())
SEED = 2 ** 31 + 251
EPISODES = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the detection kernel and the scene "
                    "cut have no CPU or interpret mode")
    return torch.device("cuda", 0)


def test_cityskew_certifies_at_k8_and_lists_the_best(card):
    cfg = SystemConfig.from_json(json.dumps(CONF["system"]))
    assert cfg.num_objects == 100_000 and cfg.detect.hot_cover == "cut"
    k, a = cfg.alerts.max_alerts_per_object, cfg.alerts.max_scene_alerts
    assert (k, a) == (8, 1024)
    fleet = ObjectState(**make_fleet(CONF["system"], CONF["vehicle_sizes"],
                                     TRAFFIC["fleet"], SEED, card))
    step = make_step(cfg, backend="fused", device=card)
    gen = torch.Generator(device=card).manual_seed(SEED)
    for _ in range(EPISODES):
        state = fleet
        for i in range(TRAFFIC["certify_steps"]):
            state, out = step(state, gen)
            assert int(out.overflow) == 0
            assert int(out.alert_overflow) == 0
            if i:
                continue
            cl = build_cell_list(state, cfg)
            slots = fused_topk(cl, cfg, "hits")
            hot = cl.own & (slots.qual > k)
            assert int(hot.sum()) > 10_000
            reach = refine._reaching_rows(slots.keys, cl.own, hot, a)
            own_keys = slots.keys[cl.own].reshape(-1)
            floor = torch.topk(own_keys, a).values[-1]
            assert int(reach.sum()) <= int((own_keys >= floor).sum()) // k
            assert int(reach.sum()) <= cfg.detect.hot_topup
            got = compare.judge_detection(as_dict(state), produced(out),
                                          as_system(cfg))
            assert got["alert_miss"] == 0, got
            assert got["risks_gap"] == 0.0, got
            assert got["alert_key_gap"] < compare.KEY_TIE, got
