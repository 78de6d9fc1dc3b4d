"""The predict kernel (csrc/fused_predict.cu) against its plain version
(kernels/fused_detect.predict_topk_plain) on a CUDA card, at the warn
cell's shapes (perfbench/configs/drones_1m_3d_warn.json): 1M drones in
10 x 10 x 0.5 km, trajectory classes from 100-point rings filled over 100
fused steps, 20 offsets 0.5 s apart, a 1 s sub-window of 10 samples, at
k_slots 8 and 32. Keys, indices and emitted counts equal as raw bits. Off
the card every test skips. This file imports no JAX, so that it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_predict_card.py
"""
import json
from pathlib import Path

import pytest
import torch

from perfbench.fleet import make_fleet
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.detect.predict import (classify_trajectories,
                                              empty_history, predict_offsets,
                                              sub_window_config,
                                              update_history)
from tpu_collide_torch.engine import make_step
from tpu_collide_torch.kernels import fused_detect
from tpu_collide_torch.kernels.cell_list import build_cell_list

pytestmark = pytest.mark.card

CONF = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                   / "configs" / "drones_1m_3d_warn.json").read_text())
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the predict kernel has no CPU or "
                    "interpret mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def warn_cell_list(card):
    """(cfg, the cell list with trajectory classes, offsets, sub-steps) of
    the warn cell's fleet after its ring's fill."""
    cfg = SystemConfig.from_json(json.dumps(CONF["system"]))
    pc = CONF["predict"]
    state = ObjectState(**make_fleet(CONF["system"], CONF["vehicle_sizes"],
                                     {"speed": [5.0, 20.0]}, SEED, card))
    step = make_step(cfg, backend="fused", device=card)
    gen = torch.Generator(device=card).manual_seed(SEED)
    hist = empty_history(cfg.num_objects, pc["history_points"], device=card)
    for tick in range(1, pc["history_points"] + 1):
        state, _ = step(state, gen)
        hist = update_history(hist, state, tick * cfg.sim.dt)
    cls = classify_trajectories(hist)
    offs = torch.tensor(predict_offsets(pc["horizon"], pc["step"]),
                        dtype=torch.float32, device=card)
    sub = sub_window_config(cfg.detect, pc["sub_window"]).num_time_steps
    return cfg, build_cell_list(state, cfg, cls=cls), offs, sub


@pytest.mark.parametrize("k", [8, 32])
def test_predict_kernel_bit_equal_at_the_warn_cell(warn_cell_list, k):
    cfg, cl, offs, sub = warn_cell_list
    assert cl.n == 1_000_000 and offs.numel() == 20 and sub == 10
    before = fused_detect.predict_topk.launches
    got = fused_detect.predict_topk(cl, cfg, offs, k, sub)
    want = fused_detect.predict_topk_plain(cl, cfg, offs, k, sub)
    torch.cuda.synchronize()
    assert fused_detect.predict_topk.launches == before + 1
    assert torch.equal(got.keys.view(torch.int32),
                       want.keys.view(torch.int32))
    assert torch.equal(got.idx, want.idx)
    assert torch.equal(got.emitted, want.emitted)
    assert int(got.emitted.sum()) > 100_000
