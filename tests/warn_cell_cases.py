"""The warn cell's fleet (perfbench/configs/drones_1m_3d_warn.json) on a
CUDA card, as fixtures of the card's prediction tests: 1M drones in 10 x 10
x 0.5 km, trajectory classes from 100-point rings filled over 100 fused
steps, 20 offsets 0.5 s apart, a 1 s sub-window. Off the card `card` skips.
Imports no JAX."""
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

CONF = json.loads((Path(__file__).resolve().parents[1] / "perfbench"
                   / "configs" / "drones_1m_3d_warn.json").read_text())
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the prediction's kernels have no "
                    "CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def warn_fleet(card):
    """(cfg, state, trajectory classes, offsets, sub-steps) of the warn
    cell's fleet after its ring's fill."""
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
    return cfg, state, cls, offs, sub
