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
import pytest
import torch

from tpu_collide_torch.kernels import fused_detect
from tpu_collide_torch.kernels.cell_list import build_cell_list
from warn_cell_cases import card, warn_fleet  # noqa: F401

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def warn_cell_list(warn_fleet):
    """(cfg, the cell list with trajectory classes, offsets, sub-steps) of
    the warn cell's fleet after its ring's fill."""
    cfg, state, cls, offs, sub = warn_fleet
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
