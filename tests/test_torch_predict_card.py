"""The predict kernel (csrc/fused_predict.cu) against its plain version
(kernels/fused_detect.predict_topk_plain) on a CUDA card, at every width
its launch plan (kernels/fused_detect.predict_plan) can choose, reached by
the launch's own rows (objects x offsets):

  * the warn cell's fleet (perfbench/configs/drones_1m_3d_warn.json): 1M
    drones in 10 x 10 x 0.5 km, trajectory classes from 100-point rings
    filled over 100 fused steps, a 1 s sub-window of 10 samples, at 1, 2,
    5 and 20 of its offsets and k_slots 8 and 32 (2 lanes a row);
  * chip_smoke.py's dense fleet (3,000 objects crowding one cell, 3,000
    spread) in the warn cell's 3D world and in bench.py's 100k 2D world, at
    1, 20, 30, 60 and 100 offsets over the 10 s horizon (32, 16, 8, 4 and 2
    lanes a row) and k 1, 8 and 32: lists longer than a group's round,
    more stage-1 survivors through a warp than its ring holds, last sweep
    rounds that are not full, more hits than slots.

Keys, indices and emitted counts equal as raw bits; one launch a call and
its plan recorded. Off the card every test skips. This file imports no
JAX, so that it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_predict_card.py
"""
import pytest
import torch

import chip_smoke as cs
from tpu_collide_torch.core.state import conform_fleet, state_from_numpy
from tpu_collide_torch.kernels import fused_detect
from tpu_collide_torch.kernels.cell_list import build_cell_list
from warn_cell_cases import card, warn_fleet  # noqa: F401

pytestmark = pytest.mark.card

# offsets of the warn cell's 20 by how many a call takes
WARN_OFFSETS = {1: [19], 2: [0, 19], 5: [3, 7, 11, 15, 19],
                20: list(range(20))}
# lanes a row that predict_plan gives the dense fleet's 6,000 objects by
# the offsets of a call
DENSE_WIDTH = {1: 32, 20: 16, 30: 8, 60: 4, 100: 2}


@pytest.fixture(scope="module")
def warn_cell_list(warn_fleet):
    """(cfg, the cell list with trajectory classes, offsets, sub-steps) of
    the warn cell's fleet after its ring's fill."""
    cfg, state, cls, offs, sub = warn_fleet
    return cfg, build_cell_list(state, cfg, cls=cls), offs, sub


@pytest.fixture(scope="module", params=["2d", "3d"])
def dense_cell_list(request, card, warn_fleet):
    """(cfg, cell list) of chip_smoke.dense_fleet in the warn cell's 3D
    world or bench.py's 100k 2D world, with random trajectory classes."""
    base = warn_fleet[0] if request.param == "3d" else cs.bench_configs()[0]
    d = cs.dense_fleet(cs.DENSE_CLUSTER, cs.DENSE_SPREAD, base.world.hi,
                       base.grid.cell_size, seed=13)
    cfg = base.replace(num_objects=cs.DENSE_CLUSTER + cs.DENSE_SPREAD)
    st = conform_fleet(state_from_numpy(
        d["pos"], d["vel"], d["acc"], d["heading"], d["size"], d["otype"],
        device=card), cfg)
    return cfg, build_cell_list(st, cfg,
                                cls=torch.tensor(d["cls"], device=card))


def check_bit_equal(cl, cfg, offs, k, sub):
    """One kernel call against the plain version: raw bits equal, one
    launch, the plan recorded. Returns the kernel's slots."""
    before = fused_detect.predict_topk.launches
    got = fused_detect.predict_topk(cl, cfg, offs, k, sub)
    want = fused_detect.predict_topk_plain(cl, cfg, offs, k, sub)
    torch.cuda.synchronize()
    assert fused_detect.predict_topk.launches == before + 1
    assert fused_detect.predict_topk.plan == fused_detect.predict_plan(
        cl.n, offs.numel(), k)
    assert torch.equal(got.keys.view(torch.int32),
                       want.keys.view(torch.int32))
    assert torch.equal(got.idx, want.idx)
    assert torch.equal(got.emitted, want.emitted)
    return got


@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("n_off", sorted(WARN_OFFSETS))
def test_predict_kernel_bit_equal_at_the_warn_cell(warn_cell_list, n_off,
                                                   k):
    cfg, cl, offs, sub = warn_cell_list
    assert cl.n == 1_000_000 and offs.numel() == 20 and sub == 10
    offs = offs[WARN_OFFSETS[n_off]].contiguous()
    got = check_bit_equal(cl, cfg, offs, k, sub)
    assert fused_detect.predict_topk.plan["width"] == 2
    # more than 100,000 hits at the cell's 20 offsets (about 846,000); the
    # last offset alone emits about 3,000
    assert int(got.emitted.sum()) > (100_000 if n_off == 20
                                     else 1_000 * n_off)


@pytest.mark.parametrize("n_off", sorted(DENSE_WIDTH))
def test_predict_kernel_bit_equal_on_the_dense_fleet(dense_cell_list,
                                                     n_off):
    cfg, cl = dense_cell_list
    offs = torch.linspace(0.0, cs.HORIZON - cs.PRED_STEP, n_off,
                          device=cl.fields.device)
    edges = cs.predict_edges(cl, cfg, offs, torch)
    assert edges["width"] == DENSE_WIDTH[n_off]
    assert cs.drives_predict_kernel(edges), edges
    for k in (1, 8, 32):
        got = check_bit_equal(cl, cfg, offs, k, cs.SUB_STEPS)
        assert fused_detect.predict_topk.plan["width"] == DENSE_WIDTH[n_off]
        assert int(got.emitted.max()) > k
