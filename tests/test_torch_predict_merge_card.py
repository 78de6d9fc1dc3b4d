"""The prediction's merge kernel (csrc/predict_merge.cu, kernels/refine.
merge_slots) against its plain version (refine.merge_slots_plain: the dense
pool of every row's n_off x k_slots slot columns and merge_pair_risks) on a
CUDA card, every output and the merge_k-th pool risk equal as raw bits:

  * the warn cell's predict slots (perfbench/configs/drones_1m_3d_warn.json:
    1M drones, 20 offsets, merge_k 32) at k_slots 8 and 32;
  * slot sets made to break a merge (tests/predict_merge_cases.py
    `adversarial_slots`) at the warn cell's shapes and at others: more
    than merge_k hits in a row, full rows of n_off x k_slots columns
    (640 at 20 x 32), one other id at several
    offsets and slots at equal and unequal risks, equal risks in different
    columns, occupied slots none of which hits, rows with no slot (halo
    mirrors and dead rows), merge_k past a warp, more offsets than lanes,
    merges wider than the kernel's shared memory holds (its global
    scratch) and merge_k past the row's columns;
  * fused_predict_rows at k_slots 1 on the warn cell's fleet, where nearly
    every truncation is uncertified, so the hot top-up re-merges its rows:
    the kernel's path and the plain path give the same lists and counters.

Off the card every test skips. This file imports no JAX, so that it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_predict_merge_card.py
"""
import pytest
import torch

from predict_merge_cases import adversarial_slots, assert_bits_equal
from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import predict_topk
from warn_cell_cases import card, warn_fleet  # noqa: F401

pytestmark = pytest.mark.card

SEED = 2 ** 31 + 91


def _kernel_vs_plain(shape, at, vals, merge_k):
    before = refine.merge_slots.launches
    got = refine.merge_slots(shape, at, vals, merge_k)
    want = refine.merge_slots_plain(shape, at, vals, merge_k)
    torch.cuda.synchronize()
    assert refine.merge_slots.launches == before + 1
    assert_bits_equal(got, want)
    return got


@pytest.mark.parametrize("k_slots", [8, 32])
def test_merge_bit_equal_at_the_warn_cell(warn_fleet, k_slots):
    cfg, state, cls, offs, sub = warn_fleet
    cl = build_cell_list(state, cfg, cls=cls)
    assert cl.n == 1_000_000 and offs.numel() == 20
    s = predict_topk(cl, cfg, offs, k_slots, sub)
    at = ((s.idx >= 0) & cl.own[None, :, None]).nonzero(as_tuple=True)
    vals = refine._predict_pairs(cl, at[1], s.idx[at].to(torch.int64),
                                 offs[at[0]], cfg, 1.0)
    got = _kernel_vs_plain(s.idx.shape, at, vals, 32)
    assert int(got[1].sum()) > 100_000


@pytest.mark.parametrize("n_off,m,k_slots,merge_k", [
    (20, 1_000_000, 8, 32),      # the warn cell's shapes
    (20, 1_000_000, 32, 32),     # Scene.predict's doubling: 640 columns
    (20, 4096, 32, 100),         # merge_k past a warp
    (40, 4096, 4, 32),           # more offsets than lanes
    (5, 2000, 1, 4),
    (40, 2000, 8, 256),          # the most kept hits in shared memory
    (20, 4096, 32, 300),         # kept hits in the global scratch
    (20, 4096, 32, 1000),        # the same, merge_k past the 640 columns
    (4, 2000, 8, 300),           # merge_k past the 32 columns
])
def test_merge_bit_equal_on_adversarial_slots(card, n_off, m, k_slots,
                                              merge_k):
    got = _kernel_vs_plain(*adversarial_slots(n_off, m, k_slots, SEED + m,
                                              card), merge_k)
    assert bool(got[1].any())
    assert bool((got[5] >= 0).any()) == (merge_k <= n_off * k_slots)


def test_hot_topup_bit_equal_at_the_warn_cell(warn_fleet, monkeypatch):
    """k_slots 1 at merge_k 32: nearly every truncated (offset, row) stays
    uncertified, so the hot top-up recomputes its 1,024 flagged entries and
    re-merges its 512 rows on both paths."""
    cfg, state, cls, _, _ = warn_fleet
    calls = []
    pool_rows = refine._slot_pool_rows
    monkeypatch.setattr(refine, "_slot_pool_rows",
                        lambda *a: calls.append(1) or pool_rows(*a))
    before = refine.merge_slots.launches
    got = refine.fused_predict_rows(state, cls, cfg, k_slots=1)
    assert refine.merge_slots.launches == before + 1 and calls
    monkeypatch.setattr(refine, "merge_slots", refine.merge_slots_plain)
    want = refine.fused_predict_rows(state, cls, cfg, k_slots=1)
    torch.cuda.synchronize()
    assert int(got[9]) > 0
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
