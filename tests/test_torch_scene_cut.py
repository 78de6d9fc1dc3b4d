"""The fast tail's scene cut (kernels/refine.scene_cut, csrc/scene_cut.cu)
on the CPU.

The CUDA kernel runs only on the card (chip_smoke.py holds it bit-equal to
scene_cut_plain there). Here a numpy mirror of its algorithm, step for step
(row bests, an 11-bit radix selection of the a-th row composite, the pool
of the chosen rows' and the hot keys at or above its key, the pool's own
selection and order), must equal scene_cut_plain, the flat cut, on every
qualifying position, on the count and on max_risk, at shapes where ties,
covered rows, halo mirrors and small fleets decide the result.
"""
import zlib

import numpy as np
import pytest
import torch

from tpu_collide_torch.kernels import refine
from tpu_collide_torch.kernels.fused_detect import KEY_NONE, fused_topk_plain
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)

KEY_TOP = np.uint32(0x7F800000)
DIGIT = 11


# ---- the kernel's cut, mirrored in numpy -----------------------------------

def _select(comps: np.ndarray, need: int, width: int) -> int:
    """The threshold of csrc/scene_cut.cu's radix selection: the need-th
    largest of the unique `width`-bit composites, fixed 11 bits a pass from
    the top; 0 when there are no more than `need`."""
    thresh = 0
    for d in range(-(-width // DIGIT)):
        hi = width - DIGIT * d
        lo = max(hi - DIGIT, 0)
        group = comps[(comps >> np.uint64(hi)) == np.uint64(thresh >> hi)]
        digits = (group >> np.uint64(lo)) & np.uint64((1 << (hi - lo)) - 1)
        hist = np.bincount(digits.astype(np.int64), minlength=1 << (hi - lo))
        if d == 0 and hist.sum() <= need:
            return 0
        above = 0
        for b in range((1 << (hi - lo)) - 1, -1, -1):
            if above + hist[b] >= need:
                break
            above += hist[b]
        need -= above
        thresh |= b << lo
        if hist[b] == need:
            return thresh
    raise AssertionError("the selection did not end on one composite")


def mirror_cut(keys, own, covered, hkey, a):
    """(top_key, top_i, count, max_risk) as the kernel computes them."""
    keys, hkey = keys.numpy(), hkey.numpy()
    own, covered = own.numpy(), covered.numpy()
    m, k = keys.shape
    mk = m * k
    bits = lambda x: np.where(x.view(np.uint32) == 0x80000000, 0,
                              x.view(np.uint32)).astype(np.uint32)
    u, hu = bits(keys), bits(hkey)
    qual = u <= KEY_TOP

    occupied = keys > KEY_NONE
    risk = np.where(occupied, keys - np.float32(2.0) * np.floor(
        keys * np.float32(0.5)), np.float32(0.0)).astype(np.float32)
    max_risk = np.float32(max(risk.max(initial=0.0), 0.0))
    if a == 0:                  # step 1 for max_risk, then count 0
        return np.zeros(0, np.float32), np.zeros(0, np.int64), 0, max_risk

    # 1-2: each row's best qualifying key; the a-th row composite
    L = max(m - 1, 0).bit_length()
    has = own & ~covered & qual.any(axis=1)
    best = np.where(qual, u, 0).max(axis=1, initial=0).astype(np.uint64)
    rows = np.flatnonzero(has).astype(np.uint64)
    comp = (best[has] << np.uint64(L)) | (np.uint64((1 << L) - 1) - rows)
    T = _select(comp, a, 31 + L)
    chosen = rows[comp >= np.uint64(T)].astype(np.int64)
    tb = T >> L

    # 3: the pool
    L2 = max(mk + hkey.size - 1, 0).bit_length()
    flat = (chosen[:, None] * k + np.arange(k)).reshape(-1)
    flat = flat[qual.reshape(-1)[flat] & (u.reshape(-1)[flat] >= tb)]
    hot = np.flatnonzero((hu <= KEY_TOP) & (hu >= tb))
    pool_u = np.concatenate([u.reshape(-1)[flat], hu[hot]]).astype(np.uint64)
    pool_f = np.concatenate([flat, mk + hot]).astype(np.uint64)
    mask2 = np.uint64((1 << L2) - 1)
    pool = (pool_u << np.uint64(L2)) | (mask2 - pool_f)

    # 4: the pool's a best, in order
    T2 = _select(pool, a, 31 + L2)
    top = np.sort(pool[pool >= np.uint64(T2)])[::-1]
    top_i = (mask2 - (top & mask2)).astype(np.int64)
    allk = np.concatenate([keys.reshape(-1), hkey])
    return allk[top_i], top_i, top.size, max_risk


# ---- inputs ------------------------------------------------------------------

def _rows(rng, m, k, share, levels=None):
    """[m, k] slot keys as the detection kernel leaves them, per row
    descending: qualifying 2 * priority + risk, sub-threshold risk - 2,
    empty KEY_NONE. `levels` draws risks from that many values only."""
    risk = (rng.integers(0, levels, (m, k)) / max(levels - 1, 1)
            if levels else rng.random((m, k)))
    prio = rng.integers(0, 4, (m, k))
    kind = rng.random((m, k))
    keys = np.where(kind < share, 2.0 * prio + np.maximum(risk, 0.3),
                    np.where(kind < share + 0.2, risk - 2.0, KEY_NONE))
    return -np.sort(-keys.astype(np.float32), axis=1)


def _case(name):
    """(keys, own, covered, hkey, a) of one named case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    m, k, p, a = 300, 8, 40, 64
    keys = _rows(rng, m, k, 0.4)
    own = rng.random(m) < 0.9
    covered = rng.random(m) < 0.05
    hkey = _rows(rng, 1, p, 0.5)[0]
    if name == "all_tied":
        keys[:] = 7.0
        hkey[:] = 7.0
        own[:], covered[:] = True, False
    elif name == "ties_across_threshold":
        # the a-th row best lies inside a run of 90 equal bests, and those
        # rows' other slots tie with it too
        keys = _rows(rng, m, k, 0.3, levels=3)
        keys[100:190, :3] = 6.5
        keys[:40, 0] = 7.0
        keys = -np.sort(-keys, axis=1)
    elif name == "hot_tied_with_slots":
        keys = _rows(rng, m, k, 0.5, levels=2)
        hkey = np.full(p, 7.0, np.float32)
        hkey[::3] = 6.0
    elif name == "fewer_than_a":
        keys = _rows(rng, m, k, 0.01)
        hkey = _rows(rng, 1, p, 0.05)[0]
        a = 1024
    elif name == "m_at_most_a":
        m, a = 40, 60
        keys, own, covered = keys[:m], own[:m], covered[:m]
    elif name == "all_entries":
        m, k, p = 5, 4, 3
        keys, own, covered = _rows(rng, m, k, 0.7), own[:m], covered[:m]
        hkey = _rows(rng, 1, p, 0.7)[0]
        a = m * k + p
    elif name == "covered_rows":
        covered = rng.random(m) < 0.5
        keys[covered, 0] = 7.0
    elif name == "halo_mirrors":
        own = rng.random(m) < 0.5
        keys[~own, :2] = 7.0
        keys[~own, 2:] = KEY_NONE
    elif name == "sub_threshold_only":
        keys = np.where(keys >= 0.0, keys - 8.0, keys).astype(np.float32)
        keys = np.maximum(keys, -2.0).astype(np.float32)
        keys[rng.random((m, k)) < 0.3] = KEY_NONE
        hkey = np.full(p, KEY_NONE, np.float32)
    elif name == "odd_k_unsorted":
        k = 3
        keys = rng.permuted(_rows(rng, m, k, 0.5, levels=4), axis=1)
    elif name == "signed_zero":
        keys = np.where(rng.random((m, k)) < 0.5, 0.0, -0.0).astype(
            np.float32)
        hkey[:] = -0.0
    elif name == "wide_fleet":
        m, a, p = 5000, 1000, 0
        keys = _rows(rng, m, k, 0.6)
        own, covered = rng.random(m) < 0.95, rng.random(m) < 0.01
        hkey = np.zeros(0, np.float32)
    elif name == "a_zero":
        a = 0
    elif name == "a_one":
        a = 1
    elif name == "k_one":
        k = 1
        keys = _rows(rng, m, k, 0.5, levels=3)
    elif name == "one_row":
        m, a = 1, 20
        keys, own, covered = keys[:1], np.ones(1, bool), np.zeros(1, bool)
    elif name == "hot_keys_only":
        m, a = 0, 25
        keys = np.zeros((0, k), np.float32)
        own, covered = np.zeros(0, bool), np.zeros(0, bool)
    elif name == "nothing_at_all":
        m, p, a = 0, 0, 0
        keys = np.zeros((0, k), np.float32)
        own, covered = np.zeros(0, bool), np.zeros(0, bool)
        hkey = np.zeros(0, np.float32)
    elif name == "every_row_covered":
        covered = np.ones(m, bool)
    elif name == "past_sort_cap":
        # every slot qualifying and more listed than the final block sorts
        # in shared memory (4,096)
        m, a = 700, 5000
        keys = _rows(rng, m, k, 1.1, levels=5)
        own, covered = np.ones(m, bool), np.zeros(m, bool)
    elif name == "hot_above_sub_threshold_rows":
        keys = np.where(keys >= 0.0, keys - 8.0, keys).astype(np.float32)
        keys = np.maximum(keys, -2.0).astype(np.float32)
    elif name == "max_risk_off_the_list":
        # the riskiest slots lie in halo mirrors and covered rows
        own = rng.random(m) < 0.6
        covered = own & (rng.random(m) < 0.2)
        keys[~own | covered, 0] = 7.999
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return t(keys.astype(np.float32)), t(own), t(covered), \
        t(hkey.astype(np.float32)), a


CASES = ("random", "all_tied", "ties_across_threshold", "hot_tied_with_slots",
         "fewer_than_a", "m_at_most_a", "all_entries", "covered_rows",
         "halo_mirrors", "sub_threshold_only", "odd_k_unsorted",
         "signed_zero", "wide_fleet", "a_zero", "a_one", "k_one", "one_row",
         "hot_keys_only", "nothing_at_all", "every_row_covered",
         "past_sort_cap", "hot_above_sub_threshold_rows",
         "max_risk_off_the_list")


@pytest.mark.parametrize("name", CASES)
def test_mirror_of_the_kernel_equals_the_flat_cut(name):
    keys, own, covered, hkey, a = _case(name)
    want = refine.scene_cut_plain(keys, own, covered, hkey, a)
    top_key, top_i, count, max_risk = mirror_cut(keys, own, covered, hkey, a)
    n = int(want.count)
    assert count == n
    if name in ("sub_threshold_only", "a_zero", "nothing_at_all"):
        assert n == 0
    if name in ("hot_keys_only", "hot_above_sub_threshold_rows"):
        assert 0 < n and (want.top_i[:n] >= keys.numel()).all()
    if name == "max_risk_off_the_list":
        assert float(want.max_risk) > float(want.top_key[:n].max()) % 2.0
    if name in ("all_tied", "ties_across_threshold", "hot_tied_with_slots"):
        assert n == a    # the cut binds inside a run of equal keys
    np.testing.assert_array_equal(top_i, want.top_i[:n].numpy())
    np.testing.assert_array_equal(top_key.view(np.uint32),
                                  want.top_key[:n].numpy().view(np.uint32))
    assert np.float32(max_risk).view(np.uint32) == \
        want.max_risk.numpy().view(np.uint32)


def test_cpu_takes_the_plain_cut_and_launches_nothing():
    keys, own, covered, hkey, a = _case("random")
    refine.scene_cut.launches = 0
    got = refine.scene_cut(keys, own, covered, hkey, a)
    want = refine.scene_cut_plain(keys, own, covered, hkey, a)
    assert refine.scene_cut.launches == 0
    for f in ("top_key", "top_i", "count", "max_risk"):
        assert torch.equal(getattr(got, f), getattr(want, f))


def test_a_device_without_the_kernel_raises():
    keys, own, covered, hkey, a = (x.to("meta") if torch.is_tensor(x) else x
                                   for x in _case("random"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        refine.scene_cut(keys, own, covered, hkey, a)


@pytest.mark.parametrize("a", [-1, 300 * 8 + 40 + 1])
def test_a_cut_past_the_entries_raises(a):
    keys, own, covered, hkey, _ = _case("random")
    with pytest.raises(ValueError, match="no cut"):
        refine.scene_cut(keys, own, covered, hkey, a)


def test_occupied_slots_are_the_keys_above_key_none():
    """The cut reads occupancy from the keys alone (key > KEY_NONE), not
    from idx >= 0: the slots' contract makes the two the same."""
    cfg = to_torch_cfg(jax_cfg(600, max_relative_speed=1.0))
    _, st = both_states(np_fleet(3, 600, 2000.0))
    s = fused_topk_plain(build_cell_list(st, cfg), cfg, "hits")
    occupied = s.idx >= 0
    assert 0 < int(occupied.sum()) < occupied.numel()
    assert torch.equal(s.keys > KEY_NONE, occupied)
