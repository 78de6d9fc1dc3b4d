"""The port's fused_topk against the JAX package.

On the CPU fused_topk runs its plain PyTorch version; it is held against the
XLA reference path's per-object counts, stage-1 counter and best risks
(as tests/test_fused_kernel.py holds the Pallas kernel), and, in the slow
tier, against the Pallas kernel itself in interpret mode. The CUDA kernel is
held against the plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from tpu_collide.engine import make_detect
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import (KEY_NONE, fused_topk,
                                                    fused_topk_plain)
from tpu_collide_torch.kernels.refine import decode_risk
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


def _fleet(is3d, mode="fast", n=400, **detect):
    cfg = jax_cfg(n, is3d=is3d, mode=mode, **detect)
    d = np_fleet(3, n, 1000.0 if is3d else 2000.0, is3d=is3d,
                 accel=mode == "precise", dead=4)
    return cfg, d


def _by_object(cl, per_row):
    """Per-row values of the sorted layout, indexed by object."""
    out = np.zeros((cl.n,) + per_row.shape[1:], per_row.dtype)
    out[cl.order.numpy()] = per_row
    return out


@pytest.mark.parametrize("is3d", [False, True])
def test_plain_fused_topk_matches_xla(is3d):
    cfg, d = _fleet(is3d)
    jst, st = both_states(d)
    pairs = make_detect(cfg)(jst)
    valid = np.asarray(pairs.valid)
    want_cnt = valid.sum(axis=1)
    want_best = np.where(valid, np.asarray(pairs.risk), 0.0).max(axis=1)
    assert want_cnt.sum() > 20          # the fleet has risks to compare

    launches = fused_topk.launches
    tcfg = to_torch_cfg(cfg)
    cl = build_cell_list(st, tcfg)
    s = fused_topk(cl, tcfg, mode="hits")
    assert fused_topk.launches == launches == 0   # CPU: the plain version
    assert int(cl.overflow) == 0
    # counters exact (the port does not saturate at 2047)
    assert int(s.checked) == int(pairs.num_checked)
    np.testing.assert_array_equal(_by_object(cl, s.emitted.numpy()),
                                  want_cnt)
    occupied = s.idx >= 0
    assert torch.equal(occupied.sum(1), torch.clamp_max(s.emitted, 4))
    best = torch.where(occupied, decode_risk(s.keys),
                       torch.zeros_like(s.keys)).max(dim=1).values
    # 2e-4: the TPU slot-key quantisation the JAX comparison allows
    # (tests/test_fused_kernel.py:88); the port's keys are exact
    np.testing.assert_allclose(_by_object(cl, best.numpy()), want_best,
                               atol=2e-4)
    # slots ordered by key descending, empty slots last
    assert (s.keys[:, :-1] >= s.keys[:, 1:]).all()
    assert (s.keys[~occupied] == KEY_NONE).all()


def test_plain_fused_topk_chunking_is_invisible():
    """Chunking the pair enumeration changes nothing."""
    cfg, d = _fleet(False)
    _, st = both_states(d)
    tcfg = to_torch_cfg(cfg)
    cl = build_cell_list(st, tcfg)
    for mode in ("hits", "survivors"):
        a = fused_topk_plain(cl, tcfg, mode)
        b = fused_topk_plain(cl, tcfg, mode, max_pairs=500)
        for f in ("keys", "idx", "checked", "emitted", "qual"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (mode, f)


@pytest.mark.slow
@pytest.mark.parametrize("is3d", [False, True])
def test_plain_survivors_match_pallas_interpret(is3d):
    """Survivor counts and slot sets against the Pallas kernel itself
    (interpret mode, minutes on a CPU)."""
    from tpu_collide.kernels.cell_list import build_cell_list as jax_build
    from tpu_collide.kernels.fused_detect import (PACKED_OCC_MIN,
                                                  fused_topk as jax_topk)

    cfg, d = _fleet(is3d, mode="precise")
    jst, st = both_states(d)
    jcl = jax_build(jst, cfg)
    jkeys, jidx, jchecked, jemitted, _ = jax_topk(jcl, cfg, interpret=True,
                                                  mode="survivors")
    joid = np.asarray(jcl.oid_flat)
    tcfg = to_torch_cfg(cfg)
    cl = build_cell_list(st, tcfg)
    s = fused_topk(cl, tcfg, mode="survivors")
    assert int(s.checked) == int(jchecked)
    want = np.zeros(st.n, np.int64)
    want[joid[joid >= 0]] = np.asarray(jemitted)[joid >= 0]
    got = _by_object(cl, s.emitted.numpy())
    np.testing.assert_array_equal(got, want)
    k = cfg.detect.survivor_k
    toid = cl.oid.numpy()
    # the TPU kernel's empty slots can carry a column index; only keys above
    # PACKED_OCC_MIN are occupied
    jidx = np.where(np.asarray(jkeys) > PACKED_OCC_MIN, np.asarray(jidx), -1)
    for row, o in enumerate(joid):
        if o < 0 or want[o] > k:
            continue
        jset = {int(joid[c]) for c in jidx[row] if c >= 0}
        prow = int(np.flatnonzero(toid == o)[0])
        tset = {int(toid[c]) for c in s.idx[prow].numpy() if c >= 0}
        assert jset == tset, o


# ---- what the CUDA kernel's launch is planned by, on the host -------------

def _plan_by_enumeration(n, k):
    """The fewest lanes per object of 2 .. 32 with which the fleet fills
    GRID_MIN blocks (32 when it fills them with none), by trying each."""
    from tpu_collide_torch.kernels.fused_detect import GRID_MIN, THREADS
    for width in (2, 4, 8, 16, 32):
        span = THREADS // width
        if n // span >= GRID_MIN or width == 32:
            return dict(width=width, blocks=-(-n // span), threads=THREADS,
                        smem=span * k * 8)


@pytest.mark.parametrize("n", [1, 31, 1000, 6000, 20_000, 33_791, 33_792,
                               67_583, 67_584, 100_000, 135_167, 135_168,
                               1_000_000])
def test_launch_plan_spreads_a_fleet_over_the_card(n):
    from tpu_collide_torch.kernels.fused_detect import launch_plan
    for k in (1, 8, 32):
        plan = launch_plan(n, k)
        assert plan == _plan_by_enumeration(n, k)
        span = plan["threads"] // plan["width"]
        assert (plan["blocks"] - 1) * span < n <= plan["blocks"] * span


@pytest.mark.parametrize("width", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("is3d", [False, True])
def test_group_walk_visits_each_candidate_once(is3d, width):
    """The stride of a group's lanes through an object's concatenated runs
    (the kernel's settle) against a numpy enumeration of stencil_runs: lane
    gl takes the candidates gl, gl + width, ... of the concatenation, in
    order, so every candidate is visited once."""
    from tpu_collide_torch.kernels.cell_list import stencil_runs
    from tpu_collide_torch.kernels.fused_detect import group_walk
    cfg, d = _fleet(is3d, n=300)
    _, st = both_states(d)
    cl = build_cell_list(st, to_torch_cfg(cfg))
    start, end = (t.numpy() for t in stencil_runs(cl, torch.arange(cl.n)))
    assert start.shape[1] == (9 if is3d else 3)
    assert (end - start).sum(axis=1).max() > 2 * width
    for i in range(cl.n):
        want = np.concatenate([np.arange(a, b)
                               for a, b in zip(start[i], end[i])])
        lanes = group_walk(start[i].tolist(), end[i].tolist(), width)
        assert len(lanes) == width
        for gl, seen in enumerate(lanes):
            np.testing.assert_array_equal(seen, want[gl::width])


def test_param_block_follows_the_config():
    """The cached ctypes parameter block equals kernel_params(cfg), also
    for a config that differs from a cached one in one field."""
    import dataclasses
    from tpu_collide_torch.kernels.fused_detect import (PARAM_NAMES,
                                                        kernel_params,
                                                        param_block)
    cfg = to_torch_cfg(jax_cfg(100))
    other = cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                   search_radius=80.0))
    same = to_torch_cfg(jax_cfg(100))
    for _ in range(2):      # the second round comes from the cache
        for c in (cfg, other, same):
            want = kernel_params(c)
            assert list(param_block(c)) == [want[name]
                                            for name in PARAM_NAMES]
    assert param_block(cfg) is param_block(cfg)
    assert list(param_block(cfg)) == list(param_block(same))
    assert list(param_block(cfg)) != list(param_block(other))
    assert kernel_params(cfg)["r2"] == 10000.0
    assert kernel_params(other)["r2"] == 6400.0


def test_launch_refuses_wrong_tensors():
    from tpu_collide_torch.kernels.fused_detect import _check_inputs
    dev = torch.device("cpu")
    good = torch.zeros((4, 16), dtype=torch.float32)
    _check_inputs("fused_topk", dev, (("fields", good, torch.float32,
                                       (4, 16)),))
    for bad in (good.double(), good[:, :8], good.t().contiguous().t(),
                torch.zeros((4, 16), dtype=torch.float32, device="meta")):
        with pytest.raises(ValueError, match="fields must be a contiguous"):
            _check_inputs("fused_topk", dev, (("fields", bad, torch.float32,
                                               (4, 16)),))


def _dense_cell_list(mode, k):
    """A fleet with a crowd in one cell (chip_smoke.dense_fleet, small):
    rows that emit far more pairs than they have slots."""
    import dataclasses
    import chip_smoke as cs
    import tpu_collide_torch as tt
    from tpu_collide_torch.core.state import conform_fleet, state_from_numpy
    cfg = tt.SystemConfig(num_objects=160, world=tt.WorldConfig(
        hi=(2000.0, 2000.0, 0.0)))
    cfg = cs.with_slots(cfg.replace(detect=dataclasses.replace(
        cfg.detect, mode="fast" if mode == "hits" else "precise")), mode, k)
    d = cs.dense_fleet(80, 80, cfg.world.hi, cfg.grid.cell_size, seed=13)
    st = conform_fleet(state_from_numpy(
        d["pos"], d["vel"], d["acc"], d["heading"], d["size"], d["otype"],
        device="cpu"), cfg)
    return cfg, build_cell_list(st, cfg)


@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("mode", ["hits", "survivors"])
def test_plain_slots_are_the_k_best_of_the_total_order(mode, k):
    """fused_topk_plain on rows with emitted > k against a numpy brute
    force: of each row's emitted pairs the k first by (key descending,
    candidate sorted index ascending), and exact counts."""
    from tpu_collide_torch.kernels.cell_list import stencil_pairs
    from tpu_collide_torch.kernels.fused_detect import (_pair_math,
                                                        kernel_params)
    cfg, cl = _dense_cell_list(mode, k)
    got = fused_topk_plain(cl, cfg, mode)
    own, cand = stencil_pairs(cl, torch.arange(cl.n))
    ok1, emit, qual, key = _pair_math(
        cl.fields[own], cl.fields[cand], own != cand, kernel_params(cfg),
        cl.is3d, mode == "hits", cfg.detect.angle_form == "product")
    own, cand, key = (t[emit].numpy() for t in (own, cand, key))
    assert int(got.checked) == int(ok1.sum())
    np.testing.assert_array_equal(got.emitted.numpy(),
                                  np.bincount(own, minlength=cl.n))
    assert (got.emitted > k).sum() >= 30     # eviction is driven
    for i in range(cl.n):
        mine = np.flatnonzero(own == i)
        order = sorted(mine, key=lambda t: (-key[t], cand[t]))[:k]
        want_idx = np.full(k, -1, np.int32)
        want_key = np.full(k, KEY_NONE, np.float32)
        want_idx[:len(order)] = cand[order]
        want_key[:len(order)] = key[order]
        np.testing.assert_array_equal(got.idx[i].numpy(), want_idx)
        np.testing.assert_array_equal(got.keys[i].numpy(), want_key)


def test_slot_count_reaches_32():
    """The port's kernels keep up to 32 slots per object (the JAX package
    asserts k <= 16)."""
    import dataclasses
    from tpu_collide_torch.kernels.fused_detect import K_MAX, slot_count
    cfg = to_torch_cfg(jax_cfg(100))
    at = lambda k: cfg.replace(detect=dataclasses.replace(cfg.detect,
                                                          survivor_k=k))
    assert K_MAX == 32 and slot_count(at(32), "survivors") == 32
    with pytest.raises(ValueError, match="outside 1..32"):
        slot_count(at(33), "survivors")
