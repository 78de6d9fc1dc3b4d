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
