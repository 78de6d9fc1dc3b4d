"""The fused step end to end on the CPU: the port's make_step(cfg,
backend='fused') against the JAX package's make_step (the XLA reference
path) in both detection modes, 2D and 3D; the hot-row top-up and its
certificate; and the one comparison with the Pallas step itself in
interpret mode.

Fleets come from numpy and accel_change_prob is 0, so both integrators
take the same step."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.engine import make_detect, step_fused
import tpu_collide_torch as tt
from tests.torch_parity import (alert_map, assert_alerts_equal, both_states,
                                jax_cfg, np_fleet, to_torch_cfg)

torch.set_num_threads(1)

KEY = 1


def _port_step(cfg, st):
    _, out = tt.make_step(cfg, backend="fused", device="cpu")(
        st, torch.Generator().manual_seed(0))
    return out


def _assert_counters_equal(jo, to):
    for f in ("num_risks", "num_pairs_checked", "num_alive"):
        assert int(getattr(to, f)) == int(getattr(jo, f)), f
    # 2e-4: the TPU slot-key quantisation allowed against JAX
    # (tests/test_fused_kernel.py:88)
    np.testing.assert_allclose(float(to.max_risk), float(jo.max_risk),
                               atol=2e-4)


@pytest.mark.parametrize("mode", ["fast", "precise"])
@pytest.mark.parametrize("is3d", [False, True])
def test_step_matches_jax_xla(is3d, mode):
    n = 400 if is3d else 500
    cfg = jax_cfg(n, is3d=is3d, mode=mode)
    # precise: real horizontal accelerations, so its sampled
    # constant-acceleration sweep differs from fast (guarded below)
    d = np_fleet(5, n, 1000.0 if is3d else 2000.0, is3d=is3d,
                 accel=mode == "precise")
    jst, st = both_states(d)
    _, jo = tc.make_step(cfg, donate=False)(jst, jax.random.key(KEY))
    assert int(jo.overflow) == 0 and int(jo.alert_overflow) == 0
    tcfg = to_torch_cfg(cfg)
    to = _port_step(tcfg, st)
    assert int(to.overflow) == 0 and int(to.alert_overflow) == 0
    # the scene budget does not bind on either side (the fused path keeps
    # both directions of a pair)
    assert int(to.alerts.count) < cfg.alerts.max_scene_alerts
    _assert_counters_equal(jo, to)
    want = alert_map(jo.alerts)
    assert len(want) > 10
    assert_alerts_equal(want, alert_map(to.alerts))
    if mode == "precise":
        fast = _port_step(tcfg.replace(
            detect=dataclasses.replace(tcfg.detect, mode="fast")), st)
        assert int(fast.num_risks) != int(to.num_risks), \
            "fleet too tame: precise == fast, the test would not discriminate"


def _hot_fleet():
    """A sparse fleet plus a star of 5 objects closing on one point: the 5
    star rows each hold 4 qualifying pairs, more than k = 1 slot."""
    n = 300
    d = np_fleet(8, n, 2000.0, clustered=0.0)
    ang = np.arange(5) * (2 * np.pi / 5)
    d["pos"][:5] = np.stack([1000 + 30 * np.cos(ang),
                             1000 + 30 * np.sin(ang), np.zeros(5)], -1)
    d["vel"][:5] = np.stack([-10 * np.cos(ang), -10 * np.sin(ang),
                             np.zeros(5)], -1)
    d["heading"][:5] = np.mod(ang + np.pi, 2 * np.pi)
    cfg = jax_cfg(n, mode="fast")
    cfg = cfg.replace(alerts=dataclasses.replace(
        cfg.alerts, max_alerts_per_object=1))
    return cfg, d


@pytest.mark.parametrize("hot_topup", [8, 0])
def test_hot_topup_and_its_certificate(hot_topup):
    cfg, d = _hot_fleet()
    jst, st = both_states(d)
    jst1, jo = tc.make_step(cfg, donate=False)(jst, jax.random.key(KEY))
    assert int(jo.overflow) == 0 and int(jo.alert_overflow) == 0
    # per-row qualifying counts of the XLA path on the stepped state
    pairs = make_detect(cfg)(jst1)
    qual = (np.asarray(pairs.valid)
            & (np.asarray(pairs.risk) >= cfg.alerts.risk_low)).sum(axis=1)
    k = cfg.alerts.max_alerts_per_object
    assert 0 < int((qual > k).sum()) <= 8     # hot rows, all coverable
    tcfg = to_torch_cfg(cfg)
    tcfg = tcfg.replace(detect=dataclasses.replace(tcfg.detect,
                                                   hot_topup=hot_topup))
    to = _port_step(tcfg, st)
    _assert_counters_equal(jo, to)
    if hot_topup:
        assert int(to.alert_overflow) == 0
        assert_alerts_equal(alert_map(jo.alerts), alert_map(to.alerts))
    else:
        assert int(to.alert_overflow) == int(np.maximum(qual - k, 0).sum())
        got = alert_map(to.alerts)
        assert set(got) < set(alert_map(jo.alerts))


def test_fast_step_equals_pallas_step_interpret():
    """The one interpret-mode comparison in the quick tier: the port's fast
    step against step_fused(..., interpret=True) as ORDERED pairs (both
    fused paths emit a pair from each of its sides)."""
    n = 500
    cfg = jax_cfg(n, mode="fast")
    d = np_fleet(5, n, 2000.0)
    jst, st = both_states(d)
    _, jo = step_fused(jst, jax.random.key(KEY), cfg, interpret=True)
    assert int(jo.overflow) == 0 and int(jo.alert_overflow) == 0
    to = _port_step(to_torch_cfg(cfg), st)
    assert int(to.alert_overflow) == 0
    _assert_counters_equal(jo, to)
    want = alert_map(jo.alerts, unordered=False)
    assert len(want) > 10
    assert_alerts_equal(want, alert_map(to.alerts, unordered=False))


def test_make_step_surface():
    """make_step keeps the JAX package's signature and default backend;
    every backend and chunk_size run; a state on another device is refused;
    with no device named, the entry points go to the card, and without one
    they raise instead of running on the CPU."""
    import inspect
    from tpu_collide_torch.core.device import resolve_device
    params = list(inspect.signature(tt.make_step).parameters)
    assert params[:5] == list(inspect.signature(tc.make_step).parameters)[:5]
    assert inspect.signature(tt.make_step).parameters["backend"].default \
        == "xla"
    cfg = tt.SystemConfig(num_objects=8)
    st = tt.empty_state(8, device="cpu")
    for kw in ({}, {"backend": "xla"}, {"chunk_size": 4},
               {"backend": "fused"}, {"backend": "fused", "chunk_size": 4}):
        st1, out = tt.make_step(cfg, device="cpu", **kw)(st, torch.Generator())
        assert int(out.num_alive) == 0 and int(out.alerts.count) == 0, kw
        assert [f.name for f in dataclasses.fields(out)] == [
            f.name for f in dataclasses.fields(tc.StepOutput)]
        assert out.alerts.valid.shape == (cfg.alerts.max_scene_alerts,)
    with pytest.raises(ValueError):
        tt.make_step(cfg, backend="pallas")
    with pytest.raises(ValueError, match="lies on"):
        tt.make_step(cfg, device="meta")(st, None)
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device(
            "cuda", torch.cuda.current_device())
    else:
        for call in (lambda: resolve_device(None), lambda: tt.make_step(cfg),
                     lambda: tt.empty_state(8)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
