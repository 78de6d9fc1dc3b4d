"""The port's spans (core/utils.span, traced) on the CPU: without a profiler
a span is the one shared no-op and records nothing; under torch.profiler
the fused step records tc.step over tc.integrate, tc.cell_list and
tc.refine, tc.detect_kernel inside tc.refine, and one tc.host_wait (the hot
top-up's mask read) or, with a hot row, two and a tc.hot_pairs span.

The plain detection version walks its pairs through stencil_pairs, so on
the CPU tc.detect_kernel holds host waits of its own (on the card the
kernel holds none); the counts below are of the waits outside it."""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_collide_torch as tt
from tpu_collide_torch.core import utils
from tpu_collide_torch.core.device import host_tensor
from tpu_collide_torch.engine import detect_and_alerts_fused
from tpu_collide_torch.kernels.fused_detect import fused_topk_plain
from tpu_collide_torch.sim.integrator import integrate
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


def _fleet(hot: bool):
    """(port config, port state on the CPU). hot: a star of 5 objects
    closing on one point, each with 4 qualifying pairs against k = 1 slot;
    else a sparse fleet with 32 slots, more than any row qualifies for."""
    n = 300
    d = np_fleet(8, n, 2000.0, clustered=0.0)
    k = 32
    if hot:
        ang = np.arange(5) * (2 * np.pi / 5)
        d["pos"][:5] = np.stack([1000 + 30 * np.cos(ang),
                                 1000 + 30 * np.sin(ang), np.zeros(5)], -1)
        d["vel"][:5] = np.stack([-10 * np.cos(ang), -10 * np.sin(ang),
                                 np.zeros(5)], -1)
        d["heading"][:5] = np.mod(ang + np.pi, 2 * np.pi)
        k = 1
    cfg = jax_cfg(n, mode="fast")
    cfg = cfg.replace(alerts=dataclasses.replace(
        cfg.alerts, max_alerts_per_object=k))
    return to_torch_cfg(cfg), both_states(d)[1]


def _spans(fn) -> list:
    """[(name, start_us, end_us)] of the tc.* host events recorded while
    fn runs under torch.profiler, and fn's result."""
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU]) as p:
        out = fn()
    got = sorted(((e.name, e.time_range.start, e.time_range.end)
                  for e in p.events() if e.name.startswith("tc.")),
                 key=lambda s: s[1])
    return got, out


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _waits_outside_the_kernel(spans) -> list:
    kernel = _named(spans, "tc.detect_kernel")
    return [w for w in _named(spans, "tc.host_wait")
            if not any(_inside(w, k) for k in kernel)]


def test_span_is_the_shared_noop_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = utils.span("tc.refine"), utils.span("tc.host_wait")
    assert a is b
    with a as got:
        assert got is None


def test_traced_calls_through_and_records_nothing_without_a_profiler():
    calls = []

    @utils.traced("tc.test")
    def f(x, y=1):
        calls.append((x, y))
        return x + y

    assert f(2, y=3) == 5 and calls == [(2, 3)]
    assert f.__name__ == "f"
    # a profiler started afterwards holds no span of the calls before it
    spans, _ = _spans(lambda: None)
    assert spans == []
    spans, got = _spans(lambda: f(1))
    assert got == 2 and [s[0] for s in spans] == ["tc.test"]


def test_fused_step_spans_nest():
    cfg, st = _fleet(hot=False)

    def step():
        with utils.span("tc.step"):
            nxt = integrate(st, cfg, torch.Generator().manual_seed(0))
            return detect_and_alerts_fused(nxt, cfg, topk=fused_topk_plain)

    spans, _ = _spans(step)
    (whole,) = _named(spans, "tc.step")
    for name in ("tc.integrate", "tc.cell_list", "tc.refine",
                 "tc.detect_kernel"):
        (s,) = _named(spans, name)
        assert _inside(s, whole), name
    (refine,) = _named(spans, "tc.refine")
    (kernel,) = _named(spans, "tc.detect_kernel")
    (cells,) = _named(spans, "tc.cell_list")
    (phys,) = _named(spans, "tc.integrate")
    assert _inside(kernel, refine)
    assert phys[2] <= cells[1] and cells[2] <= refine[1]
    (wait,) = _waits_outside_the_kernel(spans)
    assert _inside(wait, refine) and wait[1] >= kernel[2]
    assert all(_inside(w, whole) for w in _named(spans, "tc.host_wait"))


@pytest.mark.parametrize("hot", [True, False])
def test_hot_rows_open_hot_pairs_and_a_second_wait(hot):
    cfg, st = _fleet(hot)
    spans, out = _spans(lambda: detect_and_alerts_fused(
        st, cfg, topk=fused_topk_plain))
    (refine,) = _named(spans, "tc.refine")
    waits = _waits_outside_the_kernel(spans)
    hot_pairs = _named(spans, "tc.hot_pairs")
    assert int(out.alert_overflow) == 0
    if hot:
        (pairs,) = hot_pairs
        assert _inside(pairs, refine) and len(waits) == 2
        # the mask read, then the pair count inside the recompute
        assert not _inside(waits[0], pairs) and _inside(waits[1], pairs)
    else:
        assert hot_pairs == [] and len(waits) == 1
    assert all(_inside(w, refine) for w in waits)


def test_a_profiled_step_equals_an_unprofiled_one():
    cfg, st = _fleet(hot=True)
    step = tt.make_step(cfg, backend="fused", device="cpu")
    plain_state, plain = step(st, torch.Generator().manual_seed(0))
    _, (traced_state, traced) = _spans(
        lambda: step(st, torch.Generator().manual_seed(0)))
    assert torch.equal(plain_state.pos, traced_state.pos)
    assert int(plain.num_risks) == int(traced.num_risks)
    for f in ("vehicle_oid", "other_oid", "risk", "valid"):
        assert torch.equal(getattr(plain.alerts, f),
                           getattr(traced.alerts, f)), f


def test_host_tensor_is_torch_tensor_and_no_wait_on_the_cpu():
    """On the CPU a copy from the host waits for nothing: no span."""
    spans, got = _spans(lambda: host_tensor((1.5, 2.0), torch.float32,
                                            torch.device("cpu")))
    assert torch.equal(got, torch.tensor((1.5, 2.0), dtype=torch.float32))
    assert spans == []
