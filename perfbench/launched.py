"""Device time by the program's span that launched it.

The profiler links each device operation (kernel, copy, set) to the host
operation that launched it (the correlation of the launch, which
torch.profiler turns into the host event's `kernels`). `links(window)`
keeps that link as (the launching host operation's start, the device
operation's duration), both in us on the profiler's clock; the device
operations of a span are those whose launching operation starts inside
one of the span's intervals, wherever on the device timeline they ran.
"""
from __future__ import annotations

from bisect import bisect_right

from perfbench.spans import spans


def links(window) -> list:
    """[(launching host operation's start_us, device us)] of every device
    operation of a traced window that the profiler linked to a host
    operation."""
    cuda = window.torch.autograd.DeviceType.CUDA
    out = []
    for e in window.prof.events():
        if e.device_type == cuda:
            continue
        start = float(e.time_range.start)
        out.extend((start, float(k.duration)) for k in e.kernels)
    out.sort()
    return out


def launched_ms(trace: dict, name: str):
    """The device ms a unit of the operations launched inside spans
    `name`; None where the trace holds no such span, no unit or no linked
    device operation (a program without the span, a run without a card)."""
    own = sorted(spans(trace, name))
    launched = trace.get("launched") or []
    if not own or not launched or not trace["units"]:
        return None
    starts = [s for s, _ in own]
    total = 0.0
    for t, us in launched:
        i = bisect_right(starts, t) - 1
        if i >= 0 and t <= own[i][1]:
            total += us
    return total * 1e-3 / trace["units"]
