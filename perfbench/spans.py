"""The program's own spans in a traced window, and what their readers share.

tpu_collide_torch opens host ranges named tc.* while a profiler records
(core/utils.span): they reach the window's host operations (trace["host"])
on the profiler's clock, the clock of the device operations. tc.step holds
one fused step; tc.integrate, tc.cell_list, tc.refine and tc.detect_kernel
(inside tc.refine) its layers; tc.hot_pairs the hot top-up's recompute;
tc.host_wait each point where the host waits for the device. Every reading
is None where the window holds no such span (a program without them).
"""
from __future__ import annotations

from bisect import bisect_right

from perfbench.trace import merged

STEP = "tc.step"
WAIT = "tc.host_wait"
HOT = "tc.hot_pairs"
LAYERS = ("tc.integrate", "tc.cell_list", "tc.refine", "tc.detect_kernel")


def spans(trace: dict, name: str) -> list:
    """[(start_us, end_us)] of the host operations called `name`."""
    return [(s, e) for n, s, e in trace["host"] if n == name]


class Union:
    """The union of intervals, and how much of an interval it covers."""

    def __init__(self, intervals):
        self.parts = merged(sorted(intervals))
        self.starts = [s for s, _ in self.parts]

    def covers(self, a: float, b: float) -> float:
        i = max(bisect_right(self.starts, a) - 1, 0)
        got = 0.0
        while i < len(self.parts) and self.parts[i][0] < b:
            s, e = self.parts[i]
            got += max(0.0, min(e, b) - max(s, a))
            i += 1
        return got


def self_ms(trace: dict, name: str):
    """The self time of layer span `name` in ms a unit: its spans' time
    less the part that spans of the other layers and host waits cover."""
    own = spans(trace, name)
    if not own or not trace["units"]:
        return None
    inside = Union((s, e) for n, s, e in trace["host"]
                   if n == WAIT or (n in LAYERS and n != name))
    total = sum((e - s) - inside.covers(s, e) for s, e in own)
    return total * 1e-3 / trace["units"]


def per_unit(trace: dict, name: str):
    """Spans `name` a unit, where the window holds steps (tc.step)."""
    if not trace["units"] or not spans(trace, STEP):
        return None
    return len(spans(trace, name)) / trace["units"]


def units_holding_pct(trace: dict, name: str):
    """100 x the steps (tc.step spans) that hold a span `name` / units."""
    steps = spans(trace, STEP)
    if not trace["units"] or not steps:
        return None
    starts = [s for s, _ in steps]
    held = set()
    for s, _ in spans(trace, name):
        i = bisect_right(starts, s) - 1
        if i >= 0 and s <= steps[i][1]:
            held.add(i)
    return 100.0 * len(held) / trace["units"]


def idle_in_step_pct(trace: dict):
    """100 x the time inside tc.step spans that no device operation covers
    / the window's wall time: the device's idle that the step leaves."""
    steps = spans(trace, STEP)
    if not trace["window_s"] or not steps:
        return None
    busy = Union((s, e) for _, s, e in trace["device"])
    idle_us = sum((e - s) - busy.covers(s, e) for s, e in steps)
    return 100.0 * idle_us * 1e-6 / trace["window_s"]
