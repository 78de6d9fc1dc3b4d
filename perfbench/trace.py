"""The traced run's profiler window and what is read from it: the device
operations (kernels, copies, sets) with their intervals, the host
operations that were running, the device's busy time as the union of the
operations' intervals, and the breakdown of the result line."""
from __future__ import annotations

import time

MEM_OPS = ("Memcpy", "Memset")


class Window:
    """torch.profiler over a bounded run of steps or ticks. `start()` and
    `stop()` synchronise the device, so that the window's wall time covers
    all the work queued inside it."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.prof = None
        self.wall_s = 0.0
        self.units = 0

    def start(self) -> None:
        prof = self.torch.profiler
        acts = [prof.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(prof.ProfilerActivity.CUDA)
            self.torch.cuda.synchronize(self.device)
        self.prof = prof.profile(activities=acts)
        self.prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self.units = units

    def events(self) -> tuple:
        """([(name, start_us, end_us)] device operations, [(name, start_us,
        end_us)] host operations), both sorted by start."""
        dev, host = [], []
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
            (dev if e.device_type == cuda else host).append(span)
        dev.sort(key=lambda s: s[1])
        host.sort(key=lambda s: s[1])
        return dev, host


def merged(intervals) -> list:
    """The union of (start, end) intervals sorted by start, as a list of
    disjoint intervals."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(MEM_OPS)


def summary(window: Window) -> dict:
    """What the readers and the result line take from a window: the device
    operations and host operations, the busy seconds (the union of the
    device operations' intervals), the window's wall seconds, the units
    (steps or ticks) it covered, and the breakdown."""
    dev, host = window.events()
    busy = merged((s, e) for _, s, e in dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    for (s0, e0), (s1, e1) in zip(busy, busy[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(key=lambda g: -g[0])
    idle = []
    for length, a, b in gaps[:10]:
        idle.append([host_at(host, 0.5 * (a + b)), length * 1e-6])
    return dict(device=dev, host=host, busy_s=busy_s,
                window_s=window.wall_s, units=window.units,
                breakdown=dict(device_ops=[[n, t] for n, t in ops],
                               idle_gaps=idle))


def host_at(host, t: float) -> str:
    """The innermost host operation running at time t (the shortest one
    whose interval holds it), or "host (no operation)"."""
    best = None
    for name, s, e in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "host (no operation)"
