"""Logging + resilience primitives (reference common/utils.py:15-197).

`Timer.elapsed_ms` is a *property* here — the reference defined it as a method
but called it as a property everywhere (SURVEY.md §2.9 #17); we implement what
the callers meant.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Optional

_CONFIGURED = False


def setup_logging(level: str = "INFO") -> None:
    """Root logging config (the reference imported a `setup_logging` that did
    not exist — collision_system.py:12; here it does)."""
    global _CONFIGURED
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    if not _CONFIGURED:
        setup_logging()
    return logging.getLogger(name)


def to_json(obj: Any) -> str:
    return json.dumps(obj, default=str)


def from_json(s: str) -> Any:
    return json.loads(s)


class Timer:
    """Context-manager stopwatch. Reference: utils.py:32-58."""

    def __init__(self):
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None

    def __enter__(self) -> "Timer":
        self.start_time = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end_time = time.perf_counter()

    @property
    def elapsed_s(self) -> float:
        if self.start_time is None:
            return 0.0
        end = self.end_time if self.end_time is not None else time.perf_counter()
        return end - self.start_time

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_s * 1000.0


class RateLimiter:
    """Token-bucket limiter. Reference: utils.py:60-119."""

    def __init__(self, rate: float, capacity: Optional[float] = None):
        self.rate = float(rate)
        self.capacity = float(capacity if capacity is not None else rate)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def allow(self, tokens: float = 1.0) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True
            return False

    def set_rate(self, rate: float) -> None:
        with self._lock:
            self._refill()
            self.rate = float(rate)
            self.capacity = max(self.capacity, self.rate)


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN breaker. Reference: utils.py:121-197."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, recovery_timeout: float = 30.0,
                 half_open_max_calls: int = 1):
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = half_open_max_calls
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._half_open_calls = 0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if time.monotonic() - self._opened_at >= self.recovery_timeout:
                    self.state = self.HALF_OPEN
                    self._half_open_calls = 0
                else:
                    return False
            if self._half_open_calls < self.half_open_max_calls:
                self._half_open_calls += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self.state = self.CLOSED

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self.state = self.OPEN
                self._opened_at = time.monotonic()

    def call(self, fn: Callable, *args, **kw) -> Any:
        if not self.allow():
            raise RuntimeError("circuit breaker open")
        try:
            out = fn(*args, **kw)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# ---- spans on the profiler's clock (the port's own; the part above is the
# JAX package's module, copied) ----------------------------------------------
#
# `span(name)` marks a stretch of host work as a range that torch.profiler
# records among its host events, on the clock of its device events: the
# port's fused step names its layers and its host waits so (tc.step,
# tc.integrate, tc.cell_list, tc.refine, tc.detect_kernel, tc.hot_pairs,
# tc.host_wait; in precise mode tc.survivor_cut and tc.precise_sweep inside
# tc.refine), and prediction its own (tc.predict around engine.make_predict's
# call, with tc.classify, tc.predict_kernel, tc.predict_merge,
# tc.predict_topup and tc.predict_compact, the scatter to object order and
# the compaction, inside it; tc.history around each ring update). Every
# read on which the host waits for a card inside tc.step, tc.predict or
# tc.history is a tc.host_wait (core/device.host_wait): in a prediction the
# offsets' copy, the occupied slots' count and the top-up's check besides
# the constants, in a ring update the timestamp's copy. The range
# is a FUNCTION-scope record (_RecordFunctionFast), not
# torch.profiler.record_function: a user-scope range gets a device-side
# twin (a gpu_user_annotation event) in a CUDA trace, which a reader of the
# device timeline would take for a kernel. While no profiler records, a span
# costs one flag read and hands back one shared context that does nothing.

import functools  # noqa: E402

from torch._C._profiler import _RecordFunctionFast  # noqa: E402
from torch.autograd import profiler as _profiler  # noqa: E402


class _NoSpan:
    """The context span() returns while no profiler records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


def span(name: str):
    """A host range `name` while a profiler records, else the shared no-op:
    `with span("tc.refine"): ...`."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _RecordFunctionFast(name)


def traced(name: str):
    """The decorator form of span: every call of the function inside
    span(name), the profiler looked at on each call (a decorator runs once,
    when its module is imported, while no profiler records)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _RecordFunctionFast(name):
                return fn(*args, **kwargs)
        return call
    return wrap
