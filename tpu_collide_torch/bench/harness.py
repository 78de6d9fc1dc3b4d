"""Performance-test harness with reference-compatible artifacts (the port of
tpu_collide/bench/harness.py).

The step-loop tester shape of the reference's measured harness
(optimized_performance_test.py:793-1149): each "request" is one full scene
step (physics + index rebuild + detection), timed on the host clock up to
the host's read of the step's risk count, so a latency is the step's time
and not its enqueue time. Latencies and rolling metrics are written as

    <out>/perf_test_<N>vehicles_<TPS>tps_<D>s_<stamp>_latencies.csv
    <out>/..._metrics.csv      (same columns as the reference, :1052-1056)
    <out>/..._summary.txt      (same fields; English labels)

with the JAX module's names, headers and fields. The steps run on `device`
(the CUDA card unless another is named); backend='fused' launches the
detection kernel once a step. The fleet comes from a generator seeded 0, the
warm-up step (the kernels' first build and launch) from one seeded 1, and
step i of the measured window from one seeded 2 + i, so a run can be
replayed step for step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from datetime import datetime
from typing import List

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import resolve_device
from tpu_collide_torch.core.utils import get_logger
from tpu_collide_torch.engine import make_step
from tpu_collide_torch.sim import generate_fleet

logger = get_logger(__name__)


@dataclasses.dataclass
class PerformanceMetrics:
    """reference optimized_performance_test.py:39-51"""
    throughput: float = 0.0
    avg_latency: float = 0.0
    p95_latency: float = 0.0
    p99_latency: float = 0.0
    max_latency: float = 0.0
    error_rate: float = 0.0
    cpu_usage: float = 0.0
    memory_usage: float = 0.0
    timestamp: float = dataclasses.field(default_factory=time.time)


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(p * len(sorted_vals)))
    return sorted_vals[i]


def seeded(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded `seed`: the harness draws its fleet
    from seed 0, its warm-up step from 1 and measured step i from 2 + i."""
    return torch.Generator(device=device).manual_seed(seed)


class PerformanceTester:
    """Step-loop tester (reference OptimizedPerformanceTester,
    optimized_performance_test.py:793-981)."""

    def __init__(self, cfg: SystemConfig, output_dir: str = "results",
                 backend: str = "xla", distribution: str = "city_skew",
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir
        self.backend = backend
        self.distribution = distribution
        self.device = resolve_device(device)
        self.latencies: List[float] = []
        self.metrics_history: List[PerformanceMetrics] = []
        self.request_count = 0
        self.error_count = 0
        self.total_risks = 0
        self.start_time = 0.0
        self.end_time = 0.0

    def _cpu_mem(self):
        try:
            import psutil
            return (psutil.cpu_percent(interval=None),
                    psutil.virtual_memory().percent)
        except ImportError:
            return 0.0, 0.0

    def _calculate_metrics(self) -> PerformanceMetrics:
        lat = sorted(self.latencies)
        dur = max(self.end_time - self.start_time, 1e-9)
        cpu, mem = self._cpu_mem()
        return PerformanceMetrics(
            throughput=self.request_count / dur,
            avg_latency=float(np.mean(lat)) if lat else 0.0,
            p95_latency=_percentile(lat, 0.95),
            p99_latency=_percentile(lat, 0.99),
            max_latency=lat[-1] if lat else 0.0,
            error_rate=(self.error_count / self.request_count * 100
                        if self.request_count else 0.0),
            cpu_usage=cpu, memory_usage=mem)

    def run_test(self, target_tps: int, duration: float,
                 save: bool = True,
                 profile_dir: str | None = None) -> PerformanceMetrics:
        """Open-loop step loop at target_tps (0: as fast as the steps go)
        for `duration` seconds (reference :850-981: per-request = one
        full-scene step; metrics snapshot every 10 requests).

        profile_dir: capture a torch.profiler trace of the measured window
        (CPU and, on a card, CUDA activity) into this directory as a Chrome
        trace (`*.pt.trace.json`), viewable in Perfetto or TensorBoard.
        The profiler starts before the window opens and writes its trace
        after it closes, so neither counts in the run's duration. Where
        tracing fails the run logs a warning and proceeds unprofiled."""
        dev = self.device
        state = generate_fleet(seeded(0, dev), self.cfg,
                               distribution=self.distribution)
        stepf = make_step(self.cfg, backend=self.backend, device=dev)
        # the first build and launch of the kernels, outside the window
        state, out = stepf(state, seeded(1, dev))
        out.num_risks.item()

        prof = contextlib.nullcontext()
        if profile_dir:
            prof = _SafeTrace(profile_dir, dev)

        interval = 1.0 / target_tps if target_tps > 0 else 0.0
        i = 0
        with prof:
            self.start_time = time.perf_counter()
            deadline = self.start_time + duration
            while time.perf_counter() < deadline:
                t0 = time.perf_counter()
                try:
                    state, out = stepf(state, seeded(2 + i, dev))
                    self.total_risks += int(out.num_risks.item())
                except Exception as e:  # noqa: BLE001
                    self.error_count += 1
                    logger.error("step error: %s", e)
                self.latencies.append((time.perf_counter() - t0) * 1e3)
                self.request_count += 1
                i += 1
                if self.request_count % 10 == 0:
                    self.end_time = time.perf_counter()
                    self.metrics_history.append(self._calculate_metrics())
                sleep = interval - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
            self.end_time = time.perf_counter()
        final = self._calculate_metrics()
        if save:
            self.save_results(target_tps, int(duration))
        return final

    def save_results(self, target_tps: int, duration: int) -> str:
        """Reference artifact triplet (optimized_performance_test.py:
        1033-1088)."""
        os.makedirs(self.output_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        base = os.path.join(
            self.output_dir,
            f"perf_test_{self.cfg.num_objects}vehicles_{target_tps}tps_"
            f"{duration}s_{stamp}")

        with open(base + "_latencies.csv", "w") as f:
            f.write("latency_ms\n")
            for v in self.latencies:
                f.write(f"{v}\n")

        with open(base + "_metrics.csv", "w") as f:
            f.write("timestamp,throughput,avg_latency,p95_latency,"
                    "p99_latency,max_latency,error_rate,cpu_usage,"
                    "memory_usage\n")
            for m in self.metrics_history:
                f.write(f"{m.timestamp},{m.throughput},{m.avg_latency},"
                        f"{m.p95_latency},{m.p99_latency},{m.max_latency},"
                        f"{m.error_rate},{m.cpu_usage},{m.memory_usage}\n")

        fm = self._calculate_metrics()
        w = self.cfg.world
        with open(base + "_summary.txt", "w") as f:
            f.write("Performance test summary (tpu-collide)\n")
            f.write("================\n\n")
            f.write("Test configuration:\n")
            f.write(f"  Vehicles: {self.cfg.num_objects}\n")
            f.write(f"  Target TPS: {target_tps}\n")
            f.write(f"  Duration: {duration}s\n")
            f.write(f"  Map size: ({w.hi[0] - w.lo[0]:.0f}, "
                    f"{w.hi[1] - w.lo[1]:.0f})\n")
            f.write(f"  Backend: {self.backend} / "
                    f"{self.cfg.detect.mode} mode\n\n")
            f.write("Results:\n")
            f.write(f"  Total requests: {self.request_count}\n")
            f.write(f"  Total errors: {self.error_count}\n")
            f.write(f"  Error rate: {fm.error_rate:.2f}%\n")
            f.write(f"  Actual duration: "
                    f"{self.end_time - self.start_time:.2f}s\n")
            f.write(f"  Throughput: {fm.throughput:.2f} req/s\n\n")
            f.write("Latency (ms):\n")
            f.write(f"  Average: {fm.avg_latency:.2f}\n")
            f.write(f"  P95: {fm.p95_latency:.2f}\n")
            f.write(f"  P99: {fm.p99_latency:.2f}\n")
            f.write(f"  Max: {fm.max_latency:.2f}\n\n")
            f.write("Resources:\n")
            f.write(f"  CPU: {fm.cpu_usage:.2f}%\n")
            f.write(f"  Memory: {fm.memory_usage:.2f}%\n")
            f.write(f"\nTotal risks detected: {self.total_risks}\n")
        logger.info("results saved to %s_*", base)
        return base


class _SafeTrace:
    """torch.profiler over the measured window, written into `directory`
    as a Chrome trace; where tracing fails it degrades to a no-op with a
    warning instead of failing the perf run."""

    def __init__(self, directory, device: torch.device):
        self.directory = directory
        self.device = device
        self._cm = None

    def __enter__(self):
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(self.directory, exist_ok=True)
            self._cm = profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(self.directory))
            self._cm.__enter__()
        except Exception as e:  # noqa: BLE001
            logger.warning("profiler unavailable: %s", e)
            self._cm = None
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            try:
                return self._cm.__exit__(*exc)
            except Exception as e:  # noqa: BLE001
                logger.warning("profiler stop failed: %s", e)
        return False


def main(argv=None):
    """CLI mirroring the reference tester (optimized_performance_test.py:
    1152-1194), plus --device."""
    import argparse
    from tpu_collide_torch.core.config import DetectionConfig

    ap = argparse.ArgumentParser(description="tpu-collide perf test")
    ap.add_argument("--vehicles", type=int, default=1000)
    ap.add_argument("--tps", type=int, default=1000)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--output-dir", default="results")
    ap.add_argument("--mode", default="precise", choices=["precise", "fast"])
    ap.add_argument("--backend", default="xla", choices=["xla", "fused"])
    ap.add_argument("--distribution", default="city_skew",
                    choices=["city_skew", "uniform"])
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the measured "
                         "window into this directory")
    ap.add_argument("--device", default=None,
                    help="torch device of the steps (default: the CUDA "
                         "card; 'cpu' to run without one)")
    args = ap.parse_args(argv)

    cfg = SystemConfig(num_objects=args.vehicles,
                       detect=DetectionConfig(mode=args.mode))
    tester = PerformanceTester(cfg, output_dir=args.output_dir,
                               backend=args.backend,
                               distribution=args.distribution,
                               device=args.device)
    m = tester.run_test(args.tps, args.duration,
                        profile_dir=args.profile_dir)
    print(f"throughput={m.throughput:.2f} req/s avg={m.avg_latency:.2f} ms "
          f"p95={m.p95_latency:.2f} p99={m.p99_latency:.2f} "
          f"max={m.max_latency:.2f} err={m.error_rate:.2f}%")


if __name__ == "__main__":
    main()
