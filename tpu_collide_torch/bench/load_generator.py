"""End-to-end load generator + failure injector + performance analyzer.

The reference's load-testing toolkit (load_generator.py:39-865, SURVEY.md
§2.12): open-loop request generation against the REST surface with ramp-up,
latency/throughput/error capture and CSV artifacts, cross-run comparison,
and a FailureInjector client for the fault-injection endpoint (which the
reference never implemented server-side; ours exists —
api/stdlib_server.py /api/admin/inject-failure).

Targets: 'http' (any tpu-collide REST server), 'scene' (in-process Scene,
no network), plus 'kafka' and 'redis' to match the reference's full target
list (load_generator.py:92-99, 252-257) — the latter two reuse the gated
sinks from sim/traffic.py and raise with guidance when the client library
or service is absent (neither is provisioned in this environment, exactly
as in the reference repo).

Artifacts: latencies CSV + summary JSON + PNG charts (latency histogram /
timeline, cross-run comparison bars) when matplotlib is available —
matching the reference's chart output (load_generator.py:412-471).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import statistics
import time
import urllib.request
import urllib.error
from datetime import datetime
from typing import Any, Dict, List, Optional

from tpu_collide_torch.core.utils import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class LoadTestResult:
    target_tps: float
    duration_s: float
    requests: int
    errors: int
    latencies_ms: List[float]

    @property
    def throughput(self) -> float:
        return self.requests / max(self.duration_s, 1e-9)

    @property
    def error_rate(self) -> float:
        return self.errors / self.requests * 100 if self.requests else 0.0

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        s = sorted(self.latencies_ms)
        return s[min(len(s) - 1, int(p * len(s)))]

    def summary(self) -> Dict[str, Any]:
        lat = self.latencies_ms
        return {
            "target_tps": self.target_tps,
            "duration_s": round(self.duration_s, 2),
            "requests": self.requests,
            "errors": self.errors,
            "error_rate_pct": round(self.error_rate, 2),
            "throughput_rps": round(self.throughput, 2),
            "avg_ms": round(statistics.fmean(lat), 2) if lat else 0.0,
            "p95_ms": round(self.percentile(0.95), 2),
            "p99_ms": round(self.percentile(0.99), 2),
            "max_ms": round(max(lat), 2) if lat else 0.0,
        }


class LoadGenerator:
    """Open-loop location-update load with linear ramp-up (reference
    load_generator.py:119-344)."""

    def __init__(self, target: str = "http://127.0.0.1:8000",
                 scene=None, seed: int = 0,
                 map_size=(10_000.0, 10_000.0),
                 target_type: str = "http", **sink_kw):
        """target_type: 'http' | 'scene' | 'kafka' | 'redis' (the
        reference's full list). kafka/redis build a gated sink from
        sim/traffic.py; sink_kw passes bootstrap_servers/url/topic/channel
        through."""
        assert target_type in ("http", "scene", "kafka", "redis")
        self.target = target
        self.scene = scene                 # in-process mode when set
        self.target_type = "scene" if scene is not None else target_type
        self.rng = random.Random(seed)
        self.map_size = map_size
        self._sink = None
        if self.target_type == "kafka":
            from tpu_collide_torch.sim.traffic import kafka_sink
            self._sink = kafka_sink(**sink_kw)
        elif self.target_type == "redis":
            from tpu_collide_torch.sim.traffic import redis_sink
            self._sink = redis_sink(**sink_kw)

    def _payload(self, i: int) -> Dict[str, Any]:
        speed = self.rng.uniform(5, 20)
        heading = self.rng.uniform(0, 2 * math.pi)
        return {
            "vehicle_id": f"load-veh-{i}",
            "position": {"x": self.rng.uniform(0, self.map_size[0]),
                         "y": self.rng.uniform(0, self.map_size[1]), "z": 0},
            "velocity": {"x": speed * math.cos(heading),
                         "y": speed * math.sin(heading), "z": 0},
            "heading": heading,
        }

    def _send(self, payload: Dict[str, Any]) -> bool:
        if self.scene is not None or self._sink is not None:
            from tpu_collide_torch.core.types import LocationData, Position, Vector
            loc = LocationData(
                vehicle_id=payload["vehicle_id"],
                position=Position(**payload["position"]),
                velocity=Vector(**payload["velocity"]),
                heading=payload["heading"])
            if self.scene is not None:
                self.scene.ingest(loc)
                return True
            try:
                self._sink([loc])
                return True
            except Exception:  # noqa: BLE001 — broker down counts as error
                return False
        req = urllib.request.Request(
            self.target + "/vehicles/location",
            data=json.dumps(payload).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status == 200
        except (urllib.error.URLError, OSError):
            return False

    def run_load_test(self, target_tps: float, duration: float,
                      ramp_up: float = 0.0,
                      num_vehicles: int = 1000) -> LoadTestResult:
        """reference load_generator.py:119-233: linear ramp to target_tps."""
        res = LoadTestResult(target_tps, 0.0, 0, 0, [])
        start = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter() - start
            if now >= duration:
                break
            # floor the ramped rate at 1 rps — near t=0 the ramp would give
            # tps ~ 0 and 1/tps a multi-hour sleep
            tps = (max(1.0, target_tps * min(1.0, now / ramp_up))
                   if ramp_up > 0 else target_tps)
            t0 = time.perf_counter()
            ok = self._send(self._payload(i % num_vehicles))
            res.latencies_ms.append((time.perf_counter() - t0) * 1e3)
            res.requests += 1
            res.errors += 0 if ok else 1
            i += 1
            if tps > 0:
                sleep = (1.0 / tps) - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(min(sleep, 1.0))
        res.duration_s = time.perf_counter() - start
        return res

    def save_results(self, result: LoadTestResult,
                     output_dir: str = "results") -> str:
        """CSV artifacts (reference :346-410)."""
        os.makedirs(output_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        base = os.path.join(output_dir, f"load_test_{stamp}")
        with open(base + "_latencies.csv", "w") as f:
            f.write("latency_ms\n")
            for v in result.latencies_ms:
                f.write(f"{v}\n")
        with open(base + "_summary.json", "w") as f:
            json.dump(result.summary(), f, indent=2)
        save_latency_charts(result.latencies_ms, base)
        return base


def save_latency_charts(latencies_ms: List[float], base: str) -> List[str]:
    """PNG latency histogram + timeline (reference load_generator.py:
    412-471). No-op (returns []) when matplotlib is unavailable."""
    if not latencies_ms:
        return []
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.info("matplotlib unavailable; skipping latency charts")
        return []
    out = []
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.hist(latencies_ms, bins=min(60, max(10, len(latencies_ms) // 20)),
            color="#3b7dd8", edgecolor="white")
    ax.set_xlabel("latency (ms)")
    ax.set_ylabel("requests")
    ax.set_title("Request latency distribution")
    fig.tight_layout()
    fig.savefig(base + "_latency_hist.png", dpi=110)
    plt.close(fig)
    out.append(base + "_latency_hist.png")

    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.plot(latencies_ms, lw=0.7, color="#3b7dd8")
    ax.set_xlabel("request #")
    ax.set_ylabel("latency (ms)")
    ax.set_title("Latency over the run")
    fig.tight_layout()
    fig.savefig(base + "_latency_timeline.png", dpi=110)
    plt.close(fig)
    out.append(base + "_latency_timeline.png")
    return out


class FailureInjector:
    """Fault-injection client — the reference's FULL surface
    (load_generator.py:748-865: node_failure, network_partition, high_load,
    slow_response, reset-failures) plus our drop_objects. The reference
    POSTed to /api/admin/inject-failure which its server never implemented;
    ours does (api/routes.py)."""

    def __init__(self, target: str = "http://127.0.0.1:8000"):
        self.target = target

    def _post(self, path: str, body: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.target + path,
            data=json.dumps(body or {}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as r:
            return json.loads(r.read())

    def _inject(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return self._post("/api/admin/inject-failure", body)

    def inject_node_failure(self, node_id: str) -> Dict[str, Any]:
        return self._inject({"type": "node_failure", "node_id": node_id})

    def inject_network_partition(self, node_ids: List[str]) -> Dict[str, Any]:
        return self._inject({"type": "network_partition",
                             "node_ids": node_ids})

    def inject_high_load(self, duration: float = 60) -> Dict[str, Any]:
        return self._inject({"type": "high_load", "duration": duration})

    def inject_slow_response(self, latency: float = 500,
                             duration: float = 60) -> Dict[str, Any]:
        return self._inject({"type": "slow_response", "latency": latency,
                             "duration": duration})

    def inject_object_loss(self, fraction: float = 0.1) -> Dict[str, Any]:
        return self._inject({"type": "drop_objects", "fraction": fraction})

    def reset_failures(self) -> Dict[str, Any]:
        return self._post("/api/admin/reset-failures")

    # round-1 name, kept for compatibility
    def reset(self) -> Dict[str, Any]:
        return self._inject({"type": "reset"})


class PerformanceAnalyzer:
    """Cross-run comparison report (reference load_generator.py:506-745)."""

    @staticmethod
    def load_latencies(path: str) -> List[float]:
        with open(path) as f:
            next(f)                       # header
            return [float(line) for line in f if line.strip()]

    @staticmethod
    def compare(runs: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, lat in runs.items():
            s = sorted(lat)
            out[name] = {
                "count": len(s),
                "avg_ms": round(statistics.fmean(s), 3) if s else 0.0,
                "p50_ms": round(s[len(s) // 2], 3) if s else 0.0,
                "p95_ms": round(s[min(len(s) - 1, int(0.95 * len(s)))], 3)
                if s else 0.0,
                "p99_ms": round(s[min(len(s) - 1, int(0.99 * len(s)))], 3)
                if s else 0.0,
                "max_ms": round(s[-1], 3) if s else 0.0,
            }
        return out

    @staticmethod
    def report(runs: Dict[str, List[float]], path: Optional[str] = None) -> str:
        cmp_ = PerformanceAnalyzer.compare(runs)
        lines = ["run,count,avg_ms,p50_ms,p95_ms,p99_ms,max_ms"]
        for name, m in cmp_.items():
            lines.append(f"{name},{m['count']},{m['avg_ms']},{m['p50_ms']},"
                         f"{m['p95_ms']},{m['p99_ms']},{m['max_ms']}")
        text = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    @staticmethod
    def comparison_chart(runs: Dict[str, List[float]],
                         path: str) -> Optional[str]:
        """Grouped-bar PNG of avg/p95/p99 per run (reference
        load_generator.py:412-471 comparison charts). None when matplotlib
        is unavailable."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            logger.info("matplotlib unavailable; skipping comparison chart")
            return None
        cmp_ = PerformanceAnalyzer.compare(runs)
        names = list(cmp_)
        metrics = ("avg_ms", "p95_ms", "p99_ms")
        x = range(len(names))
        width = 0.27
        fig, ax = plt.subplots(figsize=(max(6, 2 * len(names)), 4.5))
        for j, m in enumerate(metrics):
            ax.bar([i + (j - 1) * width for i in x],
                   [cmp_[n][m] for n in names], width, label=m)
        ax.set_xticks(list(x))
        ax.set_xticklabels(names, rotation=15, ha="right")
        ax.set_ylabel("latency (ms)")
        ax.set_title("Run comparison")
        ax.legend()
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path
