"""System + service monitor (reference performance_monitor.py:86-883).

Samples host resources (psutil when present) and polls the service's
metrics endpoints — which this framework actually implements
(/api/collision/metrics, /stats), unlike the reference whose monitor polled
endpoints that never existed (SURVEY.md §4). Writes the same CSV shape on
stop.
"""
from __future__ import annotations

import json
import os
import threading
import time
import urllib.request
from datetime import datetime
from typing import Any, Dict, List, Optional

from tpu_collide_torch.core.utils import get_logger

logger = get_logger(__name__)


class PerformanceMonitor:
    def __init__(self, target: Optional[str] = "http://127.0.0.1:8000",
                 interval: float = 1.0, output_dir: str = "results"):
        self.target = target
        self.interval = interval
        self.output_dir = output_dir
        self.samples: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _host_sample(self) -> Dict[str, Any]:
        try:
            import psutil
            p = psutil.Process()
            return {
                "cpu_pct": psutil.cpu_percent(interval=None),
                "mem_pct": psutil.virtual_memory().percent,
                "proc_rss_mb": p.memory_info().rss / 1e6,
                "threads": p.num_threads(),
            }
        except ImportError:
            return {"cpu_pct": 0.0, "mem_pct": 0.0, "proc_rss_mb": 0.0,
                    "threads": 0}

    def _service_sample(self) -> Dict[str, Any]:
        if not self.target:
            return {}
        try:
            with urllib.request.urlopen(
                    self.target + "/api/collision/metrics", timeout=2) as r:
                data = json.loads(r.read()).get("data", {})
                return {f"svc_{k}": v for k, v in data.items()}
        except Exception:  # noqa: BLE001
            return {"svc_unreachable": 1}

    def sample_once(self) -> Dict[str, Any]:
        s = {"timestamp": time.time(), **self._host_sample(),
             **self._service_sample()}
        self.samples.append(s)
        return s

    def start(self) -> None:
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.sample_once()
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, save: bool = True) -> Optional[str]:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        return self.save() if save and self.samples else None

    def save(self) -> str:
        os.makedirs(self.output_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.output_dir, f"monitor_{stamp}.csv")
        keys: List[str] = []
        for s in self.samples:
            for k in s:
                if k not in keys:
                    keys.append(k)
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for s in self.samples:
                f.write(",".join(str(s.get(k, "")) for k in keys) + "\n")
        logger.info("monitor samples saved to %s", path)
        self.save_charts(path[:-4])
        return path

    def save_charts(self, base: str) -> List[str]:
        """PNG time-series charts of the sampled metrics (reference
        performance_monitor.py:591-844 chart output). Returns written
        paths; [] when matplotlib is unavailable or nothing numeric was
        sampled."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            logger.info("matplotlib unavailable; skipping monitor charts")
            return []
        if not self.samples:
            return []
        t0 = self.samples[0]["timestamp"]
        ts = [s["timestamp"] - t0 for s in self.samples]
        groups = {
            "host": ["cpu_pct", "mem_pct", "proc_rss_mb"],
            "service": ["svc_detection_count", "svc_avg_detection_time_ms",
                        "svc_active_alerts"],
        }
        out = []
        for gname, keys in groups.items():
            series = {k: [s.get(k) for s in self.samples] for k in keys
                      if any(isinstance(s.get(k), (int, float))
                             for s in self.samples)}
            if not series:
                continue
            fig, ax = plt.subplots(figsize=(8, 4.5))
            for k, vals in series.items():
                ax.plot(ts, [v if isinstance(v, (int, float)) else None
                             for v in vals], label=k, lw=1.2)
            ax.set_xlabel("time (s)")
            ax.set_title(f"{gname} metrics")
            ax.legend(fontsize=8)
            fig.tight_layout()
            p = f"{base}_{gname}.png"
            fig.savefig(p, dpi=110)
            plt.close(fig)
            out.append(p)
        return out
