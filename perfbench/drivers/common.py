"""What the step and serve loops share: the configuration, the fleet, the
window's clock, the sample kept for the judge, and the device's peak."""
from __future__ import annotations

import gc
import json
import resource
import time

from perfbench.fleet import FIELDS, SAMPLE_STREAM, make_fleet
from perfbench.stats import Reservoir


def system_config(cell):
    """The program's SystemConfig of the cell's configuration file."""
    from tpu_collide_torch.core.config import SystemConfig
    return SystemConfig.from_json(json.dumps(cell.config["system"]))


def as_system(cfg) -> dict:
    """A SystemConfig as the plain dict the reference reads."""
    return json.loads(cfg.to_json())


def fleet_state(cell, seed: int, device):
    """The program's ObjectState of the run's fleet."""
    from tpu_collide_torch.core.state import ObjectState
    d = make_fleet(cell.config["system"], cell.config["vehicle_sizes"],
                   cell.traffic["fleet"], seed, device)
    return ObjectState(**d)


def as_dict(state) -> dict:
    """A program state as the reference's dict of tensors (the same
    tensors, read only)."""
    return {f: getattr(state, f) for f in FIELDS}


def produced(out) -> dict:
    """A StepOutput's counters and scene alert list as the judge reads
    them."""
    a = out.alerts
    return dict(num_risks=int(out.num_risks),
                alerts=dict(valid=a.valid, vehicle_oid=a.vehicle_oid,
                            other_oid=a.other_oid, risk=a.risk,
                            priority=a.priority))


def sampler(cell, seed: int) -> Reservoir:
    return Reservoir(cell.traffic["judged"], seed * 16 + SAMPLE_STREAM)


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(torch, device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


class Clock:
    """The measured window: it opens at start() and closes after the unit
    (step or tick) that is running when `seconds` have passed. Over the
    window it also keeps what the host did besides (`host`, reported under
    the result's info): the process's CPU seconds, the seconds and number
    of the interpreter's garbage collections and of its full ones, minor
    page faults and involuntary context switches."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.lat = []
        self.host = {}

    def start(self) -> float:
        self._gc = dict(gc_s=0.0, gc_runs=0, gc_full=0)
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self._cpu0 = time.process_time()
        self._ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        return self.t0

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self._gc["gc_s"] += time.perf_counter() - self._gc_t
            self._gc["gc_runs"] += 1
            self._gc["gc_full"] += info["generation"] == 2

    def open(self) -> bool:
        return time.perf_counter() < self.deadline

    def close(self) -> float:
        self.t1 = time.perf_counter()
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.host = dict(cpu_s=time.process_time() - self._cpu0,
                         minflt=ru.ru_minflt - self._ru0.ru_minflt,
                         nivcsw=ru.ru_nivcsw - self._ru0.ru_nivcsw,
                         **self._gc)
        return self.t1 - self.t0
