"""Finds a cell's files by name, runs its driver, and assembles the result
line.

A cell `<config>.<mix>` of BENCHMARK.json resolves to
  configs/<config>.json    the SystemConfig as SystemConfig.from_json reads
                           it under "system", with its source, cuts and
                           guarantees
  traffic/<mix>.json       the driver's name and the mix's parameters
  drivers/<driver>.py      run(ctx) -> the run's readings
  limits/<cell>.json       the limit of every number compared
  metrics/<metric>.py      read(trace) -> the metric, or None
so that a cell, a mix or a metric is added as files and entries only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_collide")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names of metrics
    hold dots, so they are loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench._" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def for_cell(entries: list, cell: str, e2e_of_cell=None) -> list:
    """The metric entries a cell reports: those that list it, and those
    without a list (of an end-to-end metric the cell reports)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e_of_cell is None or m.get("moves") in e2e_of_cell:
            out.append(m)
    return out


def resolve(name: str, bench: dict, pkg: Path = PKG) -> Cell:
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    read = lambda *p: json.loads(pkg.joinpath(*p).read_text())
    e2e = for_cell(bench["end_to_end"], name)
    return Cell(name=name, chips=w["chips"],
                config=read("configs", w["config"] + ".json"),
                traffic=read("traffic", w["traffic"] + ".json"),
                limits=read("limits", name + ".json"),
                end_to_end=e2e,
                per_layer=for_cell(bench["per_layer"], name,
                                   {m["name"] for m in e2e}))


def verdict(checks: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number the limits file
    names was compared and lies within its limit."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = {"value": v if v is None or math.isfinite(v)
                       else str(v), "limit": limit}
    return ok, table


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    if device.type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, torch,
             device, t_start: float, pkg: Path = PKG) -> dict:
    """One run of a cell: the driver's readings turned into the result
    line (a dict; "checks" comes last)."""
    driver = load_module(pkg / "drivers" / (cell.traffic["driver"] + ".py"))
    r = driver.run(dict(cell=cell, seed=seed, seconds=seconds, trace=trace,
                        torch=torch, device=device, t_start=t_start))
    correct, checks = verdict(r["checks"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = load_module(pkg / "metrics" / (m["name"] + ".py")).read(
                r["trace"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            # `<base>.<regime>` reports the driver's <base> (a bound of
            # its own for the cells of one regime)
            metrics[m["name"]] = {"value": r["e2e"][m["name"].split(".")[0]],
                                  "unit": units[m["name"]]}
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=r["memory_peak_bytes"],
               card=card_line(device))
    line = dict(correct=correct, attempted=r["attempted"],
                failed=r["failed"], metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=r["trace"]["busy_s"],
                   window_s=r["trace"]["window_s"])
        line["breakdown"] = r["trace"]["breakdown"]
    line["info"] = r.get("info", {})
    line["checks"] = checks
    return line
