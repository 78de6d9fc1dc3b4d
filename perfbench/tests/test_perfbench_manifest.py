"""BENCHMARK.json against the contract's limits on names, units and shape,
and every cell against its files; the import rules of the benchmark."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_collide"}


def one_line(s, most=200):
    return isinstance(s, str) and 1 <= len(s) <= most and "\n" not in s \
        and "\t" not in s


def test_top_level_shape():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert all(one_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["source"])
    assert one_line(entry["why"]) and len(entry["reduced"]) <= 16
    assert all(NAME.match(k) for k in entry["reduced"])
    assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["name"] == f"{entry['config']}.{entry['traffic']}"
    assert NAME.match(entry["traffic"]) and one_line(entry["why"])
    assert entry["chips"] in (1, 4)
    cell = harness.resolve(entry["name"], BENCH)
    assert (harness.PKG / "drivers"
            / (cell.traffic["driver"] + ".py")).is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and cell.limits


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry(entry):
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert set(entry.get("workloads", [])) <= cells
    if entry["name"] in e2e:
        assert set(entry) <= {"name", "unit", "better", "bound", "source",
                              "workloads"}
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert set(entry) <= {"name", "unit", "better", "source", "layer",
                              "moves", "workloads"}
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert one_line(entry["layer"]) and entry["moves"] in e2e
        assert (harness.PKG / "metrics" / (entry["name"] + ".py")).is_file()


def imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(harness.PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_imports(path):
    got = imports(path)
    assert not got & FORBIDDEN, got & FORBIDDEN
    if "reference" in path.parts:
        assert "tpu_collide_torch" not in got
    if path.name.startswith("test_perfbench"):
        return
    for text in literals(path):
        for name in ("bench.py", "BENCH_", "results", "MULTICHIP_"):
            assert name not in text, (name, text)


def literals(path: Path) -> list:
    """The string constants of a module that are not docstrings (where a
    file name the benchmark must not read would appear)."""
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_card_no_result(tmp_path):
    """Without a card, and in a directory holding only BENCHMARK.json and
    perfbench/, the command exits non-zero and prints nothing."""
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            subprocess.run(["cp", "-r", str(harness.PKG), str(tmp_path)],
                           check=True)
            (tmp_path / "BENCHMARK.json").write_text(
                (ROOT / "BENCHMARK.json").read_text())
        cell = BENCH["workloads"][0]["name"]
        r = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", cell,
             "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
            cwd=where, capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0 and r.stdout == ""
