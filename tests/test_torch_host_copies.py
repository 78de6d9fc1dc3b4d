"""The port's copies of the JAX package's host-only modules stay copies:
core/types.py and core/utils.py equal their originals once the package
prefix is substituted (utils.py without enable_compile_cache, which
configures JAX, and without the port's spans, its own section at the end),
and so do the service's runtime, traffic simulator, stdlib
server and REST modules and the load harness's generator and monitor; the
route core and the alert manager differ from theirs only in the lines that
read device tensors and import the port's modules, and the orchestrated run
only in its --device."""
import difflib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# copied whole: the path under each package
SERVICE_COPIES = ("runtime/__init__.py", "runtime/messaging.py",
                  "runtime/storage.py", "runtime/scheduler.py",
                  "runtime/reliability.py", "runtime/bridge.py",
                  "sim/traffic.py", "api/stdlib_server.py",
                  "bench/load_generator.py", "bench/monitor.py")
# copied but for these lines of the JAX module (first, last; an insertion
# after line n lies in a range that starts at n + 1)
EDITED_COPIES = {
    # the import of core/device.to_host; POST /step's three counters in
    # one to_host copy instead of three np.asarray reads
    "api/routes.py": ((27, 29), (288, 294)),
    # the port's note in the docstring; the imports of torch, the port's
    # compute_priority and to_host; process_batch's one copy in place of
    # jax.device_get; compute_priority on torch scalars; the broker
    # egress's import, wrapped
    "alerts/manager.py": ((13, 13), (25, 28), (81, 88), (105, 109),
                          (232, 241)),
    # the port's note in the docstring and no postponed annotations (FastAPI
    # reads the handlers' request models from them); POST /step's model
    # with the route core's pipelined and burst
    "api/rest.py": ((28, 30), (93, 93)),
    # the usage line and the port's note in the docstring; --device; the
    # import of the port's package; CollisionSystem on --device
    "bench/run_benchmark.py": ((14, 14), (44, 44), (47, 47), (67, 67)),
}


def _read(pkg: str, rel: str) -> str:
    text = (ROOT / pkg / rel).read_text()
    return text.replace("tpu_collide_torch.", "tpu_collide.")


def _source(pkg: str, name: str) -> str:
    return _read(pkg, "core/" + name)


def _without_compile_cache(text: str) -> str:
    """The module without `enable_compile_cache` (it runs to the end of the
    file) and without trailing blank lines."""
    cut = text.find("\ndef enable_compile_cache")
    return (text if cut < 0 else text[:cut]).rstrip() + "\n"


# the port's utils.py ends in a section of its own (the spans), after the
# copy
PORT_SECTION = "\n# ---- spans on the profiler's clock"


def _without_port_section(text: str) -> str:
    cut = text.find(PORT_SECTION)
    return (text if cut < 0 else text[:cut]).rstrip() + "\n"


@pytest.mark.parametrize("name", ["types.py", "utils.py"])
def test_host_module_is_a_copy(name):
    want = _without_compile_cache(_source("tpu_collide", name))
    got = _without_port_section(_source("tpu_collide_torch", name))
    assert got == want


def test_utils_port_section_defines_only_the_spans():
    port = (ROOT / "tpu_collide_torch" / "core" / "utils.py").read_text()
    section = port[port.index(PORT_SECTION):]
    defined = sorted(line.split()[1].split("(")[0].rstrip(":")
                     for line in section.splitlines()
                     if line.startswith(("def ", "class ")))
    assert defined == ["_NoSpan", "span", "traced"]


def test_utils_copy_leaves_out_only_the_compile_cache():
    port = (ROOT / "tpu_collide_torch" / "core" / "utils.py").read_text()
    assert "enable_compile_cache" not in port and "jax" not in port
    assert "def enable_compile_cache" in _source("tpu_collide", "utils.py")


@pytest.mark.parametrize("rel", SERVICE_COPIES)
def test_service_module_is_a_copy(rel):
    assert _read("tpu_collide_torch", rel) == _read("tpu_collide", rel)


def _changed_ranges(want: str, got: str) -> list:
    """(first, last) lines of `want` that `got` replaces or deletes, and
    (n + 1, n) for an insertion after line n."""
    a, b = want.splitlines(), got.splitlines()
    ops = difflib.SequenceMatcher(None, a, b, autojunk=False).get_opcodes()
    return [(i1 + 1, i2) for tag, i1, i2, _, _ in ops if tag != "equal"]


@pytest.mark.parametrize("rel", sorted(EDITED_COPIES))
def test_edited_copy_differs_only_in_the_named_lines(rel):
    changed = _changed_ranges(_read("tpu_collide", rel),
                              _read("tpu_collide_torch", rel))
    allowed = EDITED_COPIES[rel]
    stray = [(lo, hi) for lo, hi in changed
             if not any(a - 1 <= lo and hi <= b for a, b in allowed)]
    assert not stray, f"{rel}: lines {stray} of the JAX module differ"
    # every named range still holds a difference
    assert all(any(a - 1 <= lo and hi <= b for lo, hi in changed)
               for a, b in allowed)


def test_rest_app_evaluates_its_annotations():
    port = (ROOT / "tpu_collide_torch" / "api" / "rest.py").read_text()
    assert "from __future__ import annotations" not in port
    assert "pipelined: bool = False" in port and "burst: bool = False" in port


def test_routes_read_no_tensor_through_numpy():
    port = (ROOT / "tpu_collide_torch" / "api" / "routes.py").read_text()
    assert "np.asarray(out." not in port and "to_host(" in port


def test_serving_modules_import_neither_jax_nor_the_jax_package():
    """The Scene and what it imports, and chip_smoke.py, load without JAX
    and without tpu_collide (whose __init__ imports JAX)."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json, sys; import tpu_collide_torch.api, "
            "tpu_collide_torch.api.scene, tpu_collide_torch.ckpt, "
            "tpu_collide_torch.alerts.manager, tpu_collide_torch.core.types, "
            "tpu_collide_torch.core.utils, tpu_collide_torch.system, "
            "tpu_collide_torch.runtime, tpu_collide_torch.runtime.bridge, "
            "tpu_collide_torch.api.routes, "
            "tpu_collide_torch.api.stdlib_server, "
            "tpu_collide_torch.api.rest, tpu_collide_torch.sim.traffic, "
            "chip_smoke; "
            "print(json.dumps([m for m in ('jax', 'tpu_collide') "
            "if m in sys.modules]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
