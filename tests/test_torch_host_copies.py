"""The port's copies of the JAX package's host-only modules stay copies:
core/types.py and core/utils.py equal their originals once the package
prefix is substituted (utils.py without enable_compile_cache, which
configures JAX)."""
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _source(pkg: str, name: str) -> str:
    text = (ROOT / pkg / "core" / name).read_text()
    return text.replace("tpu_collide_torch.", "tpu_collide.")


def _without_compile_cache(text: str) -> str:
    """The module without `enable_compile_cache` (it runs to the end of the
    file) and without trailing blank lines."""
    cut = text.find("\ndef enable_compile_cache")
    return (text if cut < 0 else text[:cut]).rstrip() + "\n"


@pytest.mark.parametrize("name", ["types.py", "utils.py"])
def test_host_module_is_a_copy(name):
    want = _without_compile_cache(_source("tpu_collide", name))
    got = _without_compile_cache(_source("tpu_collide_torch", name))
    assert got == want


def test_utils_copy_leaves_out_only_the_compile_cache():
    port = (ROOT / "tpu_collide_torch" / "core" / "utils.py").read_text()
    assert "enable_compile_cache" not in port and "jax" not in port
    assert "def enable_compile_cache" in _source("tpu_collide", "utils.py")


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
            "tpu_collide_torch.core.utils, chip_smoke; "
            "print(json.dumps([m for m in ('jax', 'tpu_collide') "
            "if m in sys.modules]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
