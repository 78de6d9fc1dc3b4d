"""Builds the package's CUDA kernels with nvcc at first use and loads them
with ctypes.

The sources under tpu_collide_torch/csrc/ compile into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):
one nvcc per .cu file, all started together, then one link.
The library lands in tpu_collide_torch/_build/, named by a hash of the
sources and flags, so a process builds it at most once and a changed source
never loads a stale library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -fmad=false and no fast math: the kernels then round every operation the
# way their plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((cuda_home and os.path.join(cuda_home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_collide_torch_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) of the current
    library, or '' before it is built."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _run(procs) -> str:
    """Waits for every (cmd, Popen) and returns their output; raises with
    the output of the first that failed."""
    outs = [(cmd, *pr.communicate()) + (pr.returncode,) for cmd, pr in procs]
    for cmd, out, err, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}{err}")
    return "".join(out + err for _, out, err, _ in outs)


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        log = _run(procs)
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        log += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, with argtypes declared (every pointer and
    the stream as c_void_p)."""
    so = library_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tc_fused_topk.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                  ci, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.tc_fused_topk.restype = ci
    lib.tc_fused_predict.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                     ci, ci, vp, vp, vp, vp, vp, vp]
    lib.tc_fused_predict.restype = ci
    lib.tc_pred_param_count.argtypes = []
    lib.tc_pred_param_count.restype = ci
    lib.tc_param_count.argtypes = []
    lib.tc_param_count.restype = ci
    ptrs = ctypes.POINTER(vp)
    lib.tc_co_sort.argtypes = [vp, ci, ci, ci, ptrs, ptrs, vp, vp, vp, vp]
    lib.tc_co_sort.restype = ci
    lib.tc_error_string.argtypes = [ci]
    lib.tc_error_string.restype = ctypes.c_char_p
    return lib
