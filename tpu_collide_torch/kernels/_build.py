"""Builds the package's CUDA kernels with nvcc at first use, loads them
with ctypes and launches them.

The sources under tpu_collide_torch/csrc/ compile into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):
one nvcc per .cu file, all started together, then one link.
The library lands in tpu_collide_torch/_build/, named by a hash of the
sources and flags, so a process builds it at most once and a changed source
never loads a stale library. Nothing here runs at import time, and nothing
of the package is imported here.

Every kernel wrapper checks its tensors with `_check_inputs` and calls its
C entry point through `launch`, which looks `load_library` up at each call:
a tool that swaps `load_library` for another build of the sources reaches
every launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# -fmad=false and no fast math: the kernels then round every operation the
# way their plain PyTorch versions do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources(csrc: Path) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((cuda_home and os.path.join(cuda_home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(csrc: Path = CSRC_DIR) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_collide_torch_{h.hexdigest()[:16]}.so"


def build_log(csrc: Path = CSRC_DIR) -> str:
    """nvcc's output (ptxas register and spill report) of the current
    library, or '' before it is built."""
    log = library_path(csrc).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _run(procs) -> str:
    """Waits for every (cmd, Popen) and returns their output; raises with
    the output of the first that failed."""
    outs = [(cmd, *pr.communicate()) + (pr.returncode,) for cmd, pr in procs]
    for cmd, out, err, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}{err}")
    return "".join(out + err for _, out, err, _ in outs)


def _build(so: Path, csrc: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in _sources(csrc):
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


def load_library() -> ctypes.CDLL:
    """The package's kernel library (see open_library)."""
    return open_library(CSRC_DIR)


@functools.cache
def open_library(csrc: Path) -> ctypes.CDLL:
    """The kernel library built from the sources in `csrc` (the package's
    own, or another copy of them to compare with), with argtypes declared
    (every pointer and the stream as c_void_p)."""
    so = library_path(csrc)
    if not so.exists():
        _build(so, csrc)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tc_fused_topk.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                  ci, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.tc_fused_topk.restype = ci
    if hasattr(lib, "tc_fused_topk_plan"):    # not in older copies of csrc
        lib.tc_fused_topk_plan.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.tc_fused_topk_plan.restype = None
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
    if hasattr(lib, "tc_co_sort_launches"):   # not in older copies of csrc
        lib.tc_co_sort_launches.argtypes = [ci]
        lib.tc_co_sort_launches.restype = ci
    if hasattr(lib, "tc_scene_cut"):          # not in older copies of csrc
        ll = ctypes.c_longlong
        lib.tc_scene_cut.argtypes = [vp, vp, vp, ci, ci, vp, ci, ci, vp, ll,
                                     vp, vp, vp, vp, vp]
        lib.tc_scene_cut.restype = ci
        lib.tc_scene_cut_plan.argtypes = [ci, ci, ci, ci, ctypes.POINTER(ll)]
        lib.tc_scene_cut_plan.restype = None
    if hasattr(lib, "tc_precise_sweep"):      # not in older copies of csrc
        lib.tc_precise_sweep.argtypes = [vp, vp, vp, vp, ctypes.c_longlong,
                                         ci, ci, ctypes.c_float, vp, vp, vp,
                                         vp]
        lib.tc_precise_sweep.restype = ci
    if hasattr(lib, "tc_cell_records"):       # not in older copies of csrc
        lib.tc_cell_records.argtypes = [vp] * 11 + [ctypes.c_longlong, vp,
                                                    vp, vp, vp]
        lib.tc_cell_records.restype = ci
    if hasattr(lib, "tc_predict_merge"):      # not in older copies of csrc
        lib.tc_predict_merge.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 8
        lib.tc_predict_merge.restype = ci
    lib.tc_error_string.argtypes = [ci]
    lib.tc_error_string.restype = ctypes.c_char_p
    return lib


def _on_device(dev):
    """A context in which `dev` is the current CUDA device; nothing to
    switch where it already is."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _check_inputs(who: str, dev, tensors) -> None:
    """Raises ValueError unless each (name, tensor, dtype, shape) of
    `tensors` is a contiguous tensor of that dtype and shape on `dev`."""
    for name, t, dtype, shape in tensors:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{who}: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def launch(who: str, entry: str, dev, *args) -> None:
    """Calls the library's C entry point `entry` with `args` and the
    current stream of CUDA device `dev`, on that device; raises
    RuntimeError, naming `who`, when it returns a CUDA error."""
    lib = load_library()
    with _on_device(dev):
        rc = getattr(lib, entry)(*args,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{who} kernel launch failed: CUDA error {rc} "
            f"({lib.tc_error_string(rc).decode()})")
