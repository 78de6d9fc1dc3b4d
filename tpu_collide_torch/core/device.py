"""Where the port's tensors go when the caller names no device (the card),
and how the host reads them back: `to_host` lands a list of tensors in one
device-to-host copy, `to_host_async` starts that copy and `HostCopy.wait`
ends it. `host_tensor` is torch.tensor on a device, named as the host wait
it is on a card."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from tpu_collide_torch.core.utils import span

_CARRIED = (torch.float32, torch.int32, torch.bool)


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA card (with
    its index, so that it compares equal to a tensor's device). Without a
    card, None raises: the port runs on the CPU only when asked to."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", torch.cuda.current_device())


def card(dev: torch.device) -> str | None:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, None
    when `dev` is no CUDA device."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def host_tensor(data, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """torch.tensor(data, dtype=dtype, device=device). On a CUDA device the
    copy leaves pageable host memory, and PyTorch synchronises the stream
    after it: the host waits for all the work queued before. There the copy
    runs inside a tc.host_wait span (core/utils.span)."""
    if device.type != "cuda":
        return torch.tensor(data, dtype=dtype, device=device)
    with span("tc.host_wait"):
        return torch.tensor(data, dtype=dtype, device=device)


def check_on(state, dev: torch.device, what: str) -> None:
    """Raises unless the state's tensors lie on `dev`."""
    if state.device != dev:
        raise ValueError(f"state lies on {state.device}, {what} expects "
                         f"{dev}")


def _pack(tensors) -> tuple[torch.Tensor, list]:
    """The tensors as one flat int32 tensor (f32 by its bits), and each
    one's (dtype, shape)."""
    parts, specs = [], []
    for t in tensors:
        if t.dtype not in _CARRIED:
            raise TypeError(f"to_host carries {_CARRIED}, not {t.dtype}")
        flat = t.reshape(-1)
        parts.append(flat.view(torch.int32) if t.dtype == torch.float32
                     else flat.to(torch.int32))
        specs.append((t.dtype, tuple(t.shape)))
    return torch.cat(parts), specs


def _unpack(flat: np.ndarray, specs: list) -> list:
    out, at = [], 0
    for dtype, shape in specs:
        n = int(np.prod(shape, dtype=np.int64))
        part = flat[at:at + n]
        at += n
        if dtype == torch.float32:
            part = part.view(np.float32)
        elif dtype == torch.bool:
            part = part.astype(bool)
        out.append(part.reshape(shape))
    return out


class HostCopy:
    """A device-to-host copy under way; `wait` returns the numpy arrays."""

    def __init__(self, host: torch.Tensor, done, specs: list):
        self._host, self._done, self._specs = host, done, specs

    def wait(self) -> list:
        if self._done is not None:
            self._done.synchronize()
        return _unpack(self._host.numpy(), self._specs)


def to_host_async(tensors) -> HostCopy:
    """Starts the copy of `tensors` (f32, int32 or bool, all on one device)
    to the host: one non-blocking copy into pinned memory behind the
    work already queued on the current stream, marked by a CUDA event. CPU
    tensors are copied at once."""
    flat, specs = _pack(tensors)
    if not flat.is_cuda:
        return HostCopy(flat, None, specs)
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    with torch.cuda.device(flat.device):
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return HostCopy(host, done, specs)


def to_host(tensors) -> list:
    """`tensors` as numpy arrays of their dtypes and shapes, fetched in one
    device-to-host copy (a single wait for the device)."""
    flat, specs = _pack(tensors)
    return _unpack(flat.cpu().numpy(), specs)
