"""Where the port's tensors go when the caller names no device: the card."""
from __future__ import annotations

import torch


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


def check_on(state, dev: torch.device, what: str) -> None:
    """Raises unless the state's tensors lie on `dev`."""
    if state.device != dev:
        raise ValueError(f"state lies on {state.device}, {what} expects "
                         f"{dev}")
