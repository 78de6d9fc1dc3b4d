"""Small tensor helpers shared by the port's modules."""
from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along `dim`, ties broken
    by the lower index, as jax.lax.top_k breaks them (torch.topk promises
    no order among ties)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)


def topk_low_index(x: torch.Tensor, k: int):
    """stable_topk along the last dimension of a float32 tensor (fewer than
    2^31 entries there) without a full sort: one torch.topk over an int64
    key that holds the order-preserving bits of the value in its high half
    and 2^31 - 1 - index in its low half. No two keys are equal, so the
    chosen entries and their order do not depend on torch.topk's rule for
    ties. -0.0 ranks as +0.0; a NaN ranks above +inf (below -inf with the
    sign bit set)."""
    if x.dtype != torch.float32:
        raise ValueError(f"topk_low_index takes float32, got {x.dtype}")
    n = x.shape[-1]
    bits = (x + 0.0).view(torch.int32)          # -0.0 becomes +0.0
    # flip the magnitude bits of negative values: signed integer order is
    # then the order of the floats
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    key = (ordered.to(torch.int64) << 32) | rev
    indices = (n - 1) - (torch.topk(key, k, dim=-1).values & 0xFFFFFFFF)
    return torch.gather(x, -1, indices), indices
