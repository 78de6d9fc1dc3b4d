"""Small tensor helpers shared by the port's modules."""
from __future__ import annotations

import torch


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest entries along `dim`, ties broken
    by the lower index, as jax.lax.top_k breaks them (torch.topk promises
    no order among ties)."""
    values, indices = torch.sort(x, dim=dim, descending=True, stable=True)
    return values.narrow(dim, 0, k), indices.narrow(dim, 0, k)
