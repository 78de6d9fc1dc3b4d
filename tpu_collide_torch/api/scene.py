"""The device half of Scene.predict (the port of tpu_collide/api/scene.py's
_predict_device_fused and _predict_device; the Scene class itself is not
ported yet).

Both run a prediction and compact the [N, merge_k] merged risks to the
r_cap highest qualifying entries on the device, so that nothing bigger than
r_cap crosses to the host. They return

    (risk [r], vehicle oid [r], other oid [r], ttc [r], dist [r],
     qualifying count [], overflow [], slot_oflow [], slot_trunc [])

with r = min(r_cap, N * merge_k); entries past the qualifying count carry
risk -1.
"""
from __future__ import annotations

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.ops import stable_topk
from tpu_collide_torch.detect.predict import predict_collisions
from tpu_collide_torch.engine import grid_overflow
from tpu_collide_torch.index.grid import build_grid
from tpu_collide_torch.kernels.refine import fused_predict


def _compact(state, other, valid, risk, ttc, dist, cfg: SystemConfig,
             r_cap: int):
    """The r_cap highest qualifying (risk >= risk_low) merged entries, ties
    by the lower flat index as the JAX package's top_k breaks them."""
    kk = risk.shape[1]
    keep = valid & (risk >= cfg.alerts.risk_low)
    keyv = torch.where(keep, risk, torch.full_like(risk, -1.0)).reshape(-1)
    top_r, top_i = stable_topk(keyv, min(r_cap, keyv.numel()))
    sel = lambda x: x.reshape(-1)[top_i]
    return (top_r, state.oid[top_i // kk], sel(other), sel(ttc), sel(dist),
            keep.sum(dtype=torch.int32))


def _predict_device_fused(state, traj, cfg: SystemConfig, horizon: float,
                          step: float, r_cap: int, window_rows=None,
                          k_slots: int = 8):
    """Prediction through the predict kernel (kernels/refine.fused_predict),
    compacted to r_cap. `other` entries are already oids."""
    (other, valid, risk, ttc, dist, overflow, slot_oflow,
     slot_trunc) = fused_predict(state, traj, cfg, horizon=horizon,
                                 step=step, window_rows=window_rows,
                                 k_slots=k_slots)
    return _compact(state, other, valid, risk, ttc, dist, cfg, r_cap) + (
        overflow.to(torch.int32), slot_oflow, slot_trunc)


def _predict_device(state, traj, cfg: SystemConfig, horizon: float,
                    step: float, r_cap: int):
    """Prediction over the grid (detect/predict.predict_collisions),
    compacted to r_cap. The overflow slot carries the grid's bucket
    truncation (engine.grid_overflow): candidates beyond cell_capacity are
    dropped from their bucket's gather, so a non-zero count means the
    list may be missing pairs."""
    index = build_grid(state.pos, state.alive, cfg)
    other, valid, risk, ttc, dist = predict_collisions(
        state, traj, index, cfg, horizon=horizon, step=step)
    other = state.oid[other.to(torch.int64)]
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return _compact(state, other, valid, risk, ttc, dist, cfg, r_cap) + (
        grid_overflow(index, cfg).to(torch.int32), zero, zero)
