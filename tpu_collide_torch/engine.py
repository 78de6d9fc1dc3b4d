"""The fused step (the port of tpu_collide/engine.py's fused backend):

    integrate -> cell list (one sort by cell) -> fused kernel slots
              -> refine tail (scene top-A, recomputed alert payloads)

State stays on its device between steps; the step allocates its outputs and
does not change the input state in place.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.alerts.extract import AlertBatch
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tpu_collide_torch.kernels.refine import (fused_scene_fast,
                                              fused_scene_precise)
from tpu_collide_torch.sim.integrator import integrate


@dataclasses.dataclass(frozen=True)
class StepOutput:
    alerts: AlertBatch
    num_pairs_checked: torch.Tensor  # [] int64 candidate pairs that passed
                                     # stage 1 (alive, not self, within the
                                     # search radius); -1 when not counted
    num_risks: torch.Tensor          # [] int32 stage-4 risks produced
    max_risk: torch.Tensor           # [] f32
    num_alive: torch.Tensor          # [] int32
    overflow: torch.Tensor           # [] int32 broad-phase candidates beyond
                                     # capacity: 0 by construction here
    alert_overflow: torch.Tensor     # [] int32 alert-path capacity overflow;
                                     # 0 means the alert list is complete


def detect_and_alerts_fused(state: ObjectState, cfg: SystemConfig,
                            topk=fused_topk) -> StepOutput:
    """Detection and alerts of one state, without physics. `topk` is the
    slot function (see kernels/refine.fused_scene_fast)."""
    cl = build_cell_list(state, cfg)
    scene_fn = (fused_scene_fast if cfg.detect.mode == "fast"
                else fused_scene_precise)
    res = scene_fn(cl, cfg, topk=topk)
    return StepOutput(
        alerts=res.alerts,
        num_pairs_checked=res.num_checked,
        num_risks=res.num_risks,
        max_risk=res.max_risk,
        num_alive=state.alive.sum(dtype=torch.int32),
        overflow=cl.overflow,
        alert_overflow=res.alert_overflow,
    )


def grid_overflow(index, cfg: SystemConfig) -> torch.Tensor:
    """[] int64 objects beyond cell_capacity in their bucket (dropped from
    that cell's candidate lists by index/grid.gather_candidates): the
    grid path's capacity counter."""
    sizes = index.starts[1:cfg.num_cells + 1] - index.starts[:cfg.num_cells]
    return torch.clamp_min(sizes.to(torch.int64) - cfg.grid.cell_capacity,
                           0).sum()


def step_fused(state: ObjectState, generator: torch.Generator | None,
               cfg: SystemConfig) -> tuple[ObjectState, StepOutput]:
    """One scene step: physics, then fused detection and alerts.

    The alert list equals the reference-shaped XLA path's as unordered pairs
    whenever overflow == alert_overflow == 0 and the scene budget does not
    bind."""
    state = integrate(state, cfg, generator)
    return state, detect_and_alerts_fused(state, cfg)


def make_step(cfg: SystemConfig, backend: str = "fused", device=None,
              chunk_size: int | None = None):
    """Returns fn(state, generator) -> (state, StepOutput).

    backend='fused' is the only backend ported so far. `device`, when given,
    is where the state and generator must lie; the step moves nothing."""
    if chunk_size:
        raise NotImplementedError(
            "chunk_size (the blocked XLA step) is not ported yet: "
            "ROADMAP.md Queue A item 8")
    if backend == "xla":
        raise NotImplementedError(
            "backend='xla' (the reference-shaped step) is not ported yet: "
            "ROADMAP.md Queue A items 4 and 8")
    if backend != "fused":
        raise ValueError(f"unknown backend {backend!r}")
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def fn(state: ObjectState, generator: torch.Generator | None):
        if dev is not None and state.device != dev:
            raise ValueError(f"state lies on {state.device}, step expects "
                             f"{dev}")
        return step_fused(state, generator, cfg)

    return fn
