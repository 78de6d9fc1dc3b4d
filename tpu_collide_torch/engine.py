"""The engine (the port of tpu_collide/engine.py): one step is

    backend 'xla':   integrate -> build grid (sort) -> broad phase (stencil
                     gather) -> narrow phase (4 stages) -> alert top-k
    backend 'fused': integrate -> cell list (one sort by cell) -> fused
                     kernel slots -> refine tail (scene top-A, recomputed
                     alert payloads)

'xla' is the reference-shaped path (named after the JAX package's backend;
here it is plain PyTorch), the default as in the JAX package; `chunk_size`
runs its detection over row blocks so that the [rows, K] pair tables stay
small at large N. State stays on its device between steps; a step allocates
its outputs and does not change the input state in place.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.alerts.extract import (AlertBatch, alert_batch,
                                              alert_key, extract_alerts,
                                              scene_top)
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import check_on, resolve_device
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import span
from tpu_collide_torch.detect.pipeline import (PairRisks, detect_pairs,
                                               detect_rows)
from tpu_collide_torch.index.grid import build_grid
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.fused_detect import fused_topk
from tpu_collide_torch.kernels.refine import (fused_scene_fast,
                                              fused_scene_precise)
from tpu_collide_torch.sim.integrator import integrate


@dataclasses.dataclass(frozen=True)
class StepOutput:
    alerts: AlertBatch
    num_pairs_checked: torch.Tensor  # [] candidate pairs that passed stage 1
                                     # (alive, not self, within the search
                                     # radius); -1 when not counted
    num_risks: torch.Tensor          # [] int32 stage-4 risks produced
    max_risk: torch.Tensor           # [] f32
    num_alive: torch.Tensor          # [] int32
    overflow: torch.Tensor           # [] int32 broad-phase candidates beyond
                                     # capacity (grid buckets on the xla
                                     # path; 0 by construction on the fused)
    alert_overflow: torch.Tensor     # [] int32 alert-path capacity overflow;
                                     # 0 means the alert list is complete


def grid_overflow(index, cfg: SystemConfig) -> torch.Tensor:
    """[] int64 objects beyond cell_capacity in their bucket (dropped from
    that cell's candidate lists by index/grid.gather_candidates): the
    grid path's capacity counter."""
    sizes = index.starts[1:cfg.num_cells + 1] - index.starts[:cfg.num_cells]
    return torch.clamp_min(sizes.to(torch.int64) - cfg.grid.cell_capacity,
                           0).sum()


# ---- the reference-shaped path ('xla') ------------------------------------

def detect_only(state: ObjectState, cfg: SystemConfig) -> PairRisks:
    """Index build and 4-stage detection, no physics."""
    index = build_grid(state.pos, state.alive, cfg)
    return detect_pairs(state, index, cfg)


def detect_and_alerts(state: ObjectState, cfg: SystemConfig) -> StepOutput:
    """The non-physics tail of a step: index build, detection, alert
    extraction and counters."""
    index = build_grid(state.pos, state.alive, cfg)
    pairs = detect_pairs(state, index, cfg)
    return StepOutput(
        alerts=extract_alerts(state, pairs, cfg),
        num_pairs_checked=pairs.num_checked,
        num_risks=pairs.valid.sum(dtype=torch.int32),
        max_risk=pairs.risk.max(),
        num_alive=state.alive.sum(dtype=torch.int32),
        overflow=grid_overflow(index, cfg).to(torch.int32),
        alert_overflow=pairs.survivor_overflow,
    )


def step(state: ObjectState, generator: torch.Generator | None,
         cfg: SystemConfig) -> tuple[ObjectState, StepOutput]:
    """One scene step: physics, then detect_and_alerts."""
    state = integrate(state, cfg, generator)
    return state, detect_and_alerts(state, cfg)


def _chunked_detect_extract(state: ObjectState, cfg: SystemConfig,
                            chunk: int) -> StepOutput:
    """detect_and_alerts over row blocks of `chunk` rows: the grid is built
    once, each block keeps its own top-A, and a last top-A runs over the
    blocks' candidates. The alerts equal the flat path's whenever no block
    holds more than max_scene_alerts qualifying alerts. The last block's
    rows past N are clamped to N - 1 and masked out of every counter."""
    a = cfg.alerts
    n = state.n
    dev = state.device
    index = build_grid(state.pos, state.alive, cfg)
    blocks = []
    n_risks, surv_oflow, n_checked = [], [], []
    max_risk = torch.zeros((), dtype=torch.float32, device=dev)
    for b0 in range(0, n, chunk):
        rows = b0 + torch.arange(chunk, dtype=torch.int64, device=dev)
        in_range = rows < n
        rows = torch.clamp_max(rows, n - 1)
        pairs = detect_rows(state, index, cfg, rows, row_valid=in_range)
        key, prio = alert_key(state.oid[rows], state.oid, pairs, cfg,
                              in_range)
        k = key.shape[1]
        top_key, top_i = scene_top(key.reshape(-1), a.max_scene_alerts)
        flat = lambda x: x.reshape(chunk * k, *x.shape[2:])[top_i]
        blocks.append(dict(
            key=top_key, vehicle_oid=state.oid[rows][top_i // k],
            other_oid=state.oid[flat(pairs.other).to(torch.int64)],
            risk=flat(pairs.risk),
            ttc=flat(pairs.ttc), distance=flat(pairs.distance),
            rel_speed=flat(pairs.rel_speed), priority=flat(prio),
            col_pos=flat(pairs.col_pos)))
        n_risks.append((pairs.valid & in_range[:, None]).sum(
            dtype=torch.int32))
        max_risk = torch.maximum(max_risk, torch.where(
            in_range[:, None], pairs.risk,
            torch.zeros_like(pairs.risk)).max())
        surv_oflow.append(pairs.survivor_overflow)
        n_checked.append(pairs.num_checked)

    cat = {f: torch.cat([blk[f] for blk in blocks]) for f in blocks[0]}
    top_key, top_i = scene_top(cat["key"], a.max_scene_alerts)
    g = {f: v[top_i] for f, v in cat.items()}
    return StepOutput(
        alerts=alert_batch(top_key >= 0.0, g["vehicle_oid"], g["other_oid"],
                           g["risk"], g["ttc"], g["distance"],
                           g["rel_speed"], g["priority"], g["col_pos"]),
        num_pairs_checked=torch.stack(n_checked).sum(dtype=torch.int32),
        num_risks=torch.stack(n_risks).sum(dtype=torch.int32),
        max_risk=max_risk,
        num_alive=state.alive.sum(dtype=torch.int32),
        overflow=grid_overflow(index, cfg).to(torch.int32),
        alert_overflow=torch.stack(surv_oflow).sum(dtype=torch.int32),
    )


def step_chunked(state: ObjectState, generator: torch.Generator | None,
                 cfg: SystemConfig, chunk: int
                 ) -> tuple[ObjectState, StepOutput]:
    """Large-N step: the semantics of `step`, with blocked detection."""
    state = integrate(state, cfg, generator)
    return state, _chunked_detect_extract(state, cfg, chunk)


# ---- the fused path -------------------------------------------------------

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


def step_fused(state: ObjectState, generator: torch.Generator | None,
               cfg: SystemConfig) -> tuple[ObjectState, StepOutput]:
    """One scene step: physics, then fused detection and alerts.

    The alert list equals the reference-shaped path's as unordered pairs
    whenever overflow == alert_overflow == 0 and the scene budget does not
    bind."""
    with span("tc.step"):
        state = integrate(state, cfg, generator)
        return state, detect_and_alerts_fused(state, cfg)


# ---- the engine surface ---------------------------------------------------

def _step_fn(cfg: SystemConfig, chunk_size: int | None, backend: str):
    """The per-step function of a backend ('fused' wins over chunk_size,
    as in the JAX package)."""
    if backend == "fused":
        return lambda st, gen: step_fused(st, gen, cfg)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    if chunk_size:
        return lambda st, gen: step_chunked(st, gen, cfg, chunk_size)
    return lambda st, gen: step(st, gen, cfg)


def make_step(cfg: SystemConfig, donate: bool = True,
              chunk_size: int | None = None, backend: str = "xla",
              window_rows: int | None = None, device=None):
    """Returns fn(state, generator) -> (state, StepOutput).

    backend='xla' (default): the reference-shaped path; chunk_size selects
    its blocked large-N variant. backend='fused': the cell list and the
    fused CUDA kernel, in both detection modes. The state and generator
    must lie on `device` (the card unless another is named); the step moves
    nothing. `donate` and `window_rows` are accepted for the JAX package's
    signature and ignored: PyTorch has no buffer donation (the step leaves
    its input state as it was), and the port's cell list has no windows."""
    fn = _step_fn(cfg, chunk_size, backend)
    dev = resolve_device(device)

    def stepper(state: ObjectState, generator: torch.Generator | None):
        check_on(state, dev, "step")
        return fn(state, generator)

    return stepper


def make_burst_step(cfg: SystemConfig, n: int, donate: bool = True,
                    chunk_size: int | None = None, backend: str = "xla",
                    window_rows: int | None = None, device=None):
    """Returns fn(state, generator) -> (state, generator, out,
    risks_per_step): n steps of make_step's body, drawing from the generator
    in turn, so burst(n) computes the same trajectory as n single steps
    from the same generator state.

    `out` is the last step's StepOutput with overflow and alert_overflow
    replaced by the worst over the burst; risks_per_step is [n] int32.
    `donate`, `window_rows` and `device` as in make_step."""
    if n < 1:
        raise ValueError(f"burst length must be >= 1, got {n}")
    fn = _step_fn(cfg, chunk_size, backend)
    dev = resolve_device(device)

    def burst(state: ObjectState, generator: torch.Generator | None):
        check_on(state, dev, "burst")
        risks, of, ao = [], None, None
        for _ in range(n):
            state, out = fn(state, generator)
            risks.append(out.num_risks)
            of = out.overflow if of is None else torch.maximum(
                of, out.overflow)
            ao = out.alert_overflow if ao is None else torch.maximum(
                ao, out.alert_overflow)
        out = dataclasses.replace(out, overflow=of, alert_overflow=ao)
        return state, generator, out, torch.stack(risks).to(torch.int32)

    return burst


def make_detect(cfg: SystemConfig, device=None):
    """Returns fn(state) -> PairRisks (detect_only); the state must lie on
    `device`, the card unless another is named."""
    dev = resolve_device(device)

    def detect(state: ObjectState) -> PairRisks:
        check_on(state, dev, "detect")
        return detect_only(state, cfg)

    return detect
