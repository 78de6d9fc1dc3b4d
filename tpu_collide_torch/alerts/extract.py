"""Scene alert buffer, priority rules and the reference-shaped path's alert
extraction (the port of tpu_collide/alerts/extract.py): risks below
risk_low are dropped, priorities follow the CRITICAL / HIGH / MEDIUM / LOW
rules, and the scene keeps a fixed top-A by (priority, risk)."""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.ops import stable_topk

PRIORITY_LOW, PRIORITY_MEDIUM, PRIORITY_HIGH, PRIORITY_CRITICAL = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class AlertBatch:
    """Scene-level alert buffer of fixed shape [A]; `count` alerts are
    valid."""
    vehicle_oid: torch.Tensor   # [A] int32
    other_oid: torch.Tensor     # [A] int32
    risk: torch.Tensor          # [A] f32
    ttc: torch.Tensor           # [A] f32
    distance: torch.Tensor      # [A] f32
    rel_speed: torch.Tensor     # [A] f32
    priority: torch.Tensor      # [A] int32 0..3
    col_pos: torch.Tensor       # [A, 3] f32
    valid: torch.Tensor         # [A] bool
    count: torch.Tensor         # [] int32


def compute_priority(risk: torch.Tensor, ttc: torch.Tensor,
                     cfg: SystemConfig) -> torch.Tensor:
    """Priority rules, reference warning_system.py:287-311."""
    a = cfg.alerts
    crit = (risk >= a.risk_high) & (ttc < a.ttc_critical)
    high = (risk >= a.risk_high) | (ttc < a.ttc_high)
    med = risk >= a.risk_medium
    prio = torch.full_like(risk, PRIORITY_LOW, dtype=torch.int32)
    prio = torch.where(med, PRIORITY_MEDIUM, prio)
    prio = torch.where(high, PRIORITY_HIGH, prio)
    return torch.where(crit, PRIORITY_CRITICAL, prio).to(torch.int32)


def scene_top(key: torch.Tensor, a: int):
    """(top_key, top_idx) of the `a` largest entries of the flat `key`,
    ties by the lower index as jax.lax.top_k breaks them (the key
    2*prio + risk has exact ties: risk is clipped at 1.0). When `key` holds
    fewer than `a` entries, the rest are (-1, an index of `key`), which
    callers read as invalid."""
    m = key.numel()
    if m < a:
        key = torch.cat([key, key.new_full((a - m,), -1.0)])
    top_key, top_idx = stable_topk(key, a)
    return top_key, torch.clamp_max(top_idx, m - 1)


def alert_key(row_oid, oid, pairs, cfg: SystemConfig,
              row_mask: torch.Tensor | None = None):
    """(key, priority) [Q, K] of a PairRisks table whose rows have the oids
    `row_oid` ([Q]; `oid` [N] is the fleet's): the ranking key
    2*priority + risk of each qualifying pair, -1 elsewhere. A pair is
    detected from both ends with the same values, so only oid_i < oid_j
    qualifies; `row_mask` ([Q] bool) drops whole rows."""
    keep = (pairs.valid & (pairs.risk >= cfg.alerts.risk_low)
            & (row_oid[:, None] < oid[pairs.other.to(torch.int64)]))
    if row_mask is not None:
        keep = keep & row_mask[:, None]
    prio = compute_priority(pairs.risk, pairs.ttc, cfg)
    key = torch.where(keep, prio.to(torch.float32) * 2.0 + pairs.risk,
                      torch.full_like(pairs.risk, -1.0))
    return key, prio


def extract_alerts(state, pairs, cfg: SystemConfig,
                   query_mask: torch.Tensor | None = None) -> AlertBatch:
    """The scene top-A of a PairRisks table over all N objects.
    `query_mask` ([N] bool) restricts emission to those rows."""
    n, k = pairs.risk.shape
    key, prio = alert_key(state.oid, state.oid, pairs, cfg, query_mask)
    top_key, top_idx = scene_top(key.reshape(-1), cfg.alerts.max_scene_alerts)
    flat = lambda x: x.reshape(n * k, *x.shape[2:])[top_idx]
    return alert_batch(
        top_key >= 0.0, state.oid[top_idx // k],
        state.oid[flat(pairs.other).to(torch.int64)], flat(pairs.risk),
        flat(pairs.ttc), flat(pairs.distance), flat(pairs.rel_speed),
        flat(prio), flat(pairs.col_pos))


def alert_batch(valid, vehicle_oid, other_oid, risk, ttc, distance,
                rel_speed, priority, col_pos) -> AlertBatch:
    """An AlertBatch of the selected entries, with the invalid ones masked
    to the padding values (-1 oids, risk 0, ttc inf, priority 0)."""
    neg = torch.full_like(vehicle_oid, -1)
    inf = torch.full_like(risk, float("inf"))
    zero = torch.zeros_like(risk)
    return AlertBatch(
        vehicle_oid=torch.where(valid, vehicle_oid, neg),
        other_oid=torch.where(valid, other_oid, neg),
        risk=torch.where(valid, risk, zero),
        ttc=torch.where(valid, ttc, inf),
        distance=torch.where(valid, distance, inf),
        rel_speed=torch.where(valid, rel_speed, zero),
        priority=torch.where(valid, priority, torch.zeros_like(priority)),
        col_pos=col_pos,
        valid=valid,
        count=valid.sum(dtype=torch.int32),
    )
