"""Scene alert buffer and priority rules (the port of
tpu_collide/alerts/extract.py:22-55). `extract_alerts`, the XLA path's
extractor, is not ported yet."""
from __future__ import annotations

import dataclasses

import torch

from tpu_collide_torch.core.config import SystemConfig

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
