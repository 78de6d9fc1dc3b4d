"""The least time the card could take for the detection kernel's work,
counted from a step's inputs (never from the program's data structures).

PEAK_*, OPS and bound() are frozen copies of chip_smoke.py's (lines
247-268 and 346-354 at the benchmark's first commit). The work is the
benchmark's own count on the state the step detected on: candidates walked
in the 3 x 3 (2D) or 3 x 3 x 3 (3D) cell stencil of the configuration's
grid, ordered pairs within the search radius (stage 1) and stage-2
survivors (reference/detect.py), whatever implements them.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: device memory, and f32 outside the tensor
# cores. A card set below its 700 W limit runs slower under load: the
# result line carries the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per pair (2D, 3D), a square root or a compare as one:
#   walk      stage 1 of every candidate walked (differences, d^2, compare)
#   stage2    closest approach of a stage-1 pair (relative motion, t*, the
#             distance at t*, the safe distance, the four tests)
#   hit_tail  stage 3 (closed-form crossing, snap to the dt lattice), stage
#             4 (risk), priority and key of a stage-2 survivor
OPS = dict(walk=(6, 9), stage2=(38, 52), hit_tail=(85, 89))
# bytes a live object's record holds of what the pair math reads: position,
# velocity and acceleration (3 f32 each), size, heading and type (f32)
RECORD_BYTES = 12 * 4


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, operations=n_ops)


def detect_bound(work: dict) -> dict:
    """bound() of the fast-mode detection kernel on one step: each live
    object's record and the grid's cell starts read once; k slots (an f32
    key and an i32 index each), two per-object counters and the scene
    counter written once; every walked candidate's stage 1, every stage-1
    pair's stage 2 and every stage-2 survivor's stages 3-4.
    `work`: {"alive", "cells", "k", "is3d", "walked", "stage1",
    "stage2"}."""
    d3 = int(work["is3d"])
    n = work["alive"]
    n_ops = (work["walked"] * OPS["walk"][d3]
             + work["stage1"] * OPS["stage2"][d3]
             + work["stage2"] * OPS["hit_tail"][d3])
    n_bytes = (n * RECORD_BYTES + (work["cells"] + 1) * 4
               + n * work["k"] * 8 + n * 8 + 8)
    return bound(n_bytes, n_ops)
