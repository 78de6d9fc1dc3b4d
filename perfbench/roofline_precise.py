"""The least time the card could take for precise mode's two distinctive
parts, counted from a step's inputs by the benchmark's own reference (never
from the program's data structures), against roofline.py's peaks:

  survivors_bound  the detection kernel in survivors mode (B2): stages 1-2
                   only, its slots holding stage-2 survivors
  sweep_bound      the sampled stage 3 over the stage-2 survivors
                   (reference/precise.py), each swept up to its first hit
"""
from __future__ import annotations

from perfbench.roofline import OPS, RECORD_BYTES, bound

# Operations of one sample of the sweep (2D, 3D), a square root or a
# compare as one, 1/2 a held per pair. In 3D: t^2 (1); v t (3 multiplies);
# (1/2 a) t^2 (3); the two vector adds r + v t + ... (6); the squared
# distance (3 multiplies, 2 adds); its square root (1); the compare with
# the safe distance (1): 20. In 2D the vectors have two components: 1 + 2
# + 2 + 4 + 3 + 1 + 1 = 14.
SAMPLE_OPS = (14, 20)
# what the sweep writes of a survivor: its hit, ttc and distance, one
# 4-byte word each
RESULT_BYTES = 3 * 4


def survivors_bound(work: dict) -> dict:
    """bound() of the detection kernel in survivors mode on one step: each
    live object's record and the grid's cell starts read once; k =
    survivor_k slots (an f32 key and an i32 index each), two per-object
    counters and the scene counter written once; every walked candidate's
    stage 1 and every stage-1 pair's stage 2. `work`: {"alive", "cells",
    "k", "is3d", "walked", "stage1"}."""
    d3 = int(work["is3d"])
    n = work["alive"]
    n_ops = (work["walked"] * OPS["walk"][d3]
             + work["stage1"] * OPS["stage2"][d3])
    n_bytes = (n * RECORD_BYTES + (work["cells"] + 1) * 4
               + n * work["k"] * 8 + n * 8 + 8)
    return bound(n_bytes, n_ops)


def sweep_bound(work: dict) -> dict:
    """bound() of the sampled stage 3 on one step: each stage-2 survivor's
    two records read and its result written once, and every sample up to
    and including its first hit (all T where none). `work`: {"is3d",
    "stage2", "samples" (the survivors' samples summed)}."""
    n_ops = work["samples"] * SAMPLE_OPS[int(work["is3d"])]
    n_bytes = work["stage2"] * (2 * RECORD_BYTES + RESULT_BYTES)
    return bound(n_bytes, n_ops)
