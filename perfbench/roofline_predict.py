"""The least time the card could take for the predict kernel's work (B3,
csrc/fused_predict.cu: every live object at every offset), counted from a
predict call's inputs by the benchmark's own reference
(reference/predict.py, never from the program's data structures), against
roofline.py's peaks.

Operations, a square root, a compare or a select as one (2D, 3D):
  ROW_OPS     the class-predicted position of a live object at an offset
              (p + v t: 2 per axis; + 1/2 a t^2: 4 per axis) and its cell
              ((p - lo) / cell, floor, clip: 5 per axis)
  walk        stage 1 of every candidate walked in the stencil of that cell
              against the predicted position (roofline.OPS["walk"])
  PAIR_OPS    a candidate within the radius: its advance to the offset less
              the predicted position (c + v t + 1/2 a t^2 - p: 7 per axis),
              the relative velocity and acceleration (1 per axis each) and
              the safe distance (3)
  sample      one sample of the sub-window sweep up to and including the
              first hit (roofline_precise.SAMPLE_OPS)
  HIT_OPS     a hit's stage 4: the distance's square root (1), the distance
              term (3), the time term (4), the speed term (a norm, then 3:
              7 in 2D, 9 in 3D), the angle term (5), the type term (3), the
              sum (4) and the clip (2)
Bytes: each live object's record (roofline.RECORD_BYTES) and its class
(4) read once, the grid's cell starts read once, and per (offset, live
object) its k slots (an f32 key and an i32 index each) and its emitted
counter written once.
"""
from __future__ import annotations

from perfbench.roofline import OPS, RECORD_BYTES, bound
from perfbench.roofline_precise import SAMPLE_OPS

ROW_OPS = (22, 33)
PAIR_OPS = (21, 30)
HIT_OPS = (29, 31)


def predict_bound(work: dict) -> dict:
    """bound() of one predict call. `work`: {"alive", "cells", "k",
    "is3d", "rows" (live objects x offsets), "walked", "pairs", "samples",
    "hits"}, as reference/predict.predict counts them."""
    d3 = int(work["is3d"])
    n_ops = (work["rows"] * ROW_OPS[d3] + work["walked"] * OPS["walk"][d3]
             + work["pairs"] * PAIR_OPS[d3]
             + work["samples"] * SAMPLE_OPS[d3] + work["hits"] * HIT_OPS[d3])
    n_bytes = (work["alive"] * (RECORD_BYTES + 4) + (work["cells"] + 1) * 4
               + work["rows"] * (work["k"] * 8 + 4))
    return bound(n_bytes, n_ops)
