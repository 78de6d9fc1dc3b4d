"""Host waits a step of the cut-aware hot cover in the city-skew cell: the
tc.host_wait spans that start inside a tc.hot_cover span (the row list
and, when a row is covered, the pair count), over the profiled steps.
Layer: the refine tail (kernels/refine.fused_scene_fast). Moves
step_ms_p95. Silent where the program opens no tc.hot_cover span."""
from bisect import bisect_right

from perfbench.spans import WAIT, spans

SPAN = "tc.hot_cover"


def read(trace: dict):
    cover = sorted(spans(trace, SPAN))
    if not cover or not trace["units"]:
        return None
    starts = [s for s, _ in cover]
    inside = 0
    for s, _ in spans(trace, WAIT):
        i = bisect_right(starts, s) - 1
        inside += i >= 0 and s <= cover[i][1]
    return inside / trace["units"]
