"""The cut-aware hot cover's device time a step in the city-skew cell: the
device operations launched inside the tc.hot_cover spans (the slots-only
scene cut, the reaching rows, and the covered rows' stencil pairs and
their recompute), by the profiler's link from each to the host operation
that launched it, in ms over the profiled steps. Layer: the refine tail
(kernels/refine.fused_scene_fast). Moves step_ms_p95. Silent where the
program opens no tc.hot_cover span."""
from perfbench.launched import launched_ms

SPAN = "tc.hot_cover"


def read(trace: dict):
    return launched_ms(trace, SPAN)
