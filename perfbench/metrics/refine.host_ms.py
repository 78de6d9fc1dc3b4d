"""The refine tail's host self time a step: the tc.refine spans
(kernels/refine.fused_scene_fast) less the detection kernel's spans
(tc.detect_kernel) and the host waits inside them, in ms over the profiled
steps; the hot top-up's recompute (tc.hot_pairs) stays in. Layer: the
refine tail. Moves step_ms_p95. Silent where the program opens no spans."""
from perfbench.spans import self_ms


def read(trace: dict):
    return self_ms(trace, "tc.refine")
