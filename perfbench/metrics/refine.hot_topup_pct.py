"""The share of steps whose hot top-up recomputed hot rows: 100 x the
steps (tc.step spans) that hold a tc.hot_pairs span / the profiled steps.
Layer: the refine tail (kernels/refine._hot_topup). Moves step_ms_p95.
Silent where the program opens no spans."""
from perfbench.spans import HOT, units_holding_pct


def read(trace: dict):
    return units_holding_pct(trace, HOT)
