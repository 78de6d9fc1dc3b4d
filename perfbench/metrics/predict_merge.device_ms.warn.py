"""The prediction's merge: its device time a call in the warn cell, the
device operations launched inside the tc.predict_merge spans (kernels/
refine.fused_predict_rows: the occupied slots' recompute, the merge per row
and the truncation certificate), by the profiler's link from each to the
host operation that launched it, in ms over the profiled predict calls.
Layer: prediction. Moves step_ms_p95. Silent where the program opens no
such span."""
from perfbench.launched import launched_ms
from perfbench.spans import spans

SPAN = "tc.predict_merge"


def read(trace: dict):
    calls = len(spans(trace, SPAN))
    ms = launched_ms(trace, SPAN)
    if not calls or ms is None:
        return None
    return ms * trace["units"] / calls
