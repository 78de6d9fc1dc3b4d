"""Prediction's device time a call in the warn cell: the device operations
launched inside the tc.predict spans (engine.make_predict's call: the
trajectory classes, the cell list, the predict kernel, the recompute and
merge, the certificate, the hot top-up, the compaction), by the profiler's
link from each to the host operation that launched it, in ms over the
profiled predict calls. Layer: prediction. Moves step_ms_p95. Silent where
the program opens no such span."""
from perfbench.launched import launched_ms
from perfbench.spans import spans

SPAN = "tc.predict"


def read(trace: dict):
    calls = len(spans(trace, SPAN))
    ms = launched_ms(trace, SPAN)
    if not calls or ms is None:
        return None
    return ms * trace["units"] / calls
