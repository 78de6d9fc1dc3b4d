"""The prediction's compaction: its device time a call in the warn cell,
the device operations launched inside the tc.predict_compact spans (kernels/
refine.fused_predict's scatter of the merged rows to object order, then
engine.compact_predicted's top r_cap of the [N, merge_k] risks and its
gathers; two spans a call), by the profiler's link from each to the host
operation that launched it, in ms over the profiled predict calls. Layer:
prediction. Moves step_ms_p95. Silent where the program opens no such
span."""
from perfbench.launched import launched_ms
from perfbench.spans import spans

SPAN = "tc.predict_compact"


def read(trace: dict):
    calls = len(spans(trace, "tc.predict"))
    ms = launched_ms(trace, SPAN)
    if not calls or ms is None:
        return None
    return ms * trace["units"] / calls
