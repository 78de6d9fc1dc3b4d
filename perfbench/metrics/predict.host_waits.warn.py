"""Host waits a prediction in the warn cell: the tc.host_wait spans that
start inside a tc.predict span (engine.make_predict's call), over the
profiled predict calls. Layer: prediction. Moves step_ms_p95. Silent where
the program opens no tc.predict span."""
from bisect import bisect_right

from perfbench.spans import WAIT, spans


def read(trace: dict):
    calls = sorted(spans(trace, "tc.predict"))
    if not calls:
        return None
    starts = [s for s, _ in calls]
    inside = 0
    for s, _ in spans(trace, WAIT):
        i = bisect_right(starts, s) - 1
        inside += i >= 0 and s <= calls[i][1]
    return inside / len(calls)
