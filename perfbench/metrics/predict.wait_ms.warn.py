"""The prediction's host waits in ms a call in the warn cell: the host time
inside the tc.host_wait spans that start inside a tc.predict span
(engine.make_predict's call), over the profiled predict calls: how long
the prediction's host side stands blocked on the device. Layer:
prediction. Moves step_ms_p95. Silent where the program opens no
tc.predict span."""
from bisect import bisect_right

from perfbench.spans import WAIT, spans


def read(trace: dict):
    calls = sorted(spans(trace, "tc.predict"))
    if not calls:
        return None
    starts = [s for s, _ in calls]
    waited_us = 0.0
    for s, e in spans(trace, WAIT):
        i = bisect_right(starts, s) - 1
        if i >= 0 and s <= calls[i][1]:
            waited_us += e - s
    return waited_us * 1e-3 / len(calls)
