"""The trajectory ring's device time a tick in the warn cell: the device
operations launched inside the tc.history spans (detect/predict.
update_history: the ring's copy and the tick's writes), by the profiler's
link from each to the host operation that launched it, in ms over the
profiled ticks. Layer: prediction. Moves step_ms_p95. Silent where the
program opens no such span."""
from perfbench.launched import launched_ms


def read(trace: dict):
    return launched_ms(trace, "tc.history")
