"""Host waits a step: the tc.host_wait spans the program opens around
each point of the fused step where the host waits for the device, over the
profiled steps. Layer: the engine's eager fused step. Moves step_ms_p95.
Silent where the program opens no spans."""
from perfbench.spans import WAIT, per_unit


def read(trace: dict):
    return per_unit(trace, WAIT)
