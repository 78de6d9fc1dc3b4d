"""The sampled sweep's device time a step in the precise cell: the device
operations launched inside the tc.precise_sweep spans
(detect/pipeline._precise_sweep's chunk loop), by the profiler's link
from each to the host operation that launched it, in ms over the profiled
steps. Layer: the precise tail. Moves obj_steps_per_s.device_bound. Silent
where the program opens no such span."""
from perfbench.launched import launched_ms


def read(trace: dict):
    return launched_ms(trace, "tc.precise_sweep")
