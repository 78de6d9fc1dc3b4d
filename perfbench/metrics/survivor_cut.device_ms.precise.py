"""The survivor compaction's device time a step in the precise cell: the
device operations launched inside the tc.survivor_cut spans
(kernels/refine.fused_scene_precise: the masked slot keys, their stable
sort, the gathers of the survivors' rows and candidates), by the
profiler's link from each to the host operation that launched it, in ms
over the profiled steps. Layer: the precise tail. Moves
obj_steps_per_s.device_bound. Silent where the program opens no such
span."""
from perfbench.launched import launched_ms


def read(trace: dict):
    return launched_ms(trace, "tc.survivor_cut")
