"""The sampled sweep's share of its roofline: the least time the card
could take for a step's sweep (roofline_precise.sweep_bound: every stage-2
survivor swept up to its first hit, counted by the reference on the
profiled steps' own states) over the device time a step launched inside
tc.precise_sweep. Layer: the precise tail. Moves
obj_steps_per_s.device_bound. Silent where the program opens no such
span."""
from perfbench.launched import launched_ms


def read(trace: dict):
    bounds = trace.get("sweep_bounds_ms") or []
    ms = launched_ms(trace, "tc.precise_sweep")
    if not bounds or not ms:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / ms
