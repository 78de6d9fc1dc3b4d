"""Device kernels a step launches: the kernels in the profiled window (not
the copies and sets) over the steps it covered. Layer: the engine's eager
fused step. Moves step_ms_p95."""
from perfbench.trace import is_kernel


def read(trace: dict):
    if not trace["units"]:
        return None
    return sum(is_kernel(n) for n, _, _ in trace["device"]) / trace["units"]
