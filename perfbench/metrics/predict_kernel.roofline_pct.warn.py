"""The predict kernel's share of its roofline in the warn cell: the least
time the card could take for a predict call's kernel work
(roofline_predict.predict_bound, counted by the reference on the profiled
calls' own states and rings) over the kernel's device time a call (device
operations named fused_predict_kernel, over the tc.predict spans). Layer:
kernels: fused_predict (csrc/fused_predict.cu). Moves step_ms_p95. Silent
where no such kernel ran or the program opens no tc.predict span."""
from perfbench.spans import spans

KERNEL = "fused_predict_kernel"


def read(trace: dict):
    calls = len(spans(trace, "tc.predict"))
    kernel = [(s, e) for n, s, e in trace["device"] if KERNEL in n]
    bounds = trace.get("predict_bounds_ms") or []
    if not calls or not kernel or not bounds:
        return None
    kernel_ms = sum(e - s for s, e in kernel) * 1e-3 / calls
    return 100.0 * (sum(bounds) / len(bounds)) / kernel_ms
