"""The detection kernel's share of its roofline: the least time the card
could take for a step's detection work (roofline.detect_bound, counted by
the benchmark on the steps' own states) over the kernel's device time a
step in the profiled window (device operations named fused_topk_kernel).
Layer: kernels.fused_detect -> csrc/fused_detect.cu. Moves
step_ms_p95. Silent where no such kernel ran."""

KERNEL = "fused_topk_kernel"


def read(trace: dict):
    spans = [(s, e) for n, s, e in trace["device"] if KERNEL in n]
    bounds = trace.get("bounds_ms") or []
    if not spans or not bounds or not trace["units"]:
        return None
    kernel_ms = sum(e - s for s, e in spans) * 1e-3 / trace["units"]
    return 100.0 * (sum(bounds) / len(bounds)) / kernel_ms
