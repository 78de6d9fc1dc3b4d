"""detect_kernel.roofline_pct in the precise cell, where the kernel runs in
survivors mode (B2) and moves obj_steps_per_s.device_bound: the reading of
detect_kernel.roofline_pct.py against the bound the precise driver puts on
the trace (roofline_precise.survivors_bound: stages 1-2 and survivor_k
slots)."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("detect_kernel.roofline_pct.py")).read
