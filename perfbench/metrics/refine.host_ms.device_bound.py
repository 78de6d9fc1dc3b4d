"""refine.host_ms in the device-bound step cells, where it moves
obj_steps_per_s.device_bound: the reading of refine.host_ms.py."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("refine.host_ms.py")).read
