"""refine.hot_topup_pct in the device-bound step cells, where it moves
obj_steps_per_s.device_bound: the reading of refine.hot_topup_pct.py."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("refine.hot_topup_pct.py")).read
