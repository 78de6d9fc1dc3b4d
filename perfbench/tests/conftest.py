"""The benchmark's own tests: CPU only, small sizes, run from the checkout's
root as `python -m pytest perfbench/tests -q`."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
