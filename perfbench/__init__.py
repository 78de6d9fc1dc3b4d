"""The benchmark of tpu_collide_torch on one NVIDIA H100.

`python3 perfbench/run.py --workload <config>.<mix> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once and prints one JSON line.
Everything a cell needs is found by name: perfbench/configs/<config>.json,
perfbench/traffic/<mix>.json (which names its driver in
perfbench/drivers/), perfbench/limits/<cell>.json and one reader per
per-layer metric in perfbench/metrics/<metric>.py.
"""
