"""The load harness on the port (the port of tpu_collide/bench/): the
step-loop tester, the load generator with its failure injector and
analyzer, the monitor, and the orchestrated run (run_benchmark)."""
from tpu_collide_torch.bench.harness import (PerformanceTester,
                                             PerformanceMetrics)
from tpu_collide_torch.bench.load_generator import (
    LoadGenerator, LoadTestResult, FailureInjector, PerformanceAnalyzer)
from tpu_collide_torch.bench.monitor import PerformanceMonitor
