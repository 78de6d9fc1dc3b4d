"""The physics layer's host self time a step: the tc.integrate spans
(sim/integrator.integrate) less the host waits inside them, in ms over the
profiled steps. Layer: physics. Moves step_ms_p95. Silent where the program
opens no spans."""
from perfbench.spans import self_ms


def read(trace: dict):
    return self_ms(trace, "tc.integrate")
