"""The cell list's host self time a step: the tc.cell_list spans
(kernels/cell_list.build_cell_list) less the host waits inside them, in ms
over the profiled steps. Layer: the cell list. Moves step_ms_p95. Silent
where the program opens no spans."""
from perfbench.spans import self_ms


def read(trace: dict):
    return self_ms(trace, "tc.cell_list")
