"""The device's idle share that the step itself leaves: 100 x the time
inside tc.step spans that no device operation covers / the window's wall
time. step.idle_pct less this is the idle outside the program's step (the
loop's read, the profiler's own requests). Layer: the device. Moves
step_ms_p95. Silent where the program opens no spans."""
from perfbench.spans import idle_in_step_pct


def read(trace: dict):
    return idle_in_step_pct(trace)
