"""The device's idle inside the prediction in ms a call in the warn cell:
the time inside tc.predict spans (engine.make_predict's call) that no
device operation covers, over the profiled predict calls: how long the
device waits for the prediction's host side. Near the relaunch gaps after
the prediction's waits, the device sets its pace; far above them, the
host does. Layer: prediction. Moves step_ms_p95. Silent where the program
opens no tc.predict span, or the window holds no device operation (a run
without a card)."""
from perfbench.spans import Union, spans


def read(trace: dict):
    calls = spans(trace, "tc.predict")
    if not calls or not trace["device"]:
        return None
    busy = Union((s, e) for _, s, e in trace["device"])
    idle_us = sum((e - s) - busy.covers(s, e) for s, e in calls)
    return idle_us * 1e-3 / len(calls)
