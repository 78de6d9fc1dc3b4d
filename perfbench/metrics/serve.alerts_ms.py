"""Host ms a tick spends in the Scene's alert_manager.process_batch, from a
timer the benchmark places around that call in the traced run, over every
tick of the window. Layer: alerts.manager.AlertManager.process_batch.
Moves tick_ms_p95."""


def read(trace: dict):
    return trace.get("alerts_ms")
