"""Host ms a tick spends in Scene.ingest (one call per report) and
Scene.flush(), from the benchmark's own spans around those calls, over
every tick of the window. Layer: api.scene.Scene ingest and flush. Moves
tick_ms_p95."""


def read(trace: dict):
    return trace.get("ingest_ms")
