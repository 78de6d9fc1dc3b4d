"""The device's idle share over the profiled ticks: 100 x (1 - the union of
the device operations' intervals / the window's wall time). Layer: the
device. Moves ticks_per_s."""


def read(trace: dict):
    if not trace["window_s"] or not trace["device"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
