"""The cell list's record kernel's device time a step in the 10M step
cells: the device operations named after it (csrc/cell_records.cu:
cell_records_kernel) in the profiled window, in ms over the steps it
covered. Layer: the cell list, kernels/cell_list.build_cell_list. Moves
obj_steps_per_s.device_bound. Silent where none ran, as on a tree whose
records are built by gathers and one torch.cat."""

KERNEL = "cell_records"


def read(trace: dict):
    spans = [(s, e) for n, s, e in trace["device"] if KERNEL in n]
    if not spans or not trace["units"]:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace["units"]
