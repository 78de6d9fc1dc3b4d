"""The scene cut's device time a step in the device-bound step cells: the
device operations named after its kernels (csrc/scene_cut.cu:
scene_cut_rows, scene_cut_pass, scene_cut_collect, scene_cut_final,
scene_cut_single) in the profiled window, in ms over the steps it covered.
Layer: the refine tail, kernels/refine.fused_scene_fast. Moves
obj_steps_per_s.device_bound. Silent where none ran, as on a tree whose
scene cut is the flat torch.topk cut."""

KERNEL = "scene_cut"


def read(trace: dict):
    spans = [(s, e) for n, s, e in trace["device"] if KERNEL in n]
    if not spans or not trace["units"]:
        return None
    return sum(e - s for s, e in spans) * 1e-3 / trace["units"]
