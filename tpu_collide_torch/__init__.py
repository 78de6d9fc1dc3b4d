"""tpu_collide_torch: the PyTorch / CUDA port of tpu-collide.

The fused detection step of `tpu_collide` (integrate, cell-list build, one
fused broad + narrow phase kernel, refine tail) and its trajectory
prediction (detect/predict.py, kernels/refine.fused_predict) in PyTorch,
with the kernels written in CUDA C++ for Hopper (csrc/). The JAX package
stays the reference the port is checked against; this package imports
torch and never jax.
"""
from tpu_collide_torch.core.config import (SystemConfig, WorldConfig,
                                           GridConfig, DetectionConfig,
                                           AlertConfig, SimConfig,
                                           ShardConfig, VEHICLE_TYPES,
                                           VEHICLE_SIZES)
from tpu_collide_torch.core.state import (ObjectState, empty_state,
                                          state_from_numpy)
from tpu_collide_torch.engine import make_step, StepOutput

__version__ = "0.1.0"
