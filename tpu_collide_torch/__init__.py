"""tpu_collide_torch: the PyTorch / CUDA port of tpu-collide.

The steps of `tpu_collide` in PyTorch: the reference-shaped step (grid,
stencil gather, 4-stage detection, alert top-k; `make_step`'s default, with
`chunk_size` for large fleets), the fused step (cell list, one fused broad +
narrow phase kernel, refine tail), burst stepping, trajectory prediction
(detect/predict.py, kernels/refine.fused_predict), the capacity tuners
(kernels/tune.py) and the block co-sort (kernels/block_sort.py), with the
kernels written in CUDA C++ for Hopper (csrc/); the device scenario modes
(sim/scenario.py); the sharded step (shard/: a mesh of shards in one
process, migration and halo exchange, the fused kernel per shard, load
balancing, sharded prediction); the serving surface (api.Scene,
api.ShardedScene) and the service node (system.py: runtime, REST routes,
stdlib HTTP server; `python -m tpu_collide_torch.system`). Entry
points run on the CUDA card unless given device='cpu'. The JAX package stays the reference
the port is checked against; this package imports torch and never jax.
"""
from tpu_collide_torch.core.config import (SystemConfig, WorldConfig,
                                           GridConfig, DetectionConfig,
                                           AlertConfig, SimConfig,
                                           ShardConfig, VEHICLE_TYPES,
                                           VEHICLE_SIZES)
from tpu_collide_torch.core.state import (ObjectState, empty_state,
                                          state_from_numpy)
from tpu_collide_torch.engine import step, make_step, make_detect, StepOutput

__version__ = "0.1.0"
