"""Fleet physics integrator (the port of tpu_collide/sim/integrator.py).

Euler position update, elastic bounce at the world borders, a random
acceleration redraw with probability accel_change_prob, velocity update, a
horizontal speed cap and heading = atan2(vy, vx) while moving. The draws come
from a `torch.Generator`; tests inject the JAX package's draws instead
(`redraw`, `new_acc`), since the two generators give different numbers.
"""
from __future__ import annotations

import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import host_tensor
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.core.utils import traced


@traced("tc.integrate")
def integrate(state: ObjectState, cfg: SystemConfig,
              generator: torch.Generator | None = None,
              redraw: torch.Tensor | None = None,
              new_acc: torch.Tensor | None = None) -> ObjectState:
    """One physics step. redraw ([N, 1] bool) and new_acc ([N, 3] f32), when
    given, replace the generator's draws."""
    sim = cfg.sim
    dt = sim.dt
    dev = state.device
    n = state.n
    lo = host_tensor(cfg.world.lo, torch.float32, dev)
    hi = host_tensor(cfg.world.hi, torch.float32, dev)
    is3d = cfg.world.is_3d

    # harness order: move, then bounce, then accelerate
    pos = state.pos + state.vel * dt
    below, above = pos < lo, pos > hi
    bounce = below | above
    if not is3d:
        bounce[:, 2] = False
    pos = torch.where(below, lo, torch.where(above, hi, pos))
    vel = torch.where(bounce, -state.vel, state.vel)

    if redraw is None:
        redraw = torch.rand((n, 1), generator=generator,
                            device=dev) < sim.accel_change_prob
    if new_acc is None:
        r = sim.accel_range
        new_acc = torch.rand((n, 3), generator=generator,
                             device=dev) * (2.0 * r) - r
    if not is3d:
        new_acc = new_acc.clone()
        new_acc[:, 2] = 0.0
    acc = torch.where(redraw, new_acc, state.acc)

    # velocity update + horizontal speed cap
    vel = vel + acc * dt
    h_speed = torch.sqrt(torch.sum(vel[:, :2] * vel[:, :2], dim=-1,
                                   keepdim=True))
    max_speed = host_tensor(sim.max_speed, torch.float32, dev)
    scale = torch.where(h_speed > sim.max_speed, max_speed / h_speed,
                        torch.ones_like(h_speed))
    vel = vel * torch.cat([scale, scale, torch.ones_like(scale)], dim=-1)

    moving = h_speed[:, 0] > sim.min_heading_speed
    heading = torch.where(moving, torch.atan2(vel[:, 1], vel[:, 0]),
                          state.heading)

    # dead slots stay frozen
    alive3 = state.alive[:, None]
    return state.replace(
        pos=torch.where(alive3, pos, state.pos),
        vel=torch.where(alive3, vel, state.vel),
        acc=torch.where(alive3, acc, state.acc),
        heading=torch.where(state.alive, heading, state.heading),
    )
