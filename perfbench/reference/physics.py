"""One physics step of the fleet, stated plainly (the upstream harness's
VehicleSimulator update, as DEVIATIONS.md and the configuration fix it):

  pos += vel * dt; an object past a world border is put back on it and
  that velocity component reversed (z only in a 3D world); with
  probability accel_change_prob the acceleration is redrawn U(-r, r) per
  axis (z = 0 in 2D); vel += acc * dt; the horizontal speed is capped at
  max_speed; heading = atan2(vy, vx) while the horizontal speed before the
  cap exceeds min_heading_speed. Dead objects do not move.

The draws come from a torch.Generator identical to the one the program
draws from, in the program's order: one uniform per object for the redraw,
then three for the new acceleration (`draws`). The step loop hands the
stepper a generator of its own and keeps its state before each judged
step; the Scene draws from a generator of its own seeded SCENE_SEED, which
the serve loop's judge replays tick by tick.
"""
from __future__ import annotations

import math

import torch

# the seed of the generator every Scene draws its physics from
# (tpu_collide_torch.api.scene: "one torch.Generator seeded 0")
SCENE_SEED = 0


def advance(prev: dict, acc: torch.Tensor, sim: dict, world: dict,
            dtype=torch.float32) -> dict:
    """The state one step after `prev`, given every object's acceleration
    after the step, computed in `dtype` and returned in float32."""
    f = lambda t: t.to(dtype)
    lo = torch.tensor(world["lo"], dtype=dtype, device=acc.device)
    hi = torch.tensor(world["hi"], dtype=dtype, device=acc.device)
    is3d = world["hi"][2] > world["lo"][2]
    dt = sim["dt"]
    pos = f(prev["pos"]) + f(prev["vel"]) * dt
    out_lo, out_hi = pos < lo, pos > hi
    flip = out_lo | out_hi
    if not is3d:
        flip[:, 2] = False
    pos = torch.maximum(torch.minimum(pos, hi), lo)
    vel = torch.where(flip, -f(prev["vel"]), f(prev["vel"])) + f(acc) * dt
    h = torch.sqrt(vel[:, 0] ** 2 + vel[:, 1] ** 2)
    over = h > sim["max_speed"]
    scale = torch.where(over, sim["max_speed"] / torch.where(over, h, 1.0),
                        torch.ones_like(h))
    vel = torch.stack([vel[:, 0] * scale, vel[:, 1] * scale, vel[:, 2]], 1)
    heading = torch.where(h > sim["min_heading_speed"],
                          torch.atan2(vel[:, 1], vel[:, 0]),
                          f(prev["heading"]))
    alive = prev["alive"]
    a3 = alive[:, None]
    out = dict(prev)
    out.update(pos=torch.where(a3, pos.float(), prev["pos"]),
               vel=torch.where(a3, vel.float(), prev["vel"]),
               acc=torch.where(a3, acc.float(), prev["acc"]),
               heading=torch.where(alive, heading.float(), prev["heading"]))
    return out


def draws(n: int, sim: dict, world: dict, gen: torch.Generator) -> tuple:
    """(redraw [n, 1] bool, new [n, 3]) of one step, drawn from `gen` on its
    device in the program's order."""
    dev = gen.device
    redraw = torch.rand((n, 1), generator=gen, device=dev) < \
        sim["accel_change_prob"]
    r = sim["accel_range"]
    new = torch.rand((n, 3), generator=gen, device=dev) * (2 * r) - r
    if world["hi"][2] <= world["lo"][2]:
        new[:, 2] = 0.0
    return redraw, new


def draw_acc(prev: dict, sim: dict, world: dict,
             gen: torch.Generator) -> torch.Tensor:
    """Every object's acceleration after one step from `prev`, drawn from
    `gen`."""
    redraw, new = draws(prev["pos"].shape[0], sim, world, gen)
    return torch.where(redraw, new, prev["acc"])


def judge(prev: dict, got: dict, acc: torch.Tensor, sim: dict,
          world: dict) -> dict:
    """The number by which the state `got` after one step from `prev` is
    judged, `integ_err`: the largest gap of position (m), velocity (m/s),
    acceleration (m/s^2) or heading (rad, wrapped) between `got` and the
    reference's step from `prev` with the accelerations `acc` (draw_acc's,
    from the generator the program drew from). An object whose size, type,
    liveness or id changed makes it infinite."""
    want = advance(prev, acc, sim, world)
    gap = lambda a, b: float((a - b).abs().max()) if a.numel() else 0.0
    dh = torch.remainder(got["heading"] - want["heading"] + math.pi,
                         2 * math.pi) - math.pi
    err = max(gap(got["pos"], want["pos"]), gap(got["vel"], want["vel"]),
              gap(got["acc"], want["acc"]),
              float(dh.abs().max()) if dh.numel() else 0.0)
    for name in ("size", "otype", "alive", "oid"):
        if not torch.equal(got[name], prev[name]):
            err = math.inf
    return dict(integ_err=err)
