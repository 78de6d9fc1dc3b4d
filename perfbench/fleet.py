"""The inputs of a run, made from its seed: the fleet (on the device, in a
few large draws) and the location reports of the serve loop (host numpy).

The fleet follows the upstream's VehicleSimulator distribution as the
traffic file's "fleet" entry states it: positions uniform in the world, or
with a share in cities (radius drawn uniformly, so density peaks at a
city's centre); speed U(speed_min, speed_max) at a heading U(0, 2 pi) in
the horizontal plane; zero acceleration; vehicle types drawn uniformly
with sizes from the configuration file's "vehicle_sizes".
"""
from __future__ import annotations

import math

import numpy as np
import torch

FIELDS = ("pos", "vel", "acc", "heading", "size", "otype", "alive", "oid")

# sub-streams of one run's seed
FLEET_STREAM, REPORT_STREAM, SAMPLE_STREAM, STEP_STREAM = 1, 2, 3, 5


def make_fleet(system: dict, sizes, spec: dict, seed: int,
               device) -> dict:
    """{field: tensor} of a fleet of system["num_objects"] objects."""
    n = system["num_objects"]
    lo = torch.tensor(system["world"]["lo"], dtype=torch.float32,
                      device=device)
    hi = torch.tensor(system["world"]["hi"], dtype=torch.float32,
                      device=device)
    is3d = system["world"]["hi"][2] > system["world"]["lo"][2]
    gen = torch.Generator(device=device).manual_seed(
        seed * 16 + FLEET_STREAM)
    u = torch.rand((n, 8), generator=gen, device=device)
    pos = lo + u[:, 0:3] * (hi - lo)
    if not is3d:
        pos[:, 2] = lo[2]
    cities = spec.get("cities") or []
    if cities:
        ext = hi - lo
        c = torch.tensor([[lo[0] + fx * ext[0], lo[1] + fy * ext[1], r]
                          for fx, fy, r in cities], dtype=torch.float32,
                         device=device)
        pick = c[torch.randint(0, len(cities), (n,), generator=gen,
                               device=device)]
        r = u[:, 3] * pick[:, 2]
        theta = u[:, 4] * (2.0 * math.pi)
        in_city = u[:, 5] < spec["city_fraction"]
        cx = torch.clamp(pick[:, 0] + r * torch.cos(theta), lo[0], hi[0])
        cy = torch.clamp(pick[:, 1] + r * torch.sin(theta), lo[1], hi[1])
        pos[:, 0] = torch.where(in_city, cx, pos[:, 0])
        pos[:, 1] = torch.where(in_city, cy, pos[:, 1])
    smin, smax = spec["speed"]
    speed = smin + u[:, 6] * (smax - smin)
    heading = u[:, 7] * (2.0 * math.pi)
    vel = torch.stack([speed * torch.cos(heading),
                       speed * torch.sin(heading),
                       torch.zeros_like(speed)], dim=1)
    otype = torch.randint(0, len(sizes), (n,), generator=gen,
                          device=device, dtype=torch.int32)
    size = torch.tensor(sizes, dtype=torch.float32,
                        device=device)[otype.long()]
    return dict(pos=pos.contiguous(), vel=vel,
                acc=torch.zeros((n, 3), dtype=torch.float32, device=device),
                heading=heading, size=size, otype=otype,
                alive=torch.ones((n,), dtype=torch.bool, device=device),
                oid=torch.arange(n, dtype=torch.int32, device=device))


def make_reports(system: dict, spec: dict, ticks: int, seed: int) -> dict:
    """The location reports of `ticks` ticks: spec["per_tick"] distinct
    vehicles a tick drawn uniformly from the fleet, each reporting a
    position uniform in the world and a speed U(speed) at a heading
    U(0, 2 pi) with zero acceleration. {"slot": [T, R] int64, "pos",
    "vel": [T, R, 3] float64, "heading": [T, R] float64}."""
    rng = np.random.default_rng([seed, REPORT_STREAM])
    n, r = system["num_objects"], spec["per_tick"]
    lo = np.asarray(system["world"]["lo"], np.float64)
    hi = np.asarray(system["world"]["hi"], np.float64)
    slot = np.stack([rng.choice(n, r, replace=False) for _ in range(ticks)])
    pos = lo + rng.random((ticks, r, 3)) * (hi - lo)
    smin, smax = spec["speed"]
    speed = smin + rng.random((ticks, r)) * (smax - smin)
    heading = rng.random((ticks, r)) * (2.0 * math.pi)
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading),
                    np.zeros_like(speed)], axis=-1)
    return dict(slot=slot.astype(np.int64), pos=pos, vel=vel,
                heading=heading)
