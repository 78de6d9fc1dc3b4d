"""Fleet generators, built on the device (the port of
tpu_collide/sim/generator.py).

The reference's distribution: 4 vehicle types of sizes {2, 4, 5, 1} m; with
'city_skew', 80% of objects in 5 cities (4 of radius 1000 m at the quarter
points, 1 of radius 2000 m at the centre) and 20% uniform; initial speed
U(5, 20) at heading U(0, 2 pi); zero initial acceleration. The draws come
from a `torch.Generator`, so fleets are reproducible per seed but differ
from the JAX package's.
"""
from __future__ import annotations

import math

import torch

from tpu_collide_torch.core.config import SystemConfig, VEHICLE_SIZES
from tpu_collide_torch.core.device import resolve_device
from tpu_collide_torch.core.state import ObjectState


def default_cities(cfg: SystemConfig, device=None) -> torch.Tensor:
    """[(x, y, radius)] of the reference's five cities, on the card unless
    `device` names another."""
    device = resolve_device(device)
    w = cfg.world.hi[0] - cfg.world.lo[0]
    h = cfg.world.hi[1] - cfg.world.lo[1]
    x0, y0 = cfg.world.lo[0], cfg.world.lo[1]
    return torch.tensor([
        (x0 + w * 0.25, y0 + h * 0.25, 1000.0),
        (x0 + w * 0.75, y0 + h * 0.25, 1000.0),
        (x0 + w * 0.25, y0 + h * 0.75, 1000.0),
        (x0 + w * 0.75, y0 + h * 0.75, 1000.0),
        (x0 + w * 0.50, y0 + h * 0.50, 2000.0),
    ], dtype=torch.float32, device=device)


def generate_fleet(generator: torch.Generator, cfg: SystemConfig,
                   distribution: str = "city_skew", device=None,
                   cities: torch.Tensor | None = None) -> ObjectState:
    """distribution: 'city_skew' (the reference's default, 80/20) or
    'uniform'. `device` defaults to the generator's device."""
    if distribution not in ("city_skew", "uniform"):
        raise ValueError(f"unknown distribution {distribution!r}")
    dev = generator.device if device is None else torch.device(device)
    n = cfg.num_objects
    sim = cfg.sim
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    lo = torch.tensor(cfg.world.lo, dtype=torch.float32, device=dev)
    hi = torch.tensor(cfg.world.hi, dtype=torch.float32, device=dev)

    pos = lo + rand(n, 3) * (torch.maximum(hi, lo + 1e-6) - lo)
    if not cfg.world.is_3d:
        pos[:, 2] = 0.0
    if distribution == "city_skew":
        if cities is None:
            cities = default_cities(cfg, dev)
        c = cities[torch.randint(0, cities.shape[0], (n,),
                                 generator=generator, device=dev)]
        # r = U(0,1) * radius, theta = U(0, 2pi): the reference's
        # (non-area-uniform) disk sampling
        r = rand(n) * c[:, 2]
        theta = rand(n) * (2.0 * math.pi)
        cpos = torch.stack([c[:, 0] + r * torch.cos(theta),
                            c[:, 1] + r * torch.sin(theta),
                            torch.zeros_like(r)], dim=-1)
        in_city = rand(n, 1) < sim.city_fraction
        pos = torch.clamp(torch.where(in_city, cpos, pos), lo, hi)

    speed = sim.speed_min + rand(n) * (sim.speed_max - sim.speed_min)
    heading = rand(n) * (2.0 * math.pi)
    vel = torch.stack([speed * torch.cos(heading), speed * torch.sin(heading),
                       torch.zeros_like(speed)], dim=-1)
    otype = torch.randint(0, len(VEHICLE_SIZES), (n,), generator=generator,
                          device=dev, dtype=torch.int32)
    size = torch.tensor(VEHICLE_SIZES, dtype=torch.float32,
                        device=dev)[otype.long()]
    return ObjectState(
        pos=pos.contiguous(), vel=vel.contiguous(),
        acc=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        heading=heading, size=size, otype=otype,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        oid=torch.arange(n, dtype=torch.int32, device=dev),
    )
