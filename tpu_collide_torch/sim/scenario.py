"""Device-side movement modes (the port of tpu_collide/sim/scenario.py): the
VehicleSimulator's scenario semantics (sim/traffic.py) as tensor ops, so that
road-constrained and destination-oriented fleets step on the device.

  * the TrafficMap compiles to tables of tensors (RoadTable, CityTable),
    gathered per object in every step;
  * the per-object scenario state (mode, current road, destination) is a
    ScenarioState beside the ObjectState;
  * `scenario_integrate` computes all three mode updates for every object
    and selects per object by its mode code;
  * `make_scenario_step` ends in the engine's detection and alert tail
    (engine.detect_and_alerts, or detect_and_alerts_fused and its CUDA
    kernel), so a scenario step takes the same hot path as make_step.

Semantics, op order and the JAX package's deviations from the host
simulator are kept: random = acceleration jitter and a soft 0.5 bounce;
road = project, advance, switch at the segment's end (the next road a pick
among the first _MAX_CONN connections); destination = steer at 2 m/s^2,
arrive within 20 m, retarget 70% near a city. The draws come from a
`torch.Generator` (see `scenario_draws` for their order), so they differ
from the JAX package's counter-based ones; `draws` injects any.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import check_on, resolve_device
from tpu_collide_torch.core.state import ObjectState, state_from_numpy
from tpu_collide_torch.sim.traffic import TrafficMap, VehicleSimulator

MODE_RANDOM, MODE_ROAD, MODE_DEST = 0, 1, 2
_MODE_CODES = {"random": MODE_RANDOM, "road_constrained": MODE_ROAD,
               "destination_oriented": MODE_DEST}
_MAX_CONN = 4     # connection slots per road (grid maps have <= 4)


class _Tensors:
    """replace() and the device of a frozen dataclass of tensors."""

    @property
    def device(self) -> torch.device:
        return getattr(self, dataclasses.fields(self)[0].name).device

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RoadTable(_Tensors):
    """The road network as tensors. conn[R, _MAX_CONN] lists connected road
    indices (-1 padding); n_conn[R] counts them."""
    start: torch.Tensor    # [R, 2] f32
    dirn: torch.Tensor     # [R, 2] f32 unit direction
    length: torch.Tensor   # [R] f32
    speed: torch.Tensor    # [R] f32 speed limit
    conn: torch.Tensor     # [R, _MAX_CONN] int32
    n_conn: torch.Tensor   # [R] int32


@dataclasses.dataclass(frozen=True)
class CityTable(_Tensors):
    center: torch.Tensor   # [C, 2] f32
    radius: torch.Tensor   # [C] f32


@dataclasses.dataclass(frozen=True)
class ScenarioState(_Tensors):
    mode: torch.Tensor       # [N] int32 MODE_*
    road: torch.Tensor       # [N] int32 current road (-1 = none)
    target: torch.Tensor     # [N, 2] f32 destination
    target_ok: torch.Tensor  # [N] bool target valid


def build_road_table(tmap: TrafficMap, device=None
                     ) -> Tuple[RoadTable, dict]:
    """The TrafficMap's roads as tensors on `device` (the card unless another
    is named), and {road id: index}. Roads are indexed in sorted id order;
    connections keep only roads that exist (the grid generator links a
    phantom edge road), the first _MAX_CONN of them in sorted id order."""
    device = resolve_device(device)
    rids = sorted(tmap.roads)
    idx = {rid: i for i, rid in enumerate(rids)}
    r = max(len(rids), 1)
    start = np.zeros((r, 2), np.float32)
    dirn = np.zeros((r, 2), np.float32)
    dirn[:, 0] = 1.0
    length = np.ones(r, np.float32)
    speed = np.full(r, 13.9, np.float32)
    conn = np.full((r, _MAX_CONN), -1, np.int32)
    n_conn = np.zeros(r, np.int32)
    for rid in rids:
        i = idx[rid]
        road = tmap.roads[rid]
        start[i] = (road.start.x, road.start.y)
        dirn[i] = road.direction()
        length[i] = max(road.length, 0.1)
        speed[i] = road.speed_limit
        cs = [idx[c] for c in sorted(set(tmap.road_connections.get(rid, [])))
              if c in idx][:_MAX_CONN]
        conn[i, :len(cs)] = cs
        n_conn[i] = len(cs)
    on = lambda a: torch.from_numpy(a).to(device)
    return RoadTable(on(start), on(dirn), on(length), on(speed), on(conn),
                     on(n_conn)), idx


def build_city_table(tmap: TrafficMap, device=None) -> CityTable:
    """The TrafficMap's cities (sorted by id) as tensors on `device`; a map
    without cities gets one city of radius 0 at the origin."""
    device = resolve_device(device)
    cs = sorted(tmap.cities)
    if not cs:
        center = np.zeros((1, 2), np.float32)
        radius = np.zeros(1, np.float32)
    else:
        center = np.array([(tmap.cities[c].center.x,
                            tmap.cities[c].center.y) for c in cs], np.float32)
        radius = np.array([tmap.cities[c].radius for c in cs], np.float32)
    return CityTable(torch.from_numpy(center).to(device),
                     torch.from_numpy(radius).to(device))


def init_scenario(n: int, mode: str = "road_constrained",
                  roads: Optional[RoadTable] = None,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> ScenarioState:
    """A fresh scenario state on `device` (the card unless another is
    named): every object in `mode`; road mode draws each object's road
    uniformly from the generator."""
    device = resolve_device(device)
    code = _MODE_CODES[mode]
    road = torch.full((n,), -1, dtype=torch.int32, device=device)
    if code == MODE_ROAD:
        if roads is None or generator is None:
            raise ValueError("road mode needs roads and a generator")
        road = torch.randint(0, roads.length.shape[0], (n,),
                             generator=generator, device=device,
                             dtype=torch.int32)
    return ScenarioState(
        mode=torch.full((n,), code, dtype=torch.int32, device=device),
        road=road,
        target=torch.zeros((n, 2), dtype=torch.float32, device=device),
        target_ok=torch.zeros((n,), dtype=torch.bool, device=device))


def scenario_from_simulator(sim: VehicleSimulator, road_idx: dict,
                            order=None, device=None
                            ) -> Tuple[ObjectState, ScenarioState]:
    """A host VehicleSimulator's fleet and scenario bookkeeping as device
    state on `device` (the card unless another is named), rows in `order`
    (sorted vehicle ids by default)."""
    device = resolve_device(device)
    vids = order or sorted(sim.vehicles)
    n = len(vids)
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    acc = np.zeros((n, 3), np.float32)
    heading = np.zeros(n, np.float32)
    size = np.zeros(n, np.float32)
    mode = np.zeros(n, np.int32)
    road = np.full(n, -1, np.int32)
    target = np.zeros((n, 2), np.float32)
    target_ok = np.zeros(n, bool)
    for i, vid in enumerate(vids):
        v = sim.vehicles[vid]
        pos[i] = (v.position.x, v.position.y, 0.0)
        vel[i] = (v.velocity.x, v.velocity.y, 0.0)
        acc[i] = (v.acceleration.x, v.acceleration.y, 0.0)
        heading[i] = v.heading
        size[i] = v.size
        mode[i] = _MODE_CODES[sim.vehicle_modes.get(vid, "random")]
        rid = sim.vehicle_roads.get(vid)
        if rid in road_idx:
            road[i] = road_idx[rid]
        t = sim.vehicle_targets.get(vid)
        if t is not None:
            target[i] = (t.x, t.y)
            target_ok[i] = True
    state = state_from_numpy(pos, vel, acc, heading, size,
                             np.zeros(n, np.int32), device=device)
    on = lambda a: torch.from_numpy(a).to(device)
    return state, ScenarioState(mode=on(mode), road=on(road),
                                target=on(target), target_ok=on(target_ok))


def scenario_draws(n: int, n_cities: int, cfg: SystemConfig,
                   generator: torch.Generator | None, device
                   ) -> Tuple[torch.Tensor, ...]:
    """The ten [N] draws of one scenario step, in the order of the JAX
    package's keys ks[0..9] and taken from the generator in that order:
    0 jitter draw U[0,1), 1 jitter value x and 2 jitter value y
    U[-accel_range, accel_range), 3 connection pick in [0, _MAX_CONN),
    4 city-or-uniform draw U[0,1), 5 city index in [0, n_cities), 6 radius
    fraction, 7 angle fraction, 8 uniform target x and 9 y fraction, all
    U[0,1)."""
    r = cfg.sim.accel_range
    u = lambda: torch.rand((n,), generator=generator, device=device)
    ints = lambda hi: torch.randint(0, hi, (n,), generator=generator,
                                    device=device, dtype=torch.int32)
    acc = lambda: u() * (2.0 * r) - r
    # a tuple's items are evaluated, and so drawn, left to right
    return (u(), acc(), acc(), ints(_MAX_CONN), u(), ints(n_cities), u(), u(),
            u(), u())


def _cap(vx, vy, limit):
    """The speed cap: (vx, vy) scaled down to `limit` ([N])."""
    sp = torch.sqrt(vx * vx + vy * vy)
    sc = torch.where(sp > limit, limit / torch.clamp_min(sp, 1e-9), 1.0)
    return vx * sc, vy * sc, torch.minimum(sp, limit)


def scenario_integrate(state: ObjectState, scen: ScenarioState,
                       generator: torch.Generator | None, cfg: SystemConfig,
                       roads: RoadTable, cities: CityTable,
                       draws: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[ObjectState, ScenarioState]:
    """One physics step under per-object movement modes (2D scenarios).
    `draws`, when given, replaces the generator's ten draws (the order of
    `scenario_draws`). Dead objects stay frozen; road, target and target_ok
    change only for alive objects of their mode."""
    sim = cfg.sim
    dt = sim.dt
    dev = state.device
    n = state.n
    lo_x, lo_y = cfg.world.lo[0], cfg.world.lo[1]
    hi_x, hi_y = cfg.world.hi[0], cfg.world.hi[1]
    w, h = hi_x - lo_x, hi_y - lo_y
    # the constant speed limit as a tensor, so that it divides exactly
    # (a Python float divided by a tensor is a reciprocal multiply) without
    # a host-to-device copy
    max_speed = torch.full_like(state.heading, sim.max_speed)
    px, py = state.pos[:, 0], state.pos[:, 1]
    vx, vy = state.vel[:, 0], state.vel[:, 1]
    ax, ay = state.acc[:, 0], state.acc[:, 1]

    if draws is None:
        draws = scenario_draws(n, cities.radius.shape[0], cfg, generator,
                               dev)
    (jit_draw, jit_val, jy, pick, city_draw, ci, rr_draw, th_draw, ux_draw,
     uy_draw) = draws
    jitter = jit_draw < sim.accel_change_prob

    # ---- mode 0: random (soft 0.5 bounce) ----
    r_ax = torch.where(jitter, jit_val, ax)
    r_ay = torch.where(jitter, jy, ay)
    r_vx, r_vy = vx + r_ax * dt, vy + r_ay * dt
    r_vx, r_vy, r_sp = _cap(r_vx, r_vy, max_speed)
    r_px, r_py = px + r_vx * dt, py + r_vy * dt
    r_head = torch.where(r_sp > sim.min_heading_speed,
                         torch.atan2(r_vy, r_vx), state.heading)
    out_x = (r_px < lo_x) | (r_px > hi_x)
    out_y = (r_py < lo_y) | (r_py > hi_y)
    r_vx = torch.where(out_x, -r_vx * 0.5, r_vx)
    r_vy = torch.where(out_y, -r_vy * 0.5, r_vy)
    r_px = torch.clamp(r_px, lo_x, hi_x)
    r_py = torch.clamp(r_py, lo_y, hi_y)

    # ---- mode 1: road-constrained ----
    n_roads = roads.length.shape[0]
    # clipped so that a roadless object (-1) gathers in bounds; on_road
    # throws its result away
    rid = torch.clamp(scen.road, 0, n_roads - 1).long()
    on_road = scen.road >= 0
    sx, sy = roads.start[rid, 0], roads.start[rid, 1]
    dx, dy = roads.dirn[rid, 0], roads.dirn[rid, 1]
    rlen = roads.length[rid]
    rlim = roads.speed[rid]
    along = (px - sx) * dx + (py - sy) * dy
    at_end = along >= rlen
    at_start = along < 0.0

    # next road: the pick among this road's connections
    n_conn = roads.n_conn[rid]
    pick = torch.minimum(pick, torch.clamp_min(n_conn - 1, 0)).long()
    nxt = roads.conn[rid, pick]
    has_next = (n_conn > 0) & (nxt >= 0)
    nclip = torch.clamp(nxt, 0, n_roads - 1).long()
    speed_now = torch.sqrt(vx * vx + vy * vy)
    nx_dx, nx_dy = roads.dirn[nclip, 0], roads.dirn[nclip, 1]

    # in-segment advance
    a_mag = torch.where(jitter, jit_val, ax * dx + ay * dy)
    g_ax, g_ay = a_mag * dx, a_mag * dy
    g_vx, g_vy = vx + g_ax * dt, vy + g_ay * dt
    g_vx, g_vy, g_sp = _cap(g_vx, g_vy, rlim)
    wrong_way = g_vx * dx + g_vy * dy < 0.0
    g_vx = torch.where(wrong_way, g_sp * dx, g_vx)
    g_vy = torch.where(wrong_way, g_sp * dy, g_vy)
    # advance, then project back onto the road's line
    g_along = (px + g_vx * dt - sx) * dx + (py + g_vy * dt - sy) * dy
    g_px = sx + g_along * dx
    g_py = sy + g_along * dy

    # the three road sub-cases: at the end, before the start, inside
    ends = at_end | at_start
    d_px = torch.where(at_end, torch.where(has_next, roads.start[nclip, 0],
                                           sx + rlen * dx),
                       torch.where(at_start, sx, g_px))
    d_py = torch.where(at_end, torch.where(has_next, roads.start[nclip, 1],
                                           sy + rlen * dy),
                       torch.where(at_start, sy, g_py))
    d_vx = torch.where(at_end, torch.where(has_next, speed_now * nx_dx, -vx),
                       torch.where(at_start, -vx, g_vx))
    d_vy = torch.where(at_end, torch.where(has_next, speed_now * nx_dy, -vy),
                       torch.where(at_start, -vy, g_vy))
    d_ax = torch.where(ends, ax, g_ax)
    d_ay = torch.where(ends, ay, g_ay)
    d_rid = torch.where(at_end & has_next, nxt, scen.road)
    d_head = torch.atan2(d_vy, d_vx)
    # a roadless object moves as in mode 0 (the host falls back to random)
    rd_px = torch.where(on_road, d_px, r_px)
    rd_py = torch.where(on_road, d_py, r_py)
    rd_vx = torch.where(on_road, d_vx, r_vx)
    rd_vy = torch.where(on_road, d_vy, r_vy)
    rd_ax = torch.where(on_road, d_ax, r_ax)
    rd_ay = torch.where(on_road, d_ay, r_ay)
    rd_head = torch.where(on_road, d_head, r_head)

    # ---- mode 2: destination-oriented ----
    # (re)target: 70% near a city, else uniform over the world
    want_city = city_draw < 0.7
    ci = ci.long()
    rr = rr_draw * cities.radius[ci]
    th = th_draw * (2.0 * math.pi)
    city_tx = cities.center[ci, 0] + rr * torch.cos(th)
    city_ty = cities.center[ci, 1] + rr * torch.sin(th)
    unif_tx = lo_x + ux_draw * w
    unif_ty = lo_y + uy_draw * h
    new_tx = torch.where(want_city, city_tx, unif_tx)
    new_ty = torch.where(want_city, city_ty, unif_ty)
    tx = torch.where(scen.target_ok, scen.target[:, 0], new_tx)
    ty = torch.where(scen.target_ok, scen.target[:, 1], new_ty)
    ddx, ddy = tx - px, ty - py
    dist = torch.sqrt(ddx * ddx + ddy * ddy)
    arrived = dist < 20.0
    ux = ddx / torch.clamp_min(dist, 1e-6)
    uy = ddy / torch.clamp_min(dist, 1e-6)
    t_ax, t_ay = ux * 2.0, uy * 2.0
    t_vx, t_vy = vx + t_ax * dt, vy + t_ay * dt
    t_vx, t_vy, _ = _cap(t_vx, t_vy, max_speed)
    t_px = torch.clamp(px + t_vx * dt, lo_x, hi_x)
    t_py = torch.clamp(py + t_vy * dt, lo_y, hi_y)
    t_head = torch.atan2(t_vy, t_vx)
    # on arrival the host drops the target and skips this step's physics
    t_px = torch.where(arrived, px, t_px)
    t_py = torch.where(arrived, py, t_py)
    t_vx = torch.where(arrived, vx, t_vx)
    t_vy = torch.where(arrived, vy, t_vy)
    t_ax = torch.where(arrived, ax, t_ax)
    t_ay = torch.where(arrived, ay, t_ay)
    t_head = torch.where(arrived, state.heading, t_head)

    # ---- select by mode ----
    m = scen.mode
    is_road, is_dest = m == MODE_ROAD, m == MODE_DEST

    def sel(r_, d_, t_):
        return torch.where(is_road, d_, torch.where(is_dest, t_, r_))

    alive = state.alive
    a1 = alive[:, None]
    new3 = lambda old, x, y: torch.where(
        a1, torch.stack([x, y, old[:, 2]], dim=1), old)
    pos = new3(state.pos, sel(r_px, rd_px, t_px), sel(r_py, rd_py, t_py))
    vel = new3(state.vel, sel(r_vx, rd_vx, t_vx), sel(r_vy, rd_vy, t_vy))
    acc = new3(state.acc, sel(r_ax, rd_ax, t_ax), sel(r_ay, rd_ay, t_ay))
    heading = torch.where(alive, sel(r_head, rd_head, t_head), state.heading)
    dest = alive & is_dest
    scen = scen.replace(
        road=torch.where(alive & is_road, d_rid, scen.road),
        target=torch.where(dest[:, None], torch.stack([tx, ty], dim=1),
                           scen.target),
        target_ok=torch.where(dest, ~arrived, scen.target_ok))
    return state.replace(pos=pos, vel=vel, acc=acc, heading=heading), scen


def make_scenario_step(cfg: SystemConfig, roads: RoadTable,
                       cities: CityTable, backend: str = "xla",
                       donate: bool = True, window_rows: int | None = None,
                       interpret: bool = False, device=None):
    """Returns fn(state, scen, generator, draws=None) -> (state, scen,
    StepOutput): scenario_integrate, then the engine's detection and alert
    tail (backend 'xla': detect_and_alerts; 'fused': detect_and_alerts_fused,
    which launches the CUDA detection kernel on the card). The state, the
    scenario state and the tables must lie on `device`, the card unless
    another is named. `donate`, `window_rows` and `interpret` are accepted
    for the JAX package's signature and ignored, as in make_step."""
    from tpu_collide_torch.engine import (detect_and_alerts,
                                          detect_and_alerts_fused)
    if backend not in ("xla", "fused"):
        raise ValueError(f"unknown backend {backend!r}")
    detect = detect_and_alerts_fused if backend == "fused" \
        else detect_and_alerts
    dev = resolve_device(device)
    check_on(roads, dev, "scenario step")
    check_on(cities, dev, "scenario step")

    def fn(state: ObjectState, scen: ScenarioState,
           generator: torch.Generator | None, draws=None):
        check_on(state, dev, "scenario step")
        check_on(scen, dev, "scenario step")
        state, scen = scenario_integrate(state, scen, generator, cfg, roads,
                                         cities, draws)
        return state, scen, detect(state, cfg)

    return fn
