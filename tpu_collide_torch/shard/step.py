"""The sharded step (the port of tpu_collide/shard/step.py).

The fleet is split into geographic slabs (1D), tiles (2D) or boxes (3D),
one per shard of a `Mesh` (shard/collective.py). One step runs, over every
shard:

    integrate -> migrate (x, then y, then z) -> halo (x, then y on the
    x-extended state, then z) -> detection of owned + halo rows -> the
    counters reduced over the mesh

with the detection tail of either backend: 'xla' (the reference-shaped
grid path, alerts of owned rows only by query_mask) or 'fused' (a cell list
of owned rows and marked halo mirrors per shard, one launch of the fused
detection kernel per shard, the refine tail masking by `cl.own`).

A sharded state is a tuple of per-shard states, each `shard_slots(cfg)`
slots long, on its shard's device. Step outputs keep the JAX package's
meaning: the alert buffers of the shards concatenated to [D * A] with
`count` [D], the scalar counters summed (max_risk: the largest) over the
mesh, `dropped` [D] int32 (migration and halo drops of each shard); all on
the first shard's device. Each shard draws from its own torch.Generator
(`shard_generators`), where the JAX package folds the shard index into the
key; `draws=` injects per-shard draws instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_collide_torch.alerts.extract import AlertBatch, extract_alerts
from tpu_collide_torch.core.config import SystemConfig
from tpu_collide_torch.core.device import resolve_device
from tpu_collide_torch.core.state import FIELDS, ObjectState
from tpu_collide_torch.detect.pipeline import detect_pairs
from tpu_collide_torch.detect.predict import TrajectoryHistory
from tpu_collide_torch.engine import StepOutput, grid_overflow
from tpu_collide_torch.index.grid import build_grid
from tpu_collide_torch.kernels.cell_list import build_cell_list
from tpu_collide_torch.kernels.refine import (fused_scene_fast,
                                              fused_scene_precise)
from tpu_collide_torch.shard.collective import Mesh, pmax, psum
from tpu_collide_torch.shard.halo import (axis_shards, extend_with_halo,
                                          halo_exchange_hops, migrate)
from tpu_collide_torch.sim.integrator import integrate
from tpu_collide_torch.sim.scenario import ScenarioState, scenario_integrate

INT32_MAX = 2 ** 31 - 1


def shard_slots(cfg: SystemConfig) -> int:
    """Per-shard slot capacity: even split x headroom, padded to 8."""
    d = cfg.shard.total_shards
    base = -(-cfg.num_objects // d)
    slots = int(base * cfg.shard.slot_headroom)
    return -(-slots // 8) * 8


def make_mesh(cfg: SystemConfig, devices=None, device=None) -> Mesh:
    """The mesh of cfg.shard: x slabs, an (x, y) grid when num_shards_y > 1
    or an (x, y, z) grid when num_shards_z > 1; shard (i, j, k) owns the
    box between walls i, j, k and i+1, j+1, k+1. `devices` names one device
    per shard in x-major order; by default every shard lies on `device`
    (the card unless another is named). Refuses a halo narrower than the
    search radius and slabs an object could cross in one step."""
    sh = cfg.shard
    dx, dy, dz = sh.num_shards, sh.num_shards_y, sh.num_shards_z
    d = dx * dy * dz
    if devices is None:
        devices = (resolve_device(device),) * d
    devices = tuple(resolve_device(v) for v in devices)
    if len(devices) != d:
        raise ValueError(f"need {d} devices, have {len(devices)}")
    if sh.halo_width < cfg.detect.search_radius:
        raise ValueError("halo must cover the detection search radius")
    step_reach = cfg.sim.max_speed * cfg.sim.dt
    for dim, (name, n) in enumerate((("x", dx), ("y", dy), ("z", dz))):
        extent = cfg.world.hi[dim] - cfg.world.lo[dim]
        if (dim == 0 or n > 1) and step_reach >= extent / n:
            raise ValueError(f"objects could cross more than one "
                             f"{name}-slab per step")
    names, shape = [sh.axis_name], [dx]
    if dy > 1 or dz > 1:
        names.append(sh.axis_name_y)
        shape.append(dy)
    if dz > 1:
        names.append(sh.axis_name_z)
        shape.append(dz)
    return Mesh(tuple(shape), tuple(names), devices)


def shard_generators(mesh: Mesh, seed: int) -> tuple:
    """One torch.Generator per shard, on its device, seeded from
    numpy's SeedSequence(seed) spawned once per shard."""
    seqs = np.random.SeedSequence(seed).spawn(mesh.size)
    return tuple(
        torch.Generator(device=dev).manual_seed(
            int(ss.generate_state(1, np.uint64)[0]))
        for ss, dev in zip(seqs, mesh.devices))


def equal_boundaries(cfg: SystemConfig, dim: int = 0,
                     device=None) -> torch.Tensor:
    """The default [D+1] slab walls along world axis `dim`: equal slabs,
    computed in f64 and rounded to f32 as the JAX package does, on `device`
    (the card unless another is named)."""
    d, _ = axis_shards(cfg, dim)
    return torch.tensor(np.linspace(cfg.world.lo[dim], cfg.world.hi[dim],
                                    d + 1), dtype=torch.float32,
                        device=resolve_device(device))


def check_boundaries(cfg: SystemConfig, boundaries, dim: int = 0) -> None:
    """Host-side validity check of dynamic slab walls along world axis
    `dim`: monotone, pinned to the world's bounds, and wide enough that the
    halo covers the search radius and no object crosses more than one slab
    per step. Raises ValueError."""
    b = torch.as_tensor(boundaries).cpu().numpy()
    d, _ = axis_shards(cfg, dim)
    if b.shape != (d + 1,):
        raise ValueError(f"axis-{dim} walls of shape {b.shape}, want "
                         f"({d + 1},)")
    if abs(b[0] - cfg.world.lo[dim]) >= 1e-3 \
            or abs(b[-1] - cfg.world.hi[dim]) >= 1e-3:
        raise ValueError(f"axis-{dim} walls do not end at the world's bounds")
    min_w = float(np.diff(b).min())
    need = max(cfg.shard.halo_width, cfg.sim.max_speed * cfg.sim.dt)
    if min_w < need:
        raise ValueError(f"axis-{dim} slab width {min_w:.1f} < required "
                         f"{need:.1f} (halo_width / max_speed*dt)")


def _shard_of(pos, cfg: SystemConfig, boundaries=None, boundaries_y=None,
              boundaries_z=None) -> np.ndarray:
    """[N] linear shard index ((ix * Dy + iy) * Dz + iz) of each position
    (host-side numpy)."""
    sh = cfg.shard

    def along(dim, d, b):
        if b is None:
            lo = cfg.world.lo[dim]
            w = (cfg.world.hi[dim] - cfg.world.lo[dim]) / d
            return np.clip(((pos[:, dim] - lo) // w).astype(int), 0, d - 1)
        b = torch.as_tensor(b).cpu().numpy()
        return np.clip(np.searchsorted(b, pos[:, dim], side="right") - 1,
                       0, d - 1)

    ix = along(0, sh.num_shards, boundaries)
    if sh.num_shards_y == 1 and sh.num_shards_z == 1:
        return ix
    lin = ix * sh.num_shards_y + along(1, sh.num_shards_y, boundaries_y)
    if sh.num_shards_z == 1:
        return lin
    return lin * sh.num_shards_z + along(2, sh.num_shards_z, boundaries_z)


def distribute_state(state_global: ObjectState, cfg: SystemConfig,
                     mesh: Mesh, boundaries=None, boundaries_y=None,
                     boundaries_z=None, extra=None):
    """Scatter a fleet into per-shard slots by slab / tile (equal walls, or
    the given ones): the JAX package's layout, each shard's objects in
    their fleet order in its first slots, dead slots with oid -1. Returns
    the tuple of per-shard states on the mesh's devices, and with `extra`
    (dict name -> [N, ...] array) also a tuple of per-shard dicts of it.
    Host-side numpy: bootstrap, not the hot path."""
    d = mesh.size
    slots = shard_slots(cfg)
    host = lambda v: torch.as_tensor(v).cpu().numpy()
    fields = {f: host(getattr(state_global, f)) for f in FIELDS}
    xfields = {f: host(v) for f, v in (extra or {}).items()}
    shard_of = _shard_of(fields["pos"], cfg, boundaries, boundaries_y,
                         boundaries_z)
    states, extras = [], []
    for sh in range(d):
        idx = np.flatnonzero((shard_of == sh) & fields["alive"])
        if len(idx) > slots:
            raise ValueError(
                f"shard {sh} overflow: {len(idx)} objects > {slots} slots; "
                f"raise ShardConfig.slot_headroom")
        dev = mesh.devices[sh]

        def fill(v, empty=0):
            out = np.full((slots,) + v.shape[1:], empty, v.dtype)
            out[:len(idx)] = v[idx]
            return torch.from_numpy(out).to(dev)

        states.append(ObjectState(**{
            f: fill(v, -1 if f == "oid" else 0) for f, v in fields.items()}))
        extras.append({f: fill(v) for f, v in xfields.items()})
    if extra is None:
        return tuple(states)
    return tuple(states), tuple(extras)


def collect_state(states, device=None):
    """The per-shard states (or scenario states, histories: any dataclass
    of tensors) concatenated in shard order into the JAX package's
    [D * slots] layout, on `device` (the first shard's when not named)."""
    first = getattr(states[0], dataclasses.fields(states[0])[0].name)
    dev = first.device if device is None else device
    return type(states[0])(**{
        f.name: torch.cat([getattr(s, f.name).to(dev) for s in states])
        for f in dataclasses.fields(states[0])})


# ---- one step over the mesh ------------------------------------------------

def _check_sharded(values, mesh: Mesh, what: str) -> None:
    if len(values) != mesh.size:
        raise ValueError(f"{what}: {len(values)} shards given, the mesh has "
                         f"{mesh.size}")
    for v, dev in zip(values, mesh.devices):
        first = getattr(v, dataclasses.fields(v)[0].name)
        if first.device != dev:
            raise ValueError(f"{what}: a shard lies on {first.device}, the "
                             f"mesh puts it on {dev}")


def _default_walls(cfg: SystemConfig, mesh: Mesh) -> tuple:
    """Equal x, y and z walls on the first shard's device."""
    return tuple(equal_boundaries(cfg, dim, mesh.devices[0])
                 for dim in range(3))


def _walls(mesh: Mesh, defaults: tuple, boundaries, boundaries_y,
           boundaries_z) -> tuple:
    """The x, y and z walls of a call (the defaults where None), f32 on the
    first shard's device; halo.py moves them to each shard's."""
    dev = mesh.devices[0]
    return tuple(
        dflt if b is None else torch.as_tensor(b, dtype=torch.float32).to(dev)
        for dflt, b in zip(defaults, (boundaries, boundaries_y,
                                      boundaries_z)))


def _phases(cfg: SystemConfig):
    """The world axes a step migrates and mirrors along, in order."""
    sh = cfg.shard
    return [0] + [dim for dim, n in ((1, sh.num_shards_y),
                                     (2, sh.num_shards_z)) if n > 1]


def _add(a, b) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def _migrate_phases(states, cfg: SystemConfig, mesh: Mesh, walls,
                    extras=None):
    """x-phase migration, then y and z on 2D / 3D grids (an object that
    crosses an edge or a corner reaches its diagonal neighbour in two or
    three hops). Returns (states, dropped) or (states, extras, dropped)."""
    dropped = None
    for dim in _phases(cfg):
        res = migrate(states, cfg, mesh, walls[dim], extras=extras, dim=dim)
        if extras is None:
            states, drop = res
        else:
            states, extras, drop = res
        dropped = drop if dropped is None else _add(dropped, drop)
    if extras is None:
        return states, dropped
    return states, extras, dropped


def _halo_extend(states, cfg: SystemConfig, mesh: Mesh, walls, mark: bool,
                 width: float | None = None, capacity: int | None = None,
                 hops=(1, 1, 1)):
    """Mirror x bands, then y bands of the x-extended states, then z bands
    of the xy-extended ones, so that edge and corner neighbourhoods arrive
    in at most three hops. width / capacity override the config's halo
    band (None: ShardConfig's); hops[dim] is the band's reach in slabs
    along world axis dim (halo_exchange_hops). Returns (extended states,
    dropped)."""
    ext, dropped = states, None
    for dim in _phases(cfg):
        halo = halo_exchange_hops(ext, cfg, mesh, walls[dim], dim=dim,
                                  width=width, capacity=capacity,
                                  hops=hops[dim])
        ext = tuple(extend_with_halo(st, buf, valid, mark_halo=mark)
                    for st, (buf, valid, _) in zip(ext, halo))
        drop = tuple(h[2] for h in halo)
        dropped = drop if dropped is None else _add(dropped, drop)
    return ext, dropped


def _reduce(mesh: Mesh, parts, count_checked: bool = True) -> StepOutput:
    """One StepOutput from the shards' (alerts, checked, risks, max_risk,
    alive, overflow, alert_overflow): alerts concatenated (count [D]), the
    counters reduced; on the first shard's device."""
    dev = mesh.devices[0]
    col = lambda j: [p[j] for p in parts]
    alerts = [p[0] for p in parts]
    batch = AlertBatch(**{
        f.name: (torch.stack if f.name == "count" else torch.cat)(
            [getattr(a, f.name).to(dev) for a in alerts])
        for f in dataclasses.fields(AlertBatch)})
    total = lambda j: psum(mesh, col(j))[0]
    checked = (total(1) if count_checked
               else torch.full((), -1, dtype=torch.int32, device=dev))
    return StepOutput(alerts=batch, num_pairs_checked=checked,
                      num_risks=total(2), max_risk=pmax(mesh, col(3))[0],
                      num_alive=total(4), overflow=total(5),
                      alert_overflow=total(6))


def _detect_tail_xla(states, cfg: SystemConfig, mesh: Mesh, walls):
    """Halo exchange, then the reference-shaped detection over owned + halo
    rows of each shard; alerts only for owned rows. Returns (StepOutput,
    per-shard halo drops)."""
    ext, halo_dropped = _halo_extend(states, cfg, mesh, walls, mark=False)
    parts = []
    for st, ex in zip(states, ext):
        index = build_grid(ex.pos, ex.alive, cfg)
        pairs = detect_pairs(ex, index, cfg)
        own = torch.arange(ex.n, device=ex.device) < st.n
        parts.append((
            extract_alerts(ex, pairs, cfg, query_mask=own),
            pairs.num_checked,
            (pairs.valid & own[:, None]).sum(dtype=torch.int32),
            pairs.risk.max(), st.alive.sum(dtype=torch.int32),
            grid_overflow(index, cfg).to(torch.int32),
            pairs.survivor_overflow))
    return _reduce(mesh, parts), halo_dropped


def _detect_tail_fused(states, cfg: SystemConfig, mesh: Mesh, walls):
    """Halo exchange with marked mirrors, then per shard one cell list, one
    launch of the fused detection kernel and the refine tail, which emits
    alerts and counts risks for owned rows only (cl.own) and reports
    decoded oids. Returns (StepOutput, per-shard halo drops)."""
    ext, halo_dropped = _halo_extend(states, cfg, mesh, walls, mark=True)
    scene_fn = (fused_scene_fast if cfg.detect.mode == "fast"
                else fused_scene_precise)
    parts = []
    for st, ex in zip(states, ext):
        cl = build_cell_list(ex, cfg)
        res = scene_fn(cl, cfg)
        parts.append((res.alerts, res.num_checked, res.num_risks,
                       res.max_risk, st.alive.sum(dtype=torch.int32),
                       cl.overflow, res.alert_overflow))
    return _reduce(mesh, parts, cfg.detect.count_checked), halo_dropped


_TAILS = {"xla": _detect_tail_xla, "fused": _detect_tail_fused}


def _tail(backend: str):
    if backend not in _TAILS:
        raise ValueError(f"unknown backend {backend!r}")
    return _TAILS[backend]


def _dropped(mesh: Mesh, *per_shard) -> torch.Tensor:
    """[D] int32 per-shard sums of drop counters, on the first shard's
    device."""
    dev = mesh.devices[0]
    return torch.stack([sum(x).to(dev) for x in zip(*per_shard)]).to(
        torch.int32)


def _hist_extra(hist: TrajectoryHistory) -> dict:
    """A trajectory history as migration `extra` fields: it travels with
    its object across walls."""
    return {"hpos": hist.pos, "ht": hist.t, "hcount": hist.count,
            "hhead": hist.head}


def _hist_from_extra(extra: dict) -> TrajectoryHistory:
    return TrajectoryHistory(pos=extra["hpos"], t=extra["ht"],
                             count=extra["hcount"], head=extra["hhead"])


def _fold_burst(outs, drops):
    """The last of a burst's outputs with overflow and alert_overflow
    replaced by the burst-wide max, the steps' [D] drops summed, and the
    per-step risks stacked to [n]."""
    out = outs[-1]
    of, ao = out.overflow, out.alert_overflow
    for o in outs[:-1]:
        of, ao = torch.maximum(of, o.overflow), torch.maximum(
            ao, o.alert_overflow)
    out = dataclasses.replace(out, overflow=of, alert_overflow=ao)
    return (out, torch.stack(drops).sum(dim=0).to(torch.int32),
            torch.stack([o.num_risks for o in outs]).to(torch.int32))


def make_sharded_step(cfg: SystemConfig, mesh: Mesh, donate: bool = True,
                      backend: str = "xla", interpret: bool = False,
                      window_rows: int | None = None,
                      with_history: bool = False,
                      burst_n: int | None = None):
    """The sharded step over `mesh`. backend 'xla' runs the reference-
    shaped detection per shard, 'fused' the cell list and the fused CUDA
    kernel per shard (both detection modes).

    Returns step(states, generators, boundaries=None, boundaries_y=None,
    boundaries_z=None, draws=None) -> (states, StepOutput, dropped [D]):
    `generators` holds one torch.Generator per shard (shard_generators);
    the walls are [Dx+1] / [Dy+1] / [Dz+1] f32 tensors (None: equal
    slabs); `draws`, one (redraw, new_acc) per shard, replaces the
    generators' physics draws (sim/integrator.integrate).

    with_history=True: step(states, hists, generators, ...) -> (states,
    hists, out, dropped); each object's TrajectoryHistory migrates with it.

    burst_n=n: n steps in one call, drawing from the generators in turn, so
    burst(n) computes the same states as n single steps. step(states[,
    hists], generators, walls...) -> (states[, hists], generators, out,
    dropped_total [D], risks_per_step [n]); out is the last step's with
    overflow / alert_overflow the burst-wide max; it refuses injected
    draws. `donate`, `interpret` and `window_rows` are accepted for the
    JAX package's signature and ignored."""
    del donate, interpret, window_rows
    tail = _tail(backend)
    defaults = _default_walls(cfg, mesh)

    def one(states, hists, gens, walls, draws):
        _check_sharded(states, mesh, "sharded step")
        if draws is None:
            draws = ((None, None),) * mesh.size
        states = tuple(integrate(st, cfg, g, *dr)
                       for st, g, dr in zip(states, gens, draws))
        if hists is None:
            states, mig = _migrate_phases(states, cfg, mesh, walls)
        else:
            _check_sharded(hists, mesh, "sharded step")
            states, extras, mig = _migrate_phases(
                states, cfg, mesh, walls,
                extras=tuple(_hist_extra(h) for h in hists))
            hists = tuple(_hist_from_extra(x) for x in extras)
        out, halo = tail(states, cfg, mesh, walls)
        return states, hists, out, _dropped(mesh, mig, halo)

    def run(states, hists, gens, walls, draws):
        if burst_n is None:
            states, hists, out, dropped = one(states, hists, gens, walls,
                                              draws)
            head = (states,) if hists is None else (states, hists)
            return head + (out, dropped)
        if draws is not None:
            raise ValueError("a burst draws from the generators; it takes "
                             "no injected draws")
        outs, drops = [], []
        for _ in range(int(burst_n)):
            states, hists, out, dropped = one(states, hists, gens, walls,
                                              None)
            outs.append(out)
            drops.append(dropped)
        head = (states,) if hists is None else (states, hists)
        return head + (gens,) + _fold_burst(outs, drops)

    if burst_n is not None and int(burst_n) < 1:
        raise ValueError(f"burst length must be >= 1, got {burst_n}")
    if with_history:
        def step_h(states, hists, generators, boundaries=None,
                   boundaries_y=None, boundaries_z=None, draws=None):
            return run(states, hists, generators,
                       _walls(mesh, defaults, boundaries, boundaries_y,
                              boundaries_z), draws)
        return step_h

    def step(states, generators, boundaries=None, boundaries_y=None,
             boundaries_z=None, draws=None):
        return run(states, None, generators,
                   _walls(mesh, defaults, boundaries, boundaries_y,
                          boundaries_z), draws)
    return step


def make_sharded_detect(cfg: SystemConfig, mesh: Mesh):
    """Detection without physics over the mesh (ingest -> detect): the halo
    exchange and the reference-shaped tail. Returns detect(states,
    boundaries=None, boundaries_y=None, boundaries_z=None) -> (StepOutput,
    dropped [D])."""
    defaults = _default_walls(cfg, mesh)

    def detect(states, boundaries=None, boundaries_y=None,
               boundaries_z=None):
        _check_sharded(states, mesh, "sharded detect")
        walls = _walls(mesh, defaults, boundaries, boundaries_y,
                       boundaries_z)
        out, halo = _detect_tail_xla(states, cfg, mesh, walls)
        return out, _dropped(mesh, halo)

    return detect


def make_sharded_scenario_step(cfg: SystemConfig, mesh: Mesh, roads,
                               cities, donate: bool = True,
                               backend: str = "xla", interpret: bool = False,
                               window_rows: int | None = None):
    """The sharded step with device movement modes (sim/scenario.py): each
    object's ScenarioState migrates with it; the road and city tables are
    copied to every shard's device. Returns step(states, scens, generators,
    boundaries=None, boundaries_y=None, boundaries_z=None, draws=None) ->
    (states, scens, StepOutput, dropped [D]); `draws` holds the ten draws
    of scenario_integrate per shard. `donate`, `interpret` and
    `window_rows` are accepted and ignored."""
    del donate, interpret, window_rows
    tail = _tail(backend)
    defaults = _default_walls(cfg, mesh)
    on = lambda x, dev: dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(dev) for f in dataclasses.fields(x)})
    tables = {dev: (on(roads, dev), on(cities, dev))
              for dev in set(mesh.devices)}
    names = [f.name for f in dataclasses.fields(ScenarioState)]

    def step(states, scens, generators, boundaries=None, boundaries_y=None,
             boundaries_z=None, draws=None):
        _check_sharded(states, mesh, "sharded scenario step")
        _check_sharded(scens, mesh, "sharded scenario step")
        walls = _walls(mesh, defaults, boundaries, boundaries_y,
                       boundaries_z)
        draws = draws or (None,) * mesh.size
        moved = [scenario_integrate(st, sc, g, cfg, *tables[dev], dr)
                 for st, sc, g, dr, dev in zip(states, scens, generators,
                                               draws, mesh.devices)]
        states, extras, mig = _migrate_phases(
            tuple(m[0] for m in moved), cfg, mesh, walls,
            extras=tuple({f: getattr(m[1], f) for f in names}
                         for m in moved))
        scens = tuple(ScenarioState(**x) for x in extras)
        out, halo = tail(states, cfg, mesh, walls)
        return states, scens, out, _dropped(mesh, mig, halo)

    return step


# ---- ingest ----------------------------------------------------------------

_UPD_FIELDS = ("pos", "vel", "acc", "heading", "size", "otype")


def _owner(walls: torch.Tensor, coord: torch.Tensor, d: int) -> torch.Tensor:
    return torch.clamp(torch.searchsorted(walls, coord.contiguous(),
                                          right=True) - 1, 0, d - 1)


def _apply_updates(state: ObjectState, upd: dict, walls, coords,
                   cfg: SystemConfig):
    """One shard's part of a sharded ingest: apply a replicated batch of
    location updates (sorted by oid, -1-padded) to whichever shard owns
    each update's position. Copies that stay here update in place, copies
    now owned elsewhere die here, new or arriving objects take free slots.
    Returns (state, dropped [] int32)."""
    b_oid = upd["oid"]
    bsz = b_oid.shape[0]
    n = state.n
    is_mine = torch.ones_like(b_oid, dtype=torch.bool)
    for dim in _phases(cfg):
        d, _ = axis_shards(cfg, dim)
        is_mine &= _owner(walls[dim], upd["pos"][:, dim], d) == coords[dim]
    mine = (b_oid >= 0) & is_mine

    # match local slots against the batch: the -1 padding sits at the
    # batch's tail, so it searches as INT32_MAX to keep the keys sorted
    b_key = torch.where(b_oid >= 0, b_oid, torch.full_like(b_oid, INT32_MAX))
    pos_in_b = torch.clamp(torch.searchsorted(b_key, state.oid), 0, bsz - 1)
    found = state.alive & (b_oid[pos_in_b] == state.oid)

    # 1) in-place update of slots whose object is in the batch and stays
    upd_here = found & is_mine[pos_in_b]
    new = {}
    for f in _UPD_FIELDS:
        cur = getattr(state, f)
        m = upd_here.reshape((-1,) + (1,) * (cur.dim() - 1))
        new[f] = torch.where(m, upd[f][pos_in_b], cur)
    # 2) kill copies that this ingest moved to another shard
    alive = state.alive & ~(found & ~is_mine[pos_in_b])
    state = state.replace(alive=alive, **new)

    # 3) insert what is owned here but in no local slot
    present = torch.zeros(bsz + 1, dtype=torch.bool, device=state.device)
    present[torch.where(found, pos_in_b, torch.full_like(pos_in_b, bsz))] = \
        True
    ins = mine & ~present[:bsz]
    rank = torch.cumsum(ins.to(torch.int32), 0) - 1
    free = torch.sort(state.alive.to(torch.int8), stable=True).indices[:bsz]
    n_free = (~state.alive).sum(dtype=torch.int32)
    can = ins & (rank < n_free) & (rank < bsz)
    slot = free[torch.clamp(rank, 0, free.numel() - 1).long()]
    tgt = torch.where(can, slot, torch.full_like(slot, n))

    def put(cur, values):
        # row n catches every update that finds no slot
        buf = torch.cat([cur, cur[:1]])
        buf[tgt] = values
        return buf[:n]

    state = state.replace(
        oid=put(state.oid, b_oid),
        alive=put(state.alive, torch.ones_like(ins)),
        **{f: put(getattr(state, f), upd[f]) for f in _UPD_FIELDS})
    return state, (ins & ~can).sum(dtype=torch.int32)


def make_sharded_ingest(cfg: SystemConfig, mesh: Mesh):
    """The sharded per-vehicle ingest: apply(states, upd, boundaries=None,
    boundaries_y=None, boundaries_z=None) -> (states, dropped [D]). `upd`
    is a dict of oid-sorted, -1-padded host or device arrays (oid [B]
    int32, pos [B, 3], vel, acc, heading, size, otype), replicated to every
    shard's device."""
    sh = cfg.shard
    defaults = _default_walls(cfg, mesh)
    dtypes = dict(oid=torch.int32, otype=torch.int32)

    def apply(states, upd, boundaries=None, boundaries_y=None,
              boundaries_z=None):
        _check_sharded(states, mesh, "sharded ingest")
        walls = _walls(mesh, defaults, boundaries, boundaries_y,
                       boundaries_z)
        batch = {dev: {f: torch.as_tensor(np.asarray(v)).to(
            dev, dtypes.get(f, torch.float32)) for f, v in upd.items()}
            for dev in set(mesh.devices)}
        out, drops = [], []
        for s, (st, dev) in enumerate(zip(states, mesh.devices)):
            coords = tuple(mesh.axis_index(s, name) for name in (
                sh.axis_name, sh.axis_name_y, sh.axis_name_z))
            st, dp = _apply_updates(st, batch[dev],
                                    tuple(w.to(dev) for w in walls), coords,
                                    cfg)
            out.append(st)
            drops.append(dp)
        return tuple(out), _dropped(mesh, drops)

    return apply
