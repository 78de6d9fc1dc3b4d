"""The port's movement modes (tpu_collide_torch/sim/scenario.py) against the
JAX package's (tpu_collide/sim/scenario.py) and against the port's host
simulator.

scenario_integrate is compared with the JAX draws injected: each step takes
the draws of jax.random.split(fold_in(key, i), 10), recomputed here, so
every branch (jitter, road switch, retarget) runs on the same numbers on
both sides. Positions, velocities, accelerations and headings agree to
rtol 1e-5 / atol 1e-4 (libm's atan2, sin and cos differ between the two);
the discrete state (road, target_ok, mode) is equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core.config import (AlertConfig, DetectionConfig,
                                     GridConfig, SimConfig, WorldConfig)
from tpu_collide.sim import scenario as jsc
from tpu_collide.sim.traffic import TrafficMap as JaxMap
from tpu_collide.sim.traffic import VehicleSimulator as JaxSimulator
from tpu_collide_torch.core.state import FIELDS
from tpu_collide_torch.sim import generate_fleet, scenario as tsc
from tpu_collide_torch.sim.traffic import TrafficMap, VehicleSimulator
from tests.torch_parity import (alert_map, assert_alerts_equal, both_states,
                                np_fleet, to_torch_cfg)

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
DT = 0.1
WORLD = 500.0
TABLE_FIELDS = {"road": ("start", "dirn", "length", "speed", "conn",
                         "n_conn"),
                "city": ("center", "radius")}
SCEN_FIELDS = ("mode", "road", "target", "target_ok")


def small_cfg(n, accel_change_prob=0.3, mode="fast"):
    """A JAX config in the 500 m world of a 5 x 5 grid map."""
    return tc.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(WORLD, WORLD, 0.0)),
        sim=SimConfig(accel_change_prob=accel_change_prob),
        grid=GridConfig(cell_size=100.0, cell_capacity=64),
        detect=DetectionConfig(mode=mode),
        alerts=AlertConfig(max_scene_alerts=256))


def grid_maps(seed=3):
    """The same 5 x 5 grid map (100 m roads) from both packages."""
    return (JaxMap(seed=seed).generate_grid_map(5, 5, 100.0),
            TrafficMap(seed=seed).generate_grid_map(5, 5, 100.0))


def random_maps(seed=10):
    """The same random map from both packages (8 roads, of which 2 keep 2
    connections, 3 keep 3 and 3 keep 4; 3 cities), and one more road with
    no connection, where a road object turns round at the end."""
    maps = []
    for Map in (JaxMap, TrafficMap):
        tmap = Map(seed=seed).generate_random_map(8, 3)
        road = next(iter(tmap.roads.values()))
        tmap.add_road(dataclasses.replace(road, id="z-no-exit"))
        maps.append(tmap)
    return tuple(maps)


def tables(jmap, tmap):
    """((JAX roads, cities, road_idx), (port roads, cities, road_idx))."""
    jr, jidx = jsc.build_road_table(jmap)
    tr, tidx = tsc.build_road_table(tmap, device="cpu")
    return ((jr, jsc.build_city_table(jmap), jidx),
            (tr, tsc.build_city_table(tmap, device="cpu"), tidx))


def jax_draws(key, n, n_cities, cfg):
    """The ten draws jax's scenario_integrate takes from `key`
    (tpu_collide/sim/scenario.py), as CPU tensors in scenario_draws'
    order."""
    ks = jax.random.split(key, 10)
    r = cfg.sim.accel_range
    u = lambda k: jax.random.uniform(k, (n,))
    d = [u(ks[0]),
         jax.random.uniform(ks[1], (n,), minval=-r, maxval=r),
         jax.random.uniform(ks[2], (n,), minval=-r, maxval=r),
         jax.random.randint(ks[3], (n,), 0, tsc._MAX_CONN),
         u(ks[4]),
         jax.random.randint(ks[5], (n,), 0, n_cities),
         u(ks[6]), u(ks[7]), u(ks[8]), u(ks[9])]
    return [torch.from_numpy(np.array(x)) for x in d]


def scenario_fleet(mode, n, roads, seed):
    """Fleet and scenario arrays that reach every branch: road objects near
    their segment's end (moving on, so that they switch or turn), before
    its start, inside it and wrong way round, and without a road; targets
    missing, within the 20 m of arrival and far; random objects on the
    border moving out; the last 6 objects dead, on roads past their end."""
    rng = np.random.default_rng(seed)
    d = np_fleet(seed, n, WORLD, accel=True, dead=6)
    if mode == "mixed":
        modes = rng.integers(0, 3, n)
    else:
        modes = np.full(n, tsc._MODE_CODES[mode])
    start = roads.start.numpy()
    dirn = roads.dirn.numpy()
    length = roads.length.numpy()
    road = rng.integers(0, length.shape[0], n)
    kind = rng.integers(0, 8, n)
    along = np.where(kind < 2, length[road] - rng.uniform(0.5, 8.0, n),
                     np.where(kind == 2, -rng.uniform(0.05, 2.0, n),
                              rng.uniform(0.1, 0.9, n) * length[road]))
    # the dead sit past their road's end, where a live object switches
    kind[-6:] = 0
    along[-6:] = length[road[-6:]] + 0.5
    speed = rng.uniform(5.0, 15.0, n) * np.where(kind == 3, -1.0, 1.0)
    on_road = modes == tsc.MODE_ROAD
    d["pos"][on_road, :2] = (start[road] + along[:, None] * dirn[road])[on_road]
    d["vel"][on_road, :2] = (speed[:, None] * dirn[road])[on_road]
    road = np.where(on_road & (kind != 7), road, -1)
    # random mode: the first few on the border, moving out
    rand = np.flatnonzero(modes == tsc.MODE_RANDOM)[:8]
    d["pos"][rand[:4], 0], d["vel"][rand[:4], 0] = 0.2, -12.0
    d["pos"][rand[4:], 1], d["vel"][rand[4:], 1] = WORLD - 0.2, 12.0
    target = rng.uniform(0.0, WORLD, (n, 2))
    near = kind % 3 == 0
    target[near] = d["pos"][near, :2] + rng.uniform(-10.0, 10.0, (near.sum(),
                                                                  2))
    target_ok = (modes == tsc.MODE_DEST) & (kind % 3 != 1)
    scen = dict(mode=modes.astype(np.int32), road=road.astype(np.int32),
                target=target.astype(np.float32), target_ok=target_ok)
    return d, scen


def both_scenarios(scen):
    return (jsc.ScenarioState(**{f: jnp.asarray(v) for f, v in scen.items()}),
            tsc.ScenarioState(**{f: torch.from_numpy(np.asarray(v))
                                 for f, v in scen.items()}))


def assert_states_close(jst, jscen, st, scen, what):
    for f in ("pos", "vel", "acc", "heading"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   err_msg=f"{what}: {f}", **TOL)
    for f in ("size", "otype", "alive", "oid"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    for f in ("mode", "road", "target_ok"):
        np.testing.assert_array_equal(getattr(scen, f).numpy(),
                                      np.asarray(getattr(jscen, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_allclose(scen.target.numpy(), np.asarray(jscen.target),
                               err_msg=f"{what}: target", **TOL)


# ---- tables ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["grid", "random"])
def test_tables_equal_jax(kind):
    """Equal arrays, dtypes and road_idx, on a grid map (phantom edge road,
    at most 4 connections) and on a random map (up to 6 connections, cut
    to the first 4 in sorted id order)."""
    if kind == "grid":
        jmap, tmap = grid_maps()
    else:
        jmap = JaxMap(seed=5).generate_random_map(20, 3)
        tmap = TrafficMap(seed=5).generate_random_map(20, 3)
    (jr, jc, jidx), (tr, tc_, tidx) = tables(jmap, tmap)
    assert tidx == jidx
    for table, (jt, tt_) in (("road", (jr, tr)), ("city", (jc, tc_))):
        for f in TABLE_FIELDS[table]:
            want, got = np.asarray(getattr(jt, f)), getattr(tt_, f).numpy()
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    assert tr.device == torch.device("cpu")
    if kind == "random":
        assert int(tr.n_conn.max()) == tsc._MAX_CONN


def test_tables_of_an_empty_map():
    """No roads and no cities: one placeholder road and city, as in JAX."""
    (jr, jc, _), (tr, tc_, tidx) = tables(JaxMap(seed=0), TrafficMap(seed=0))
    assert tidx == {}
    for table, (jt, tt_) in (("road", (jr, tr)), ("city", (jc, tc_))):
        for f in TABLE_FIELDS[table]:
            np.testing.assert_array_equal(getattr(tt_, f).numpy(),
                                          np.asarray(getattr(jt, f)))


def test_grid_connections_follow_the_string_sort():
    """On the 100 x 100 grid the string sort keeps v-road-0, -1, -10 and
    -100 of an h-road's 101 connections: the JAX package's semantics."""
    tmap = TrafficMap(seed=4).generate_grid_map(100, 100, 100.0)
    roads, idx = tsc.build_road_table(tmap, device="cpu")
    got = roads.conn[idx["h-road-7"]].tolist()
    assert got == [idx[f"v-road-{i}"] for i in (0, 1, 10, 100)]
    assert roads.length.shape == (202,)


# ---- scenario_integrate against JAX ---------------------------------------

@pytest.mark.parametrize("mode,roads", [
    ("random", "grid"), ("road_constrained", "grid"),
    ("road_constrained", "random"), ("destination_oriented", "grid"),
    ("mixed", "grid")])
def test_integrate_matches_jax_with_injected_draws(mode, roads):
    jmap, tmap = grid_maps() if roads == "grid" else random_maps()
    (jr, jc, _), (tr, tc_, _) = tables(jmap, tmap)
    n = 240
    cfg = small_cfg(n)
    tcfg = to_torch_cfg(cfg)
    d, scen = scenario_fleet(mode, n, tr, seed=11)
    jst, st = both_states(d)
    jscen, tscen = both_scenarios(scen)
    key = jax.random.key(21)
    seen = dict(switch=0, turn=0, arrive=0, retarget=0, bounce=0,
                no_exit=0)
    no_exit = tr.n_conn == 0
    for i in range(10):
        k = jax.random.fold_in(key, i)
        draws = jax_draws(k, n, tc_.radius.shape[0], cfg)
        prev_road, prev_ok = tscen.road.clone(), tscen.target_ok.clone()
        prev_vel = st.vel.clone()
        jst, jscen = jsc.scenario_integrate(jst, jscen, k, cfg, jr, jc)
        st, tscen = tsc.scenario_integrate(st, tscen, None, tcfg, tr, tc_,
                                           draws=draws)
        assert_states_close(jst, jscen, st, tscen, f"{mode}, step {i}")
        alive = st.alive
        seen["switch"] += int(((tscen.road != prev_road) & alive).sum())
        turned = ((tscen.mode == tsc.MODE_ROAD) & (tscen.road == prev_road)
                  & alive & ((st.vel[:, :2] * prev_vel[:, :2]).sum(1) < 0))
        seen["turn"] += int(turned.sum())
        seen["no_exit"] += int((turned & no_exit[
            tscen.road.clamp_min(0).long()]).sum())
        seen["arrive"] += int((prev_ok & ~tscen.target_ok & alive).sum())
        seen["retarget"] += int((~prev_ok & tscen.target_ok & alive).sum())
        seen["bounce"] += int(((tscen.mode == tsc.MODE_RANDOM)
                               & (st.vel[:, :2] * prev_vel[:, :2] < 0).any(1)
                               & alive).sum())
    # dead objects stayed as they were
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f)[-6:].numpy(),
                                      np.asarray(d[f])[-6:], err_msg=f)
    for f in SCEN_FIELDS:
        np.testing.assert_array_equal(getattr(tscen, f)[-6:].numpy(),
                                      np.asarray(scen[f])[-6:], err_msg=f)
    want = {"random": ("bounce",), "road_constrained": ("switch", "turn"),
            "destination_oriented": ("arrive", "retarget"),
            "mixed": ("bounce", "switch", "turn", "arrive", "retarget")}
    want = want[mode] + (("no_exit",) if roads == "random" else ())
    assert all(seen[b] > 0 for b in want), seen
    if roads == "random":
        assert int(tr.n_conn.min()) == 0 and 0 < int(tr.n_conn[:-1].min()) < \
            tsc._MAX_CONN


def test_roadless_object_moves_as_random():
    """A road-mode object without a road (-1) gathers road 0 clipped and
    moves exactly as a random-mode object on the same draws."""
    jmap, tmap = grid_maps()
    _, (tr, tc_, _) = tables(jmap, tmap)
    n = 40
    cfg = small_cfg(n)
    tcfg = to_torch_cfg(cfg)
    d = np_fleet(2, n, WORLD, accel=True)
    _, st = both_states(d)
    draws = jax_draws(jax.random.key(3), n, tc_.radius.shape[0], cfg)
    scen = lambda code: tsc.ScenarioState(
        mode=torch.full((n,), code, dtype=torch.int32),
        road=torch.full((n,), -1, dtype=torch.int32),
        target=torch.zeros((n, 2)), target_ok=torch.zeros(n, dtype=bool))
    a, sa = tsc.scenario_integrate(st, scen(tsc.MODE_ROAD), None, tcfg, tr,
                                   tc_, draws=draws)
    b, _ = tsc.scenario_integrate(st, scen(tsc.MODE_RANDOM), None, tcfg, tr,
                                  tc_, draws=draws)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (sa.road == -1).all()


def test_generator_draws_follow_their_order():
    """scenario_draws takes the ten draws in its documented order, so a
    generator run equals the same run with those draws injected."""
    jmap, tmap = grid_maps()
    _, (tr, tc_, _) = tables(jmap, tmap)
    n = 100
    tcfg = to_torch_cfg(small_cfg(n))
    d, scen = scenario_fleet("mixed", n, tr, seed=4)
    _, st = both_states(d)
    _, tscen = both_scenarios(scen)
    draws = tsc.scenario_draws(n, tc_.radius.shape[0], tcfg,
                               torch.Generator().manual_seed(9), "cpu")
    assert [x.dtype for x in draws] == [torch.float32] * 3 + [torch.int32] \
        + [torch.float32, torch.int32] + [torch.float32] * 4
    r = tcfg.sim.accel_range
    assert all(((x >= -r) & (x < r)).all() for x in draws[1:3])
    assert int(draws[3].max()) < tsc._MAX_CONN
    assert int(draws[5].max()) < tc_.radius.shape[0]
    a, sa = tsc.scenario_integrate(st, tscen, torch.Generator().manual_seed(9),
                                   tcfg, tr, tc_)
    b, sb = tsc.scenario_integrate(st, tscen, None, tcfg, tr, tc_,
                                   draws=draws)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in SCEN_FIELDS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f


# ---- the host simulator ---------------------------------------------------

def test_scenario_from_simulator_matches_jax():
    """The port's lift of its VehicleSimulator equals JAX's lift of the JAX
    simulator with the same seed, after steps that assigned roads and
    targets, with the modes mixed."""
    sims = []
    for Map, Sim in ((JaxMap, JaxSimulator), (TrafficMap, VehicleSimulator)):
        tmap = Map(seed=3).generate_grid_map(5, 5, 100.0)
        sim = Sim(tmap, num_vehicles=30, movement_mode="random", seed=7)
        sim.initialize_vehicles()
        for i, vid in enumerate(sorted(sim.vehicles)):
            sim.vehicle_modes[vid] = ("random", "road_constrained",
                                      "destination_oriented")[i % 3]
        for _ in range(3):
            sim.update_vehicles(DT)
        sims.append((tmap, sim))
    (jmap, jsim), (tmap, tsim) = sims
    (_, _, jidx), (_, _, tidx) = tables(jmap, tmap)
    order = sorted(tsim.vehicles)[::-1]
    jst, jscen = jsc.scenario_from_simulator(jsim, jidx, order=order)
    st, scen = tsc.scenario_from_simulator(tsim, tidx, order=order,
                                           device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for f in SCEN_FIELDS:
        got, want = getattr(scen, f).numpy(), np.asarray(getattr(jscen, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert set(scen.mode.tolist()) == {0, 1, 2}
    assert (scen.road >= 0).sum() == 10 and scen.target_ok.sum() > 0


def silence(sim):
    """Stop the host's stochastic branches: jitter never triggers and
    retargeting never picks the city branch."""
    sim.rng.random = lambda: 0.99
    sim.traffic_map.rng.random = lambda: 0.5


def run_device(state, scen, cfg, roads, cities, steps, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state, scen = tsc.scenario_integrate(state, scen, gen, cfg, roads,
                                             cities)
    return state, scen


@pytest.mark.parametrize("mode", ["random", "road_constrained",
                                  "destination_oriented"])
def test_device_matches_host(mode):
    """The port of tests/test_scenario.py's host check: with the randomness
    silenced on both sides the port's device step follows the port's host
    VehicleSimulator."""
    from tpu_collide_torch.core.types import Position
    tmap = TrafficMap(seed=3).generate_grid_map(5, 5, 100.0)
    sim = VehicleSimulator(tmap, num_vehicles=20, movement_mode=mode, seed=7)
    sim.initialize_vehicles()
    order = sorted(sim.vehicles)
    if mode == "destination_oriented":
        for vid in order:
            sim.vehicle_targets[vid] = Position(450.0, 450.0, 0.0)
    elif mode == "road_constrained":
        # one host step assigns the roads and snaps onto them
        sim.update_vehicles(DT)
    silence(sim)
    cfg = to_torch_cfg(small_cfg(20, accel_change_prob=0.0))
    roads, road_idx = tsc.build_road_table(tmap, device="cpu")
    cities = tsc.build_city_table(tmap, device="cpu")
    state, scen = tsc.scenario_from_simulator(sim, road_idx, order=order,
                                              device="cpu")
    for _ in range(10):
        sim.update_vehicles(DT)
    state, scen = run_device(state, scen, cfg, roads, cities, 10)
    want = np.array([[sim.vehicles[v].position.x, sim.vehicles[v].position.y]
                     for v in order])
    got = state.pos[:, :2].numpy()
    if mode == "road_constrained":
        # vehicles that may reach a segment end in the window pick their
        # next road from another generator on each side
        keep = []
        for i, vid in enumerate(order):
            r = tmap.roads.get(sim.vehicle_roads.get(vid))
            if r is None:
                continue
            dx, dy = r.direction()
            v = sim.vehicles[vid]
            along = ((v.position.x - r.start.x) * dx
                     + (v.position.y - r.start.y) * dy)
            if 5.0 < along < r.length - 20.0 and int(scen.road[i]) == \
                    road_idx.get(r.id, -2):
                keep.append(i)
        assert len(keep) >= 8, f"too few comparable vehicles: {len(keep)}"
        np.testing.assert_allclose(got[keep], want[keep], atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2)


def snapped_road_fleet(cfg, tmap, seed, device="cpu"):
    """generate_fleet, every object road_constrained on a road drawn by
    init_scenario and snapped onto it at a fraction U(0.1, 0.9)."""
    roads, _ = tsc.build_road_table(tmap, device=device)
    cities = tsc.build_city_table(tmap, device=device)
    gen = torch.Generator().manual_seed(seed)
    state = generate_fleet(gen, cfg, "uniform", device=device)
    scen = tsc.init_scenario(cfg.num_objects, "road_constrained", roads,
                             gen, device=device)
    frac = torch.rand(cfg.num_objects, generator=gen) * 0.8 + 0.1
    r = scen.road.long()
    pos = state.pos.clone()
    pos[:, :2] = roads.start[r] + (frac * roads.length[r])[:, None] \
        * roads.dirn[r]
    return state.replace(pos=pos), scen, roads, cities


def test_road_mode_stays_on_roads():
    """50 device steps with jitter: every road-mode vehicle stays on its
    road's line, and the fleet moved."""
    tmap = TrafficMap(seed=1).generate_grid_map(5, 5, 100.0)
    cfg = to_torch_cfg(small_cfg(64, accel_change_prob=0.1))
    state, scen, roads, cities = snapped_road_fleet(cfg, tmap, seed=0)
    p0 = state.pos[:, :2].clone()
    state, scen = run_device(state, scen, cfg, roads, cities, 50, seed=1)
    p = state.pos[:, :2]
    r = scen.road.long()
    s, d = roads.start[r], roads.dirn[r]
    off = (p - s) - ((p - s) * d).sum(1, keepdim=True) * d
    assert float(off.abs().max()) < 1e-2, "vehicle drifted off its road line"
    assert float((p - p0).abs().max()) > 1.0


# ---- make_scenario_step against JAX ---------------------------------------

@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_scenario_step_matches_jax(backend):
    """make_scenario_step on a 200-object road fleet of a 500 m grid map,
    three steps with the JAX draws injected, against JAX's step (fused: in
    interpret mode): equal counters, and with both certificates 0 and the
    budget not binding, equal alerts as unordered pairs."""
    jmap, tmap = grid_maps(seed=2)
    (jr, jc, _), (tr, tc_, _) = tables(jmap, tmap)
    n = 200
    cfg = small_cfg(n, accel_change_prob=0.1)
    d, scen = scenario_fleet("road_constrained", n, tr, seed=5)
    d["alive"][:] = True
    jst, st = both_states(d)
    jscen, tscen = both_scenarios(scen)
    jstep = jsc.make_scenario_step(cfg, jr, jc, backend=backend,
                                   donate=False, interpret=True)
    tstep = tsc.make_scenario_step(to_torch_cfg(cfg), tr, tc_,
                                   backend=backend, device="cpu")
    compared = 0
    for i in range(3):
        key = jax.random.key(40 + i)
        jst, jscen, jo = jstep(jst, jscen, key)
        st, tscen, to = tstep(st, tscen, None,
                              draws=jax_draws(key, n, tc_.radius.shape[0],
                                              cfg))
        assert_states_close(jst, jscen, st, tscen, f"step {i}")
        for f in ("num_alive", "num_risks", "num_pairs_checked", "overflow",
                  "alert_overflow"):
            assert int(getattr(to, f)) == int(np.asarray(getattr(jo, f))), f
        want, got = alert_map(jo.alerts), alert_map(to.alerts)
        if int(to.overflow) == int(to.alert_overflow) == 0 \
                and int(to.alerts.count) < cfg.alerts.max_scene_alerts:
            assert_alerts_equal(want, got)
            compared += len(got)
    assert int(to.num_alive) == n and compared > 0


def test_scenario_step_backends_agree():
    """Both backends of the port's step on one road fleet: the same states
    (the physics does not depend on detection) and the same alerts as
    unordered pairs."""
    tmap = TrafficMap(seed=2).generate_grid_map(5, 5, 100.0)
    # a budget that does not bind (the fused path lists both directions)
    cfg = to_torch_cfg(small_cfg(300).replace(
        alerts=AlertConfig(max_scene_alerts=4096)))
    state, scen, roads, cities = snapped_road_fleet(cfg, tmap, seed=3)
    outs = {}
    for backend in ("xla", "fused"):
        step = tsc.make_scenario_step(cfg, roads, cities, backend=backend,
                                      device="cpu")
        st, sc, gen = state, scen, torch.Generator().manual_seed(6)
        for _ in range(3):
            st, sc, out = step(st, sc, gen)
        outs[backend] = (st, sc, out)
    (sx, cx, ox), (sf, cf, of) = outs["xla"], outs["fused"]
    for f in FIELDS:
        assert torch.equal(getattr(sx, f), getattr(sf, f)), f
    for f in SCEN_FIELDS:
        assert torch.equal(getattr(cx, f), getattr(cf, f)), f
    assert int(ox.overflow) == int(of.overflow) == 0
    assert int(ox.alert_overflow) == int(of.alert_overflow) == 0
    assert int(ox.num_risks) == int(of.num_risks) > 0
    assert int(of.alerts.count) < cfg.alerts.max_scene_alerts
    assert_alerts_equal(alert_map(ox.alerts), alert_map(of.alerts))


def test_devices_are_checked():
    """No device named and no card: the step and the tables raise; a state
    on another device than the step's is refused; an unknown backend and a
    road fleet without roads are refused."""
    tmap = TrafficMap(seed=2).generate_grid_map(5, 5, 100.0)
    cfg = to_torch_cfg(small_cfg(10))
    roads, _ = tsc.build_road_table(tmap, device="cpu")
    cities = tsc.build_city_table(tmap, device="cpu")
    if not torch.cuda.is_available():
        for call in (lambda: tsc.make_scenario_step(cfg, roads, cities),
                     lambda: tsc.build_road_table(tmap),
                     lambda: tsc.build_city_table(tmap),
                     lambda: tsc.init_scenario(10, "random")):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    with pytest.raises(ValueError, match="lies on"):
        tsc.make_scenario_step(cfg, roads, cities, device="meta")
    step = tsc.make_scenario_step(cfg, roads, cities, device="cpu")
    state = generate_fleet(torch.Generator(), cfg, "uniform", device="cpu")
    scen = tsc.init_scenario(10, "random", device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        step(state.replace(pos=state.pos.to("meta")), scen, None)
    with pytest.raises(ValueError, match="lies on"):
        step(state, dataclasses.replace(scen, mode=scen.mode.to("meta")),
             None)
    with pytest.raises(ValueError):
        tsc.make_scenario_step(cfg, roads, cities, backend="pallas",
                               device="cpu")
    with pytest.raises(ValueError):
        tsc.init_scenario(10, "road_constrained", device="cpu")
