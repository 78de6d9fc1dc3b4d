"""The port's Scene (tpu_collide_torch/api/scene.py) on the CPU: the port
cases of tests/test_scene_api.py, tests/test_retune.py,
tests/test_burst.py::test_scene_step_burst and tests/test_step_pipelined.py,
parity with the JAX Scene on the same numpy fleets (xla backend: alert
manager pair maps and stats after 3 steps, predicted risks; fused backend:
against the Pallas step in interpret mode, through the slot self-heal), and
the port-only self-heals of predict (k_slots, the out-of-memory retry).

Fleets come from numpy with accel_change_prob 0, so the two packages'
integrators take the same steps although their generators differ."""
import dataclasses

import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.api import Scene as JaxScene
import tpu_collide_torch as tt
from tpu_collide_torch.api import Scene
from tpu_collide_torch.api import scene as scene_mod
from tpu_collide_torch.core.config import (DetectionConfig, GridConfig,
                                           SimConfig, WorldConfig)
from tpu_collide_torch.core.state import state_from_numpy
from tpu_collide_torch.core.types import LocationData, Position, Vector
from tpu_collide_torch.kernels.fused_detect import K_MAX
from tpu_collide_torch.sim import generate_fleet
from tests.torch_parity import (alert_map, both_states, jax_cfg, np_fleet,
                                to_torch_cfg)

torch.set_num_threads(1)


# ---- helpers ---------------------------------------------------------------

def small_scene(tmp_path=None, n=64):
    cfg = tt.SystemConfig(num_objects=n,
                          world=WorldConfig(hi=(500.0, 500.0, 0.0)))
    return Scene(cfg, checkpoint_dir=str(tmp_path) if tmp_path else None,
                 device="cpu")


def converging(scene):
    scene.ingest(LocationData("carA", Position(100, 100, 0), Vector(10, 0, 0)))
    scene.ingest(LocationData("carB", Position(180, 100, 0), Vector(-10, 0, 0),
                              heading=np.pi))


def fleet_from_pos(pos, vel=None):
    n = pos.shape[0]
    return state_from_numpy(pos, np.zeros((n, 3)) if vel is None else vel,
                            np.zeros((n, 3)), np.zeros(n), np.full(n, 2.0),
                            np.zeros(n, np.int32), device="cpu")


def clustered_pos(n, n_dense, lo=500.0, width=60.0, seed=0):
    """n_dense objects crammed into one ~cell-sized patch, rest uniform."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:n_dense, :2] = rng.uniform(lo, lo + width, (n_dense, 2))
    pos[n_dense:, :2] = rng.uniform(0.0, 2000.0, (n - n_dense, 2))
    return pos


def sparse_fleet(n, seed=1, n_alive=None):
    rng = np.random.default_rng(seed)
    pos = np.zeros((n, 3), np.float32)
    pos[:, :2] = rng.uniform(0.0, 2000.0, (n, 2))
    st = fleet_from_pos(pos)
    if n_alive is not None:
        st = st.replace(alive=torch.arange(n) < n_alive)
    return st


def converging_cluster(n, n_dense, width, seed, speed=5.0):
    """clustered_pos with every object heading for the patch's centre at
    `speed` (a zero-velocity fleet has no stage-2 survivors)."""
    pos = clustered_pos(n, n_dense, width=width, seed=seed)
    d = np.array([500.0 + width / 2, 500.0 + width / 2, 0.0]) - pos
    nrm = np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-3)
    return fleet_from_pos(pos, speed * d / nrm)


def retune_cfg(n=256, cap=16, mode="fast"):
    return tt.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(2000.0, 2000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=cap),
        detect=DetectionConfig(mode=mode),
        sim=SimConfig(accel_change_prob=0.0))


def pset(out):
    v = out.alerts.valid.numpy()
    a = out.alerts.vehicle_oid.numpy()[v]
    b = out.alerts.other_oid.numpy()[v]
    return {(int(x), int(y)) for x, y in zip(a, b)}


def pair_map(scene):
    return {(a.vehicle_id, a.other_vehicle_id):
            (a.risk_level, a.time_to_collision, a.priority)
            for a in scene.alert_manager.alerts.values()}


def assert_pair_maps_equal(want, got):
    """Same pairs; risk and ttc at rtol = atol = 1e-5; priority exact."""
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5],
                                   sorted(set(got) - set(want))[:5])
    for k in want:
        np.testing.assert_allclose(got[k][:2], want[k][:2], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
        assert got[k][2] == want[k][2], k


def both_scenes(n, backend, seed=5, world=2000.0, cfg=None, **kw):
    """A JAX Scene and a port Scene (on the CPU) that adopted the same numpy
    fleet."""
    cfg = cfg or jax_cfg(n)
    jst, st = both_states(np_fleet(seed, n, world, **kw))
    js = JaxScene(cfg, backend=backend, interpret=True)
    js.adopt_fleet(jst)
    ts = Scene(to_torch_cfg(cfg), backend=backend, device="cpu")
    ts.adopt_fleet(st)
    return js, ts


# ---- the port cases of tests/test_scene_api.py ------------------------------

def test_scene_ingest_detect_alerts(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.detect()
    alerts = sc.alerts()
    assert len(alerts) == 1
    a = alerts[0]
    assert {a.vehicle_id, a.other_vehicle_id} == {"carA", "carB"}
    assert abs(a.time_to_collision - 3.7) < 1e-3      # (80-7)/20 -> 3.7 lattice
    assert a.priority == 2                             # ttc < 5 -> HIGH
    assert "carB" in a.message or "carA" in a.message


def test_scene_update_not_duplicate(tmp_path):
    """Re-ingesting the same vehicle updates its slot, not a new object;
    of two reports of one vehicle in one flush, the later wins."""
    sc = small_scene(tmp_path)
    converging(sc)
    sc.detect()
    sc.ingest(LocationData("carA", Position(300, 300, 0), Vector(10, 0, 0)))
    sc.ingest(LocationData("carA", Position(110, 100, 0), Vector(10, 0, 0)))
    sc.flush()
    assert sc.stats()["num_alive"] == 2
    assert sc.state.pos[0].tolist() == [110.0, 100.0, 0.0]
    # alert got updated, not duplicated
    sc.detect()
    assert len(sc.alerts()) == 1
    assert sc.alerts()[0].time_to_collision < 3.7


def test_scene_query_and_history(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.flush()
    ids = sc.query_radius((100, 100, 0), 100.0)
    assert set(ids) == {"carA", "carB"}
    assert sc.grid_vehicles(1, 1) == ["carA", "carB"]
    assert sc.grid_vehicles(2, 1) == []
    assert sc.get_location("carA").position.x == 100
    sc.ingest(LocationData("carA", Position(105, 100, 0), Vector(10, 0, 0)))
    assert len(sc.get_history("carA")) == 2


def test_scene_checkpoint_resume(tmp_path):
    sc = small_scene(tmp_path)
    converging(sc)
    sc.flush()
    sc.save_checkpoint()
    sc.step(5)
    pos_after = sc.state.pos.numpy().copy()
    sc.restore_checkpoint()
    assert sc.step_count == 0
    assert sc.stats()["num_alive"] == 2
    assert not np.allclose(sc.state.pos.numpy(), pos_after)
    assert sc._id_to_slot == {"carA": 0, "carB": 1}   # identity restored


def test_scene_capacity_guard():
    """Capacity exhaustion drops the excess report (logged) instead of
    poisoning the pending queue for every later flush."""
    sc = small_scene(n=2)
    converging(sc)
    sc.flush()
    sc.ingest(LocationData("carC", Position(1, 1, 0), Vector()))
    sc.flush()                                  # no raise
    assert sc.stats()["num_alive"] == 2         # carC dropped
    # the scene keeps working afterwards
    sc.ingest(LocationData("carA", Position(105, 100, 0), Vector(10, 0, 0)))
    sc.flush()
    assert sc.stats()["num_alive"] == 2


def test_scene_xla_bucket_overflow_self_heals():
    """Counted grid-bucket overflow doubles cell_capacity until the
    overflow counter returns to 0."""
    n = 300
    cfg = tt.SystemConfig(
        num_objects=n, world=WorldConfig(hi=(1000.0, 1000.0, 0.0)),
        grid=GridConfig(cell_size=100.0, cell_capacity=4),   # far too small
        detect=DetectionConfig(mode="fast"),
        sim=SimConfig(accel_change_prob=0.0))
    rng = np.random.default_rng(3)
    pos = np.zeros((n, 3), np.float32)
    pos[:, :2] = rng.uniform(400, 500, (n, 2))    # one dense cell
    sc = Scene(cfg, backend="xla", device="cpu")
    sc.adopt_fleet(fleet_from_pos(pos))
    out = sc.step()
    assert int(out.overflow) > 0
    assert sc.window_regrows >= 1          # _grow_buckets fired
    for _ in range(8):
        out = sc.step()
        if int(out.overflow) == 0:
            break
    assert int(out.overflow) == 0
    assert sc.cfg.grid.cell_capacity > 4


def test_scene_step_zero_rejected():
    sc = small_scene()
    with pytest.raises(ValueError):
        sc.step(0)


def test_scene_device_and_misuse():
    """No device names the card (and raises without one); a fleet on
    another device, and checkpoints without a directory, are refused;
    drop_fraction kills the share of the alive fleet it names."""
    cfg = tt.SystemConfig(num_objects=8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Scene(cfg)
    sc = small_scene(n=8)
    with pytest.raises(RuntimeError):
        sc.save_checkpoint()
    st = sc.state.replace(pos=sc.state.pos.to("meta"))
    with pytest.raises(ValueError):
        sc.adopt_fleet(st)
    sc.adopt_fleet(sparse_fleet(8))
    assert sc.drop_fraction(0.5) == 4 and sc.stats()["num_alive"] == 4
    assert int(sc.state.alive.sum()) == 4


# ---- the port cases of tests/test_retune.py ---------------------------------

def test_xla_scene_retune_grows_bucket_capacity():
    cfg = retune_cfg(n=128, cap=4)
    sc = Scene(cfg, state=fleet_from_pos(clustered_pos(128, 40, width=30.0)),
               backend="xla", device="cpu")
    out = sc.step()
    assert int(out.overflow) > 0          # 40 objects >> 4-slot buckets
    assert sc.retune() is True
    assert sc.cfg.grid.cell_capacity >= 40
    assert int(sc.step().overflow) == 0
    assert sc.retunes == 1
    assert sc.stats()["config"]["cell_capacity"] == sc.cfg.grid.cell_capacity


def test_xla_scene_retune_shrinks_with_hysteresis():
    sc = Scene(retune_cfg(n=256, cap=64), state=sparse_fleet(256),
               backend="xla", device="cpu")
    assert sc.retune() is True            # 64 >> live densest bucket
    shrunk = sc.cfg.grid.cell_capacity
    assert shrunk < 64
    assert sc.retune() is False           # stable point
    assert sc.cfg.grid.cell_capacity == shrunk
    assert int(sc.step().overflow) == 0   # shrunk capacity still complete


def test_auto_retune_every_runs_on_schedule():
    sc = Scene(retune_cfg(n=256, cap=64), state=sparse_fleet(256),
               backend="xla", auto_retune_every=2, device="cpu")
    sc.step()
    assert sc.retunes == 0                # not due yet
    sc.step()
    assert sc.retunes == 1                # step 2: shrank the 64 buckets
    assert sc.cfg.grid.cell_capacity < 64


def test_precise_scene_sizes_survivor_cap_fleet_exact():
    """A fused precise Scene adopts a fleet-exact survivor cap at build (far
    below the max(4096, 2N) default for a sparse fleet), certifies
    complete, and retune() re-derives the cap in both directions."""
    n = 480
    cfg = retune_cfg(n=n, mode="precise")
    sc = Scene(cfg, state=sparse_fleet(n, seed=3), backend="fused",
               device="cpu")
    cap0 = sc.cfg.survivor_cap
    assert cap0 < cfg.survivor_cap
    assert int(sc.step().alert_overflow) == 0  # certified at the exact cap
    sc.adopt_fleet(converging_cluster(n, 320, width=120.0, seed=4))
    assert sc.retune() is True
    cap_dense = sc.cfg.survivor_cap
    assert cap_dense > cap0
    sc.adopt_fleet(sparse_fleet(n, seed=5))
    assert sc.retune() is True
    assert sc.cfg.survivor_cap < cap_dense
    assert sc.retunes == 2


# ---- bursts and pipelining (tests/test_burst.py, test_step_pipelined.py) ---

def _state_eq(a, b):
    for f in ("pos", "vel", "acc", "heading", "alive"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_scene_step_burst():
    """step_burst(n) advances the scene exactly like n step() calls; burst
    length 1 delegates to step(). The generator moves in both (the fleet's
    accelerations are redrawn), so one more step on each still agrees."""
    cfg = tt.SystemConfig(num_objects=256)
    gen = lambda: torch.Generator().manual_seed(1)
    a = Scene(cfg, state=generate_fleet(gen(), cfg), device="cpu")
    b = Scene(cfg, state=generate_fleet(gen(), cfg), device="cpu")
    out_a = a.step(6)
    out_b = b.step_burst(6)
    _state_eq(a.state, b.state)
    assert a.step_count == b.step_count == 6
    assert pset(out_a) == pset(out_b)
    assert b.last_burst_risks.shape == (6,)
    assert int(out_a.num_risks) == int(b.last_burst_risks[-1])
    out_a2, out_b2 = a.step(), b.step_burst(1)
    assert pset(out_a2) == pset(out_b2)
    _state_eq(a.state, b.state)
    assert a.alert_manager.get_stats()["active"] > 0


@pytest.mark.parametrize("backend", ["xla", "fused"])
def test_pipelined_matches_step_sequence(backend):
    cfg = tt.SystemConfig(num_objects=400,
                          world=WorldConfig(hi=(2000.0, 2000.0, 0.0)),
                          detect=DetectionConfig(mode="fast"))
    gen = lambda: torch.Generator().manual_seed(3)
    sc_a = Scene(cfg, state=generate_fleet(gen(), cfg), backend=backend,
                 device="cpu")
    sc_b = Scene(cfg, state=generate_fleet(gen(), cfg), backend=backend,
                 device="cpu")
    outs_a = [sc_a.step() for _ in range(5)]
    outs_b = [sc_b.step_pipelined() for _ in range(5)]
    outs_b.append(sc_b.pipeline_drain())
    assert outs_b[0] is None                    # nothing pending yet
    assert sc_a.step_count == sc_b.step_count == 5
    for oa, ob in zip(outs_a, outs_b[1:]):
        assert int(oa.num_risks) == int(ob.num_risks)
        assert pset(oa) == pset(ob)
    _state_eq(sc_a.state, sc_b.state)
    # every step's alerts reached the manager: identical lifecycle state
    assert sc_a.alert_manager.get_stats() == sc_b.alert_manager.get_stats()
    assert sc_a.stats()["num_alive"] == sc_b.stats()["num_alive"] == 400
    assert sc_b.pipeline_drain() is None        # a second drain is a no-op


def test_pipelined_heals_once_per_capacity_generation():
    """Two in-flight outputs of the same undersized program double the
    slots ONCE (the guard compares the capacity at dispatch)."""
    n = 300
    cfg = retune_cfg(n=n).replace(alerts=dataclasses.replace(
        tt.AlertConfig(), max_alerts_per_object=1, max_scene_alerts=256))
    sc = Scene(cfg, state=converging_cluster(n, n, width=80.0, seed=2),
               backend="fused", device="cpu")
    assert sc.step_pipelined() is None          # s1 dispatched @k=1
    o1 = sc.step_pipelined()                    # s2 dispatched @1; s1 consumed
    assert int(o1.alert_overflow) > 0
    assert sc.cfg.alerts.max_alerts_per_object == 2
    o2 = sc.pipeline_drain()                    # s2 consumed: same generation
    assert int(o2.alert_overflow) > 0
    assert sc.cfg.alerts.max_alerts_per_object == 2
    assert sc.window_regrows == 1


def test_mixing_modes_drains_first():
    cfg = tt.SystemConfig(num_objects=128)
    sc = Scene(cfg, state=generate_fleet(torch.Generator().manual_seed(1),
                                         cfg), device="cpu")
    assert sc.step_pipelined() is None
    assert sc._pipe is not None
    sc.step()                                   # drains s1, then steps s2
    assert sc._pipe is None
    assert sc.step_count == 2
    sc.step_pipelined()
    assert sc.detect() is not None              # detect() also drains
    assert sc._pipe is None


# ---- parity with the JAX Scene ----------------------------------------------

def test_xla_scene_matches_jax_scene():
    """The same fleet in Scene(backend='xla') of both packages: after 3
    steps the alert managers hold the same pair map and the same stats."""
    js, ts = both_scenes(400, "xla")
    for _ in range(3):
        jo, to = js.step(), ts.step()
        assert int(to.num_risks) == int(jo.num_risks)
    assert len(pair_map(ts)) > 10
    assert_pair_maps_equal(pair_map(js), pair_map(ts))
    assert ts.alert_manager.get_stats() == js.alert_manager.get_stats()
    assert ts.stats()["num_alive"] == js.stats()["num_alive"]


def test_xla_scene_predict_matches_jax_scene():
    """predict() of both xla Scenes after 3 record_trajectories(), the
    fleet driven from outside between ticks (the same numpy positions
    adopted by both, so that the histories are equal to the bit): the same
    predicted CollisionRisk set, and the same alert manager after the
    predictions are fed to it."""
    n = 300
    cfg = jax_cfg(n)
    d = np_fleet(8, n, 1200.0, accel=True)
    js, ts = both_scenes(n, "xla", cfg=cfg, seed=8, world=1200.0,
                         accel=True)
    for tick in range(3):
        t = np.float32(tick * cfg.sim.dt)
        moved = dict(d, pos=(d["pos"] + d["vel"] * t
                             + np.float32(0.5) * d["acc"] * t * t))
        jst, st = both_states(moved)
        js.adopt_fleet(jst)
        ts.adopt_fleet(st)
        js.record_trajectories()
        ts.record_trajectories()
    want = {(r.vehicle_id, r.other_vehicle_id):
            (r.risk_level, r.time_to_collision, r.distance)
            for r in js.predict()}
    got = {(r.vehicle_id, r.other_vehicle_id):
           (r.risk_level, r.time_to_collision, r.distance)
           for r in ts.predict()}
    assert len(want) > 5 and set(got) == set(want)
    for k in want:
        # risk and ttc as tests/test_torch_predict.py holds them; the
        # distance is a difference of predicted positions of up to 1200 m,
        # so two of their f32 ulps (2 * 1.22e-4)
        np.testing.assert_allclose(got[k][:2], want[k][:2], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
        np.testing.assert_allclose(got[k][2], want[k][2], rtol=0,
                                   atol=2.5e-4, err_msg=str(k))
    assert_pair_maps_equal(pair_map(js), pair_map(ts))


def test_fused_scene_grows_slots_like_jax_scene():
    """backend='fused' at max_alerts_per_object 2 on a fleet whose
    alert_overflow > 0: both Scenes double k after each overflowing step
    (staying within the JAX package's k <= 16), the certificate returns to
    0, and the certified step's alerts are equal; the port's step against
    the Pallas step in interpret mode."""
    cfg = jax_cfg(300, alerts=256)
    cfg = cfg.replace(alerts=dataclasses.replace(cfg.alerts,
                                                 max_alerts_per_object=2))
    js, ts = both_scenes(300, "fused", cfg=cfg, world=700.0)
    ks, aos = [], []
    for _ in range(3):
        jo, to = js.step(), ts.step()
        assert int(to.alert_overflow) == int(jo.alert_overflow)
        assert int(to.num_risks) == int(jo.num_risks)
        aos.append(int(to.alert_overflow))
        ks.append(ts.cfg.alerts.max_alerts_per_object)
        assert ks[-1] == js.cfg.alerts.max_alerts_per_object <= 16
        if aos[-1] == 0:
            break
    assert aos[0] > 0 and aos[-1] == 0 and ks[0] == 4
    assert ts.window_regrows == js.window_regrows == len(ks) - 1
    want, got = alert_map(jo.alerts), alert_map(to.alerts)
    assert len(want) > 10 and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k][:4], want[k][:4], rtol=1e-5,
                                   atol=2e-4)
        assert got[k][4] == want[k][4]


def test_precise_grow_slots_doubles_k_and_cap():
    """Precise mode: survivor overflow doubles survivor_k and the survivor
    cap together; at K_MAX only the cap grows, up to N * k."""
    n = 300
    cfg = retune_cfg(n=n, mode="precise").replace(detect=DetectionConfig(
        mode="precise", survivor_k=2, precise_survivor_cap=1024))
    sc = Scene(cfg, state=converging_cluster(n, n, width=80.0, seed=6),
               backend="fused", device="cpu")
    out = sc.step()
    assert int(out.alert_overflow) > 0
    assert sc.cfg.detect.survivor_k == 4 and sc.cfg.survivor_cap == 2048
    sc.cfg = sc.cfg.replace(detect=dataclasses.replace(
        sc.cfg.detect, survivor_k=K_MAX, precise_survivor_cap=n * K_MAX - 1))
    sc._grow_slots(1)
    assert sc.cfg.detect.survivor_k == K_MAX
    assert sc.cfg.survivor_cap == n * K_MAX
    sc._grow_slots(1)                    # at both ceilings: counted, kept
    assert sc.cfg.survivor_cap == n * K_MAX


# ---- predict's self-heals (port only) -----------------------------------------

def test_predict_k_slots_heal():
    """The fused predict path doubles k_slots after a call with an
    uncertified slot overflow, and the next call runs at the new k."""
    n = 300
    # without the hot top-up every uncertified truncation stays counted
    cfg = retune_cfg(n=n).replace(detect=DetectionConfig(mode="fast",
                                                         hot_topup=0))
    sc = Scene(cfg, backend="fused", device="cpu",
               state=converging_cluster(n, n, width=80.0, seed=9))
    for _ in range(3):
        sc.step()
        sc.record_trajectories()
    seen = []
    real = scene_mod._predict_device_fused

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen.append((kw["k_slots"], int(res[7])))
        return res

    scene_mod._predict_device_fused = spy
    try:
        risks = sc.predict()
        sc.predict()
    finally:
        scene_mod._predict_device_fused = real
    assert seen[0][0] == 8 and seen[0][1] > 0      # slot_oflow at k 8
    assert seen[1][0] == 16 and sc._predict_slots >= 16
    assert sc.window_regrows >= 1 and len(risks) > 0


def test_predict_out_of_memory_retry():
    """A bucket heal whose capacity then runs out of device memory reverts
    to the capacity that ran, records the ceiling and retries once; an
    out-of-memory error with no heal to revert is raised."""
    n = 200
    sc = Scene(retune_cfg(n=n, cap=4), backend="xla", device="cpu",
               state=converging_cluster(n, 150, width=60.0, seed=10))
    for _ in range(2):
        sc.record_trajectories()
        sc.state = sc._step(sc.state, sc._gen)[0]
    sc.predict()                          # truncated buckets: heal to exact
    healed = sc.cfg.grid.cell_capacity
    assert healed > 4 and sc._predict_cap_prev == 4
    real = scene_mod._predict_device
    calls = []

    def once(*a, **kw):
        calls.append(a[2].grid.cell_capacity)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("injected")
        return real(*a, **kw)

    scene_mod._predict_device = once
    try:
        sc.predict()
        assert calls == [healed, 4]
        assert sc.cfg.grid.cell_capacity == 4
        assert sc._predict_heal_ceiling == healed
        calls.clear()
        with pytest.raises(torch.OutOfMemoryError):
            sc.predict()                  # nothing to revert to: raised
    finally:
        scene_mod._predict_device = real


def test_host_copy_round_trip():
    """core/device.to_host and to_host_async land f32 (by its bits), int32
    and bool tensors of any shape in one copy, and refuse other dtypes."""
    from tpu_collide_torch.core.device import to_host, to_host_async
    x = torch.tensor([[1.5, -0.0], [float("inf"), float("nan")]])
    ts = [x, torch.tensor(7, dtype=torch.int32),
          torch.tensor([True, False, True]), torch.arange(4, dtype=torch.int32)]
    for got in (to_host(ts), to_host_async(ts).wait()):
        for g, t in zip(got, ts):
            assert g.dtype == t.numpy().dtype and g.shape == tuple(t.shape)
            assert g.tobytes() == t.numpy().tobytes()
    with pytest.raises(TypeError):
        to_host([torch.zeros(2, dtype=torch.float64)])
