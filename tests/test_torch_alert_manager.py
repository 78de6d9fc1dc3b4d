"""The port's AlertManager (tpu_collide_torch/alerts/manager.py) against
the JAX package's: the same fleet's alert batch, from each package's own
reference-shaped detection, gives the same (vehicle, other) -> (risk, ttc,
priority) map and the same stats; the host-side lifecycle (lazy re-queue,
pump, priorities of host CollisionRisks) behaves as the JAX one's."""
import asyncio

import numpy as np
import torch

from tpu_collide.alerts.extract import extract_alerts as jax_extract
from tpu_collide.alerts.manager import AlertManager as JaxAlertManager
from tpu_collide.core.types import CollisionRisk as JaxRisk
from tpu_collide.engine import make_detect as jax_make_detect
import tpu_collide_torch as tt
from tpu_collide_torch.alerts.extract import extract_alerts
from tpu_collide_torch.alerts.manager import AlertManager
from tpu_collide_torch.api.scene import HostAlerts
from tpu_collide_torch.core.types import CollisionRisk
from tests.torch_parity import both_states, jax_cfg, np_fleet, to_torch_cfg

torch.set_num_threads(1)


def pair_map(manager):
    return {(a.vehicle_id, a.other_vehicle_id):
            (a.risk_level, a.time_to_collision, a.priority)
            for a in manager.alerts.values()}


def assert_pair_maps_equal(want, got):
    """Same pairs; risk and ttc at rtol = atol = 1e-5; priority exact."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k][:2], want[k][:2], rtol=1e-5,
                                   atol=1e-5, err_msg=str(k))
        assert got[k][2] == want[k][2], k


def both_batches(n=400, seed=3):
    cfg = jax_cfg(n)
    jst, st = both_states(np_fleet(seed, n, 2000.0))
    jb = jax_extract(jst, jax_make_detect(cfg)(jst), cfg)
    tcfg = to_torch_cfg(cfg)
    tb = extract_alerts(st, tt.make_detect(tcfg, device="cpu")(st), tcfg)
    return cfg, tcfg, jb, tb


def test_process_batch_matches_jax():
    cfg, tcfg, jb, tb = both_batches()
    jm, tm = JaxAlertManager(cfg), AlertManager(tcfg)
    jm.process_batch(jb)
    touched = tm.process_batch(tb)
    assert len(touched) == int(tb.count) > 10
    assert_pair_maps_equal(pair_map(jm), pair_map(tm))
    assert tm.get_stats() == jm.get_stats()
    # the same batch again updates every alert, creates none
    jm.process_batch(jb)
    tm.process_batch(tb)
    assert tm.get_stats() == jm.get_stats()


def test_process_batch_takes_host_columns():
    """A batch already on the host (numpy columns) passes through the same
    way as the torch batch it came from."""
    _, tcfg, _, tb = both_batches(n=300, seed=4)
    host = HostAlerts(*(getattr(tb, f).numpy() for f in HostAlerts._fields))
    a, b = AlertManager(tcfg), AlertManager(tcfg)
    a.process_batch(tb)
    b.process_batch(host)
    assert pair_map(a) == pair_map(b) and a.get_stats() == b.get_stats()


def test_upsert_priority_change_lazy_requeue():
    """The port case of tests/test_alerts.py's: priority changes re-queue
    lazily, pump() delivers each alert once with its last priority, and
    the queue stays bounded between pumps."""
    m = AlertManager(tt.SystemConfig(num_objects=10))
    for i in range(100):
        m._upsert(f"v{i}", f"o{i}", 0.65, 6.0, 10.0, 1)
    for _ in range(5):                       # 1000 priority flips
        for i in range(100):
            m._upsert(f"v{i}", f"o{i}", 0.85, 2.0, 5.0, 3)
            m._upsert(f"v{i}", f"o{i}", 0.65, 6.0, 10.0, 1)
    assert len(m.alerts) == 100
    assert len(m._queue) <= 2 * len(m.alerts) + 64   # compaction bound
    sent = asyncio.run(m.pump())
    assert len(sent) == 100                  # once per alert, not per dupe
    assert len({a.id for a in sent}) == 100
    assert all(a.priority == 1 for a in sent)        # last update wins
    assert len(m._queue) == 100              # unique after the pump


def test_process_collision_risks_priorities_match_jax():
    """Priorities of host CollisionRisks on and around every threshold of
    the priority rules (risk 0.3 / 0.6 / 0.8, ttc 3 / 5)."""
    risks = [0.2999, 0.3, 0.5, 0.6, 0.7, 0.7999, 0.8, 0.95, 1.0]
    ttcs = [0.5, 2.9999, 3.0, 4.0, 4.9999, 5.0, 8.0, float("inf")]
    cfg = jax_cfg(10)
    jm, tm = JaxAlertManager(cfg), AlertManager(to_torch_cfg(cfg))
    for i, r in enumerate(risks):
        for j, t in enumerate(ttcs):
            kw = dict(risk_level=r, time_to_collision=t, distance=3.0)
            jm.process_collision_risks([JaxRisk.new(f"v{i}", f"o{j}", **kw)])
            tm.process_collision_risks([CollisionRisk.new(f"v{i}", f"o{j}",
                                                          **kw)])
    assert tm.get_stats() == jm.get_stats()
    assert tm.get_stats()["dropped_low_risk"] == len(ttcs)
    assert {k: v[2] for k, v in pair_map(tm).items()} == \
        {k: v[2] for k, v in pair_map(jm).items()}
    assert set(v[2] for v in pair_map(tm).values()) == {0, 1, 2, 3}


def test_callbacks_deliver_and_broker_is_refused():
    m = AlertManager(tt.SystemConfig(num_objects=10))
    got, everyone = [], []
    m.register_callback("v1", got.append)
    m.register_callback(None, everyone.append)
    m._upsert("v1", "o1", 0.9, 2.0, 3.0, 3)
    m._upsert("v2", "o2", 0.5, 6.0, 9.0, 0)
    sent = asyncio.run(m.pump(now=100.0))
    assert [a.vehicle_id for a in got] == ["v1"]
    assert [a.vehicle_id for a in everyone] == ["v1", "v2"]  # priority order
    assert m.get_stats()["sent"] == len(sent) == 2

    # given a broker, the same pump also publishes each alert on
    # TOPIC_ALERTS, as the JAX manager does
    from tpu_collide_torch.runtime.messaging import (MessageBroker,
                                                     TOPIC_ALERTS)

    async def through_broker():
        broker = MessageBroker()
        heard = []

        async def on_alert(msg):
            heard.append(msg)

        broker.subscribe(TOPIC_ALERTS, on_alert)
        await broker.start()
        try:
            mb = AlertManager(tt.SystemConfig(num_objects=10), broker=broker)
            mb._upsert("v1", "o1", 0.9, 2.0, 3.0, 3)
            await mb.pump(now=100.0)
            for _ in range(200):
                if heard:
                    break
                await asyncio.sleep(0.01)
        finally:
            await broker.stop()
        return heard, mb

    heard, mb = asyncio.run(through_broker())
    assert [(h.key, h.value["other_vehicle_id"], h.value["priority"])
            for h in heard] == [("v1", "o1", 3)]
    assert heard[0].value["id"] == next(iter(mb.alerts))
