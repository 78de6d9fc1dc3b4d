"""The port's twin of tools/big_mesh_dryrun.py
(tools/torch_big_mesh_dryrun.py) against the JAX package's single-device
step, on the CPU, where the fused backend takes the detection kernel's
plain version.

The deployment (tools/big_mesh_dryrun.py:104-115: 65,536 objects in 10 x 10
km, 655 a km^2) is cut in scale only: 419 objects in 800 x 800 m (655 a
km^2), so that the 100 m x-slabs of the 8x2 grid stay as wide as the search
radius; halo_capacity 128 for its 1,024 (26-52 objects a shard here, 4,096
there); one timed call after the first (the tool's default: 2).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import pytest
import torch

import tpu_collide as tc
from tpu_collide_torch.core.config import WorldConfig
from chip_smoke import load_tool
from tests.torch_parity import (alert_map, hand_out_fleet, jax_state_of,
                                jax_uniform_fleet, record_steps)

torch.set_num_threads(1)

tbm = load_tool("torch_big_mesh_dryrun")

MESH_N, MESH_WORLD = 419, WorldConfig(hi=(800.0, 800.0, 0.0))
# tools/big_mesh_dryrun.py's result keys (:117-160) when both sides' alert
# slots hold every alert
JAX_MESH_KEYS = {"devices", "grid", "n", "backend", "compile_s", "step_ms",
                 "risks", "alive", "dropped", "overflow", "alert_overflow",
                 "conserved", "risks_single", "single_overflow",
                 "risk_parity", "alert_set_equal"}


def small_deployment(dx, dy):
    cfg = tbm.deployment(MESH_N, dx, dy).replace(world=MESH_WORLD)
    return cfg.replace(shard=dataclasses.replace(cfg.shard,
                                                 halo_capacity=128))


@pytest.fixture(scope="module")
def mesh_reference():
    """The JAX fleet of the small deployment and the JAX package's
    single-device make_step(cfg, donate=False) (the xla backend) on it."""
    cfg = small_deployment(8, 2)
    d = jax_uniform_fleet(cfg)
    jcfg = tc.SystemConfig.from_json(cfg.to_json())
    _, out = tc.make_step(jcfg, donate=False)(jax_state_of(d),
                                              jax.random.key(1))
    assert int(out.overflow) == int(out.alert_overflow) == 0
    return d, int(out.num_risks), out.alerts


@pytest.mark.parametrize("backend", ["xla", "fused"])
@pytest.mark.parametrize("grid", ["8x2", "4x2"])
def test_big_mesh_dryrun_equals_the_jax_single_device_step(
        grid, backend, mesh_reference, monkeypatch):
    """The big-mesh twin on the small deployment: its own asserts pass, the
    result has exactly the JAX tool's keys, the run is conserved, and its
    risks and alert set equal the JAX package's single-device step (as
    ordered pairs on xla, unordered on fused, DEVIATIONS #10)."""
    d, jax_risks, jax_alerts = mesh_reference
    dx, dy = (int(v) for v in grid.split("x"))
    hand_out_fleet(monkeypatch, tbm, d)
    made = record_steps(monkeypatch, tbm, "make_sharded_step")
    res = tbm.dryrun(dx * dy, grid, MESH_N, backend, steps=1, device="cpu",
                     cfg=small_deployment(dx, dy))
    assert set(res) == JAX_MESH_KEYS
    assert res["conserved"] and res["alive"] == MESH_N and not res["dropped"]
    assert res["risks"] == res["risks_single"] == jax_risks > 0
    assert res["risk_parity"] and res["alert_set_equal"]
    unordered = backend == "fused"
    got = alert_map(made[0][1][0].alerts, unordered=unordered)
    assert set(got) == set(alert_map(jax_alerts, unordered=unordered))


def test_big_mesh_main_prints_the_jax_keys_and_the_card(capsys):
    """main() with --device cpu at the deployment's world: the printed line
    is the JAX tool's keys plus the card (None on the CPU)."""
    res = tbm.main(["--devices", "16", "--grid", "8x2", "--n", "300",
                    "--backend", "fused", "--steps", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == JAX_MESH_KEYS
    assert set(line) == JAX_MESH_KEYS | {"card"} and line["card"] is None
    assert line["conserved"] and line["risk_parity"]
