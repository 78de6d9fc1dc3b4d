"""The port's config and state against the JAX package's, and the port's
import boundary (torch only: no jax, no triton)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import tpu_collide as tc
from tpu_collide.core import config as jconfig
from tpu_collide.sim import generate_fleet as jax_generate_fleet
import tpu_collide_torch as tt
from tpu_collide_torch.core import config as tconfig
from tpu_collide_torch.core.state import (FIELDS, from_jax_numpy,
                                          state_from_numpy)
from tests.torch_parity import np_fleet

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "default": tc.SystemConfig(),
    "1m_3d": tc.SystemConfig(
        num_objects=1_000_000,
        world=jconfig.WorldConfig(hi=(10000.0, 10000.0, 500.0)),
        grid=jconfig.GridConfig(cell_size=50.0, band_cells=0),
        detect=jconfig.DetectionConfig(mode="fast", search_radius=50.0,
                                       count_checked=False,
                                       gate_stage1=True,
                                       precise_survivor_cap=12345),
        alerts=jconfig.AlertConfig(max_scene_alerts=4096),
        shard=jconfig.ShardConfig(num_shards=2, num_shards_y=2)),
}

DERIVED = ("grid_dims", "num_cells", "survivor_cap", "stencil_halfwidth",
           "stencil_size", "max_candidates")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_round_trip(name):
    jcfg = CONFIGS[name]
    tcfg = tt.SystemConfig.from_json(jcfg.to_json())
    assert json.loads(tcfg.to_json()) == json.loads(jcfg.to_json())
    for prop in DERIVED:
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.world.extent == jcfg.world.extent
    assert tcfg.world.is_3d == jcfg.world.is_3d
    assert tcfg.detect.num_time_steps == jcfg.detect.num_time_steps
    assert tcfg.shard.total_shards == jcfg.shard.total_shards
    assert tc.SystemConfig.from_json(tcfg.to_json()) == jcfg


@pytest.mark.parametrize("cls", ["WorldConfig", "GridConfig",
                                 "DetectionConfig", "AlertConfig",
                                 "SimConfig", "ShardConfig", "SystemConfig"])
def test_config_fields_and_defaults_match(cls):
    """Every field of the JAX package's config, with its default, in the
    same order; the port's own fields (tconfig.PORT_ONLY) left out of the
    comparison and holding their listed defaults."""
    port_only = {name: d for group in tconfig.PORT_ONLY.values()
                 for name, d in group.items()}

    def fields(mod):
        out = []
        for f in dataclasses.fields(getattr(mod, cls)):
            d = f.default
            if dataclasses.is_dataclass(d):
                d = dataclasses.asdict(d)
                for name in port_only:
                    d.pop(name, None)
            if mod is tconfig and f.name in port_only:
                assert d == port_only[f.name], f.name
                continue
            out.append((f.name, d))
        return out

    assert fields(tconfig) == fields(jconfig)
    assert dataclasses.is_dataclass(getattr(tconfig, cls))
    assert getattr(tconfig, cls).__dataclass_params__.frozen
    assert tconfig.VEHICLE_SIZES == jconfig.VEHICLE_SIZES
    assert tconfig.VEHICLE_TYPES == jconfig.VEHICLE_TYPES


def test_state_converter_round_trip():
    """JAX state -> numpy -> port state -> numpy keeps every field, value
    and dtype."""
    cfg = tc.SystemConfig(num_objects=64)
    jst = jax_generate_fleet(jax.random.key(3), cfg)
    jst = jst.replace(alive=jst.alive.at[5].set(False),
                      oid=jst.oid + 1000)
    d = {f: np.asarray(getattr(jst, f)) for f in FIELDS}
    st = from_jax_numpy(d, device="cpu")
    assert st.n == 64
    want_dtypes = dict(pos=torch.float32, vel=torch.float32,
                       acc=torch.float32, heading=torch.float32,
                       size=torch.float32, otype=torch.int32,
                       alive=torch.bool, oid=torch.int32)
    back = st.to_numpy()
    for f in FIELDS:
        assert getattr(st, f).dtype == want_dtypes[f], f
        assert back[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)
    with pytest.raises(ValueError, match="missing"):
        from_jax_numpy({"pos": d["pos"]})


def test_state_from_numpy_defaults_match_jax():
    from tpu_collide.core.state import state_from_numpy as jsfn
    d = np_fleet(0, 10, 500.0)
    args = [d[f] for f in ("pos", "vel", "acc", "heading", "size", "otype")]
    jst, st = jsfn(*args), state_from_numpy(*args, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)


def test_import_leaves_out_jax_and_triton():
    code = ("import json, sys; import tpu_collide_torch, "
            "tpu_collide_torch.engine, tpu_collide_torch.sim, "
            "tpu_collide_torch.kernels.fused_detect, "
            "tpu_collide_torch.kernels._build; "
            "print(json.dumps([m for m in ('jax', 'triton', 'tpu_collide') "
            "if m in sys.modules]))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
