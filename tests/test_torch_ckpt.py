"""The port's checkpoints (tpu_collide_torch/ckpt/checkpoint.py) keep the
JAX package's on-disk format: a checkpoint written by either package
restores in the other with every field bit-equal. Plus the port cases of
tests/test_async_ckpt.py: the async snapshot captures the state at save
time while stepping goes on, a background failure surfaces, and a second
async save joins the first."""
import numpy as np
import pytest
import torch

from tpu_collide.ckpt.checkpoint import CheckpointManager as JaxCkpt
from tpu_collide.core.state import ObjectState as JaxState
import tpu_collide_torch as tt
from tpu_collide_torch.api import Scene
from tpu_collide_torch.ckpt import BackupManager, CheckpointManager
from tpu_collide_torch.core.state import FIELDS
from tpu_collide_torch.sim import generate_fleet
from tests.torch_parity import both_states, np_fleet

torch.set_num_threads(1)


def state_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def assert_bit_equal(want, got):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].shape == want[f].shape, f
        assert got[f].tobytes() == want[f].tobytes(), f


def small_fleet(n=256, seed=0):
    cfg = tt.SystemConfig(num_objects=n)
    return cfg, generate_fleet(torch.Generator().manual_seed(seed), cfg)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    d = np_fleet(11, 300, 2000.0, dead=20)
    jst, st = both_states(d)
    meta = {"ids": {"carA": 0, "carB": 1}}
    if writer == "jax":
        JaxCkpt(str(tmp_path)).save(jst, 7, metadata=meta)
        got, m = CheckpointManager(str(tmp_path)).restore(device="cpu")
        assert isinstance(got, tt.ObjectState) and got.device.type == "cpu"
        assert_bit_equal(state_arrays(jst), got.to_numpy())
    else:
        CheckpointManager(str(tmp_path)).save(st, 7, metadata=meta)
        got, m = JaxCkpt(str(tmp_path)).restore()
        assert isinstance(got, JaxState)
        assert_bit_equal(st.to_numpy(), state_arrays(got))
    assert m["step"] == 7 and m["metadata"] == meta
    assert m["num_objects"] == 280 and m["capacity"] == 300


def test_scene_async_checkpoint_roundtrip(tmp_path):
    cfg, fleet = small_fleet()
    sc = Scene(cfg, checkpoint_dir=str(tmp_path), device="cpu")
    sc.adopt_fleet(fleet)
    sc.step(2)
    expected = sc.state.to_numpy()
    at_step = sc.step_count

    t = sc.save_checkpoint_async()
    # keep stepping at once: the worker drains the clone taken at save time
    sc.step(3)
    sc.ckpt.wait_async()
    assert not t.is_alive()
    assert sc.ckpt.stats["async_saves"] == 1

    sc.restore_checkpoint()
    assert sc.step_count == at_step
    assert_bit_equal(expected, sc.state.to_numpy())


def test_scene_async_saves_back_to_back(tmp_path):
    """Async saves one after another on a Scene all complete: a save joins
    the previous one's worker before it takes the device lock that worker
    needs for its copy."""
    import threading
    cfg, fleet = small_fleet(64)
    sc = Scene(cfg, state=fleet, checkpoint_dir=str(tmp_path), device="cpu")

    def saves():
        for i in range(20):
            sc.step_count = i
            sc.save_checkpoint_async()
        sc.ckpt.wait_async()

    t = threading.Thread(target=saves, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert sc.ckpt.stats["async_saves"] == 20
    assert sc.ckpt.list_checkpoints() == list(range(15, 20))


def test_async_save_failure_surfaces(tmp_path):
    _, state = small_fleet(64)
    ck = CheckpointManager(str(tmp_path))
    # break the directory AFTER construction: a plain file where the
    # checkpoint dir should go makes the background write fail
    ck.directory = str(tmp_path / "not_a_dir")
    with open(ck.directory, "w") as fh:
        fh.write("x")
    ck.save_async(state, 1)
    with pytest.raises(OSError):
        ck.wait_async()


def test_second_async_save_joins_first(tmp_path):
    _, state = small_fleet(64)
    ck = CheckpointManager(str(tmp_path))
    ck.save_async(state, 1)
    ck.save_async(state, 2)        # joins the first before starting
    ck.wait_async()
    assert ck.list_checkpoints() == [1, 2]
    st, meta = ck.restore(device="cpu")
    assert meta["step"] == 2
    assert_bit_equal(state.to_numpy(), st.to_numpy())


def test_keep_last_and_backups(tmp_path):
    _, state = small_fleet(16)
    ck = CheckpointManager(str(tmp_path / "ck"), keep_last=2)
    for s in range(4):
        ck.save(state, s)
    assert ck.list_checkpoints() == [2, 3] and ck.stats["cleaned"] == 2
    assert ck.delete(2) and ck.latest_step() == 3
    bm = BackupManager(str(tmp_path / "bk"))
    box = {"x": 1}
    bm.register_source("box", lambda: dict(box), box.update)
    bm.create_backup()
    box["x"] = 5
    assert bm.restore_backup() == ["box"] and box["x"] == 1
