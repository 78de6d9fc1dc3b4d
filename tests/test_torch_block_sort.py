"""The port's bitonic co-sort (kernels/block_sort.py) on the CPU: the plain
version against the JAX function .probe/block_sort.py::co_sort in interpret
mode, every operand bit-equal, tie order included (both run the same
network, and its output does not depend on the staging). At small n, where
the JAX function falls back to lax.sort, keys and row multisets are
compared. Each interpret-mode call takes seconds here, so two cases run in
the quick tier and the rest in the slow one."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_collide_torch.kernels.block_sort import (co_sort, co_sort_plain,
                                                  network_stages)

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "block_sort", os.path.join(os.path.dirname(__file__), os.pardir,
                               ".probe", "block_sort.py"))
jax_block_sort = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_block_sort)


def _operands(seed, n, keys):
    """An int32 key (random in [0, 97), two-valued or all equal) and
    three payloads: two f32, one int32."""
    rng = np.random.default_rng(seed)
    key = {"random": rng.integers(0, 97, n),
           "two": rng.integers(0, 2, n),
           "equal": np.zeros(n)}[keys].astype(np.int32)
    return [key, rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.permutation(n).astype(np.int32)]


def _bits(a):
    return np.asarray(a).view(np.int32)


def _rows(ops):
    """The row multiset: rows sorted by every column's bits."""
    cols = [_bits(o) for o in ops]
    order = np.lexsort(tuple(reversed(cols)))
    return [c[order] for c in cols]


def _check_against_jax(n, block_elems, keys, seed=0):
    ops = _operands(seed, n, keys)
    want = jax_block_sort.co_sort(tuple(jnp.asarray(o) for o in ops),
                                  interpret=True, force=True,
                                  block_elems=block_elems)
    got = co_sort([torch.from_numpy(o) for o in ops])
    assert [g.dtype for g in got] == [torch.int32, torch.float32,
                                      torch.float32, torch.int32]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=f"operand {i}")


@pytest.mark.parametrize("n,block_elems,keys", [
    (5000, 2048, "random"),   # pad path, cross-block stages and tails
    (2500, 2048, "two"),      # pad path, two-valued keys: ties everywhere
])
def test_co_sort_plain_equals_jax(n, block_elems, keys):
    _check_against_jax(n, block_elems, keys)


@pytest.mark.slow
@pytest.mark.parametrize("n,block_elems,keys", [
    (4096, 2048, "equal"),     # one block, every key tied
    (16384, 2048, "random"),   # three levels of cross-block stages
    (30000, 4096, "random"),   # pad path, larger block
])
def test_co_sort_plain_equals_jax_slow(n, block_elems, keys):
    _check_against_jax(n, block_elems, keys)


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
def test_co_sort_small_n(n):
    """Where the JAX function falls back to lax.sort (unstable), only the
    sorted keys and the row multisets must agree."""
    ops = _operands(3, n, "random")
    want = jax_block_sort.co_sort(tuple(jnp.asarray(o) for o in ops))
    got = [g.numpy() for g in co_sort([torch.from_numpy(o) for o in ops])]
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[0], np.sort(ops[0]))
    for a, b in zip(_rows(got), _rows(ops)):
        np.testing.assert_array_equal(a, b)


def test_network_and_wrapper_contract():
    """The network's stage count, the CPU route to the plain version (no
    launch counted), and the inputs the wrapper refuses."""
    assert len(network_stages(1 << 20)) == 20 * 21 // 2
    assert network_stages(1) == []
    key = torch.tensor([3, 1, 2], dtype=torch.int32)
    pay = torch.tensor([0.5, 1.5, 2.5])
    before = co_sort.launches
    out = co_sort([key, pay])
    assert co_sort.launches == before
    assert out[0].tolist() == [1, 2, 3] and out[1].tolist() == [1.5, 2.5, 0.5]
    assert all(torch.equal(a, b)
               for a, b in zip(out, co_sort_plain([key, pay])))
    for bad in ([key.to(torch.int64), pay], [key, pay.to(torch.float64)],
                [key, pay[:2]], [key.reshape(3, 1)], [],
                [key.to("meta"), pay.to("meta")]):
        with pytest.raises(ValueError):
            co_sort(bad)
