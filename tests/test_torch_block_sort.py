"""The port's bitonic co-sort (kernels/block_sort.py) on the CPU: the plain
version against the JAX function .probe/block_sort.py::co_sort in interpret
mode, every operand bit-equal, tie order included (both run the same
network, and its output does not depend on the staging). At small n, where
the JAX function falls back to lax.sort, keys and row multisets are
compared. Each interpret-mode call takes seconds here, so two cases run in
the quick tier and the rest in the slow one.

The CUDA kernel runs only on the card; what it shares with the CPU is its
plan of passes and the index map of its strided tiles (launch_plan,
strided_tile_index). Both are checked here: the map as a map, and the plan
by running it in numpy, pass by pass and tile by tile, against the plain
version."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_collide_torch.kernels.block_sort import (INT32_MAX, STAGE_BITS_MAX,
                                                  TILE_BITS, ceil_pow2,
                                                  co_sort, co_sort_plain,
                                                  launch_plan,
                                                  network_stages,
                                                  strided_tile_index)

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


@pytest.mark.parametrize("L", range(TILE_BITS + 1, 22))
def test_strided_tiles_partition_and_hold_their_partners(L):
    """Every strided pass of the merge k = 2^L, over 2^L elements and (the
    block number's high part) over 2^(L+2): the tiles are a bijection of
    the padded range, every tile holds the partner e ^ j of each of its
    elements at every stage it runs, one direction (bit L of the index)
    holds over a whole tile, and its runs are at least 16 consecutive
    pairs. Together the passes of a merge run each bit L-1..TILE_BITS
    once, highest first."""
    tile = 1 << TILE_BITS
    slot = np.arange(tile, dtype=np.int64)[None, :]
    passes = [p for p in launch_plan(1 << L) if p[0] == "strided"
              and p[1] == L]
    bits = [b for _, _, lo, hb in passes for b in range(lo + hb - 1, lo - 1,
                                                        -1)]
    assert bits == list(range(L - 1, TILE_BITS - 1, -1))
    assert len(passes) == -(-(L - TILE_BITS) // STAGE_BITS_MAX)
    for npad in (1 << L, 1 << min(L + 2, 21)):
        block = np.arange(npad // tile, dtype=np.int64)[:, None]
        for _, _, lo, hb in passes:
            g = strided_tile_index(block, slot, lo, hb)
            assert g.shape == (npad // tile, tile)
            np.testing.assert_array_equal(np.sort(g.reshape(-1)),
                                          np.arange(npad))
            own = np.sort(g, axis=1)
            for b in range(lo, lo + hb):
                np.testing.assert_array_equal(
                    np.sort(g ^ (1 << b), axis=1), own)
                # the partner sits at the slot with that stage's bit flipped
                sb = TILE_BITS - hb + (b - lo)
                np.testing.assert_array_equal(
                    g[:, (slot ^ (1 << sb))[0]], g ^ (1 << b))
            assert ((g & (1 << L)) == (g[:, :1] & (1 << L))).all()
            run = 1 << (TILE_BITS - hb)
            assert run >= 16
            runs = g.reshape(npad // tile, -1, run)
            assert (runs == runs[:, :, :1] + np.arange(run)).all()


def _run_plan(key, tile_bits, stage_bits_max):
    """The kernel's schedule in numpy: (sorted keys, source positions) of
    the first len(key) outputs. A short input is one tile padded to the
    tile; a pair swaps on the key alone, its direction from bit k of the
    GLOBAL index of its lower element."""
    n = key.shape[0]
    tile = 1 << tile_bits
    npad = max(ceil_pow2(n), tile)
    K = np.full(npad, INT32_MAX, np.int64)
    K[:n] = key
    P = np.arange(npad)

    def stages(g, slot_bits, k):
        """On the tiles g [blocks, tile] of global indices: the stages
        along these slot bits, in order."""
        a, b = K[g], P[g]
        for sb in slot_bits:
            j = 1 << sb
            shape = (g.shape[0], tile // (2 * j), 2, j)
            ka, pa, ga = (x.reshape(shape) for x in (a, b, g))
            lo, hi = ka[:, :, 0], ka[:, :, 1]
            asc = (ga[:, :, 0] & k) == 0
            swap = np.where(asc, lo > hi, lo < hi)[:, :, None, :]
            a = np.where(swap, ka[:, :, ::-1], ka).reshape(g.shape)
            b = np.where(swap, pa[:, :, ::-1], pa).reshape(g.shape)
        K[g], P[g] = a, b

    blocks = np.arange(npad // tile)[:, None]
    slot = np.arange(tile)[None, :]
    plain = blocks * tile + slot
    for step in launch_plan(npad, tile_bits, stage_bits_max):
        if step[0] == "prefix":
            for L in range(1, tile_bits + 1):
                stages(plain, range(L - 1, -1, -1), 1 << L)
        elif step[0] == "tile":
            stages(plain, range(tile_bits - 1, -1, -1), 1 << step[1])
        else:
            _, L, lo, hb = step
            g = strided_tile_index(blocks, slot, lo, hb, tile_bits)
            stages(g, range(tile_bits - 1, tile_bits - hb - 1, -1), 1 << L)
    return K[:n].astype(np.int32), P[:n]


@pytest.mark.parametrize("n,tile_bits,stage_bits_max,keys", [
    (3000, 6, 2, "cells"),    # npad 4096: three strided passes in a merge
    (3000, 6, 2, "equal"),    # any deviation from the network moves a row
    (2049, 6, 2, "max"),      # real INT32_MAX keys tie with the pads
    (5, 6, 2, "max"),         # shorter than a tile: one padded tile
    (64, 6, 2, "cells"),      # exactly one tile
    (129, 5, 1, "cells"),     # one stage bit per strided pass
    (2 * 4096 + 5, TILE_BITS, STAGE_BITS_MAX, "cells"),   # the real tile
])
def test_launch_plan_runs_the_network(n, tile_bits, stage_bits_max, keys):
    """The plan, run in numpy, gives co_sort_plain's permutation exactly."""
    rng = np.random.default_rng(n)
    key = {"cells": rng.integers(0, max(2, n // 7), n),
           "equal": np.full(n, 3),
           "max": np.where(rng.random(n) < 0.3, INT32_MAX,
                           rng.integers(0, 5, n))}[keys].astype(np.int32)
    want = co_sort_plain([torch.from_numpy(key),
                          torch.arange(n, dtype=torch.int32)])
    got_key, got_pos = _run_plan(key, tile_bits, stage_bits_max)
    np.testing.assert_array_equal(got_key, want[0].numpy())
    # a pad that sorted before a real INT32_MAX row reads as payload 0
    np.testing.assert_array_equal(np.where(got_pos < n, got_pos, 0),
                                  want[1].numpy())


def test_launch_plan_counts():
    """One pass for a single tile; all global stages of a merge in one pass
    up to 2^20 (17 passes at 1M, 11 at 2^17), two for the last merge of
    2^21."""
    assert launch_plan(2) == launch_plan(1 << TILE_BITS) == [("prefix",)]
    assert len(launch_plan(1 << 17)) == 11
    assert len(launch_plan(1 << 20)) == 17
    assert len(launch_plan(1 << 21)) == 20
    assert launch_plan(1 << 21)[-3:] == [("strided", 21, 13, 8),
                                         ("strided", 21, 12, 1),
                                         ("tile", 21)]
