"""Bitonic co-sort: several [N] operands sorted by an int32 key.

The port of .probe/block_sort.py::co_sort, the staged Pallas bitonic
co-sort the JAX package once offered as an alternative to the cell-list
build's multi-operand `lax.sort`. `co_sort(ops)` sorts every operand by
ops[0] ascending, like `lax.sort(ops, num_keys=1, is_stable=False)` up to
tie order.

Both versions here run the standard bitonic network over the operands
padded to the next power of two (key INT32_MAX, payload 0): for merge size
k = 2..npad and exchange distance j = k/2..1, element e and its partner
e ^ j (e & j == 0) swap when strictly out of order for e's direction,
ascending where bit k of e is 0. The output depends only on the keys and
that network, not on how its stages are grouped into passes, so the CUDA
kernel, the plain version and the JAX function agree bit for bit, tie order
included.

`co_sort` launches the CUDA kernel (csrc/block_sort.cu) for tensors on a
CUDA device and counts the launch in `co_sort.launches`; for tensors on the
CPU it runs `co_sort_plain`, which runs the network stage by stage as
reshape-and-where passes over all operands, as the JAX function's
cross-block `_xla_stage` does.

The CUDA kernel groups the stages into passes over tiles of 2^TILE_BITS
(key, position) pairs: `launch_plan` lists its passes and
`strided_tile_index` is the index map of the strided tiles that run the
stages j >= tile of a merge; both are tested on the CPU, the kernel itself
on the card (chip_smoke.py).
"""
from __future__ import annotations

import ctypes

import torch

INT32_MAX = 2 ** 31 - 1
MAX_PAYLOADS = 32            # csrc/block_sort.cu MAX_PAYLOADS
MAX_PAD = 1 << 30            # the kernel's largest padded length
PAYLOAD_DTYPES = (torch.float32, torch.int32)


TILE_BITS = 12               # csrc/block_sort.cu TB: log2 pairs per tile
STAGE_BITS_MAX = 8           # csrc/block_sort.cu HB_MAX: stage bits a pass


def strided_tile_index(block, slot, lo_bit: int, hb: int,
                       tile_bits: int = TILE_BITS):
    """The global index of slot `slot` of tile `block` in the pass that runs
    the stages along index bits [lo_bit, lo_bit + hb), lo_bit >= tile_bits
    (ints or integer arrays). A tile holds every value of those hb bits
    (slot bits run..tile_bits-1) and of the run = tile_bits - hb lowest
    index bits (slot bits 0..run-1: 2^run consecutive pairs); the block
    number supplies the mid = lo_bit - run bits between them and the bits
    above lo_bit + hb. So a tile holds the partner e ^ j of each of its
    elements at every stage it runs, and the tiles partition the range."""
    run = tile_bits - hb
    mid = lo_bit - run
    return (((block >> mid) << (lo_bit + hb)) | ((slot >> run) << lo_bit)
            | ((block & ((1 << mid) - 1)) << run) | (slot & ((1 << run) - 1)))


def launch_plan(npad: int, tile_bits: int = TILE_BITS,
                stage_bits_max: int = STAGE_BITS_MAX) -> list:
    """The kernel's passes over npad = 2^p elements, in order:
    ("prefix",): every stage with k <= tile; then for each merge k = 2^L
    above the tile ("strided", L, lo_bit, hb): its stages along bits
    lo_bit + hb - 1 .. lo_bit, all of them in one pass where L - tile_bits
    <= stage_bits_max; and ("tile", L): its stages j < tile. The last pass
    also writes the sorted keys and gathers the payloads."""
    plan = [("prefix",)]
    L = tile_bits + 1
    while (1 << L) <= npad:
        hi = L
        while hi > tile_bits:
            hb = min(stage_bits_max, hi - tile_bits)
            hi -= hb
            plan.append(("strided", L, hi, hb))
        plan.append(("tile", L))
        L += 1
    return plan


def ceil_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def network_stages(npad: int) -> list:
    """The (j, k) stages of the bitonic network over npad elements, in
    order."""
    out = []
    k = 2
    while k <= npad:
        j = k // 2
        while j >= 1:
            out.append((j, k))
            j //= 2
        k *= 2
    return out


def _check(ops) -> int:
    if not ops:
        raise ValueError("co_sort needs at least the key operand")
    key = ops[0]
    n = key.shape[0] if key.dim() == 1 else -1
    if key.dtype != torch.int32:
        raise ValueError(f"co_sort: the key must be int32, got {key.dtype}")
    for i, x in enumerate(ops):
        if x.dim() != 1 or x.shape[0] != n or x.device != key.device:
            raise ValueError(
                f"co_sort: operand {i} must be [{n}] on {key.device}, got "
                f"{tuple(x.shape)} on {x.device}")
        if i and x.dtype not in PAYLOAD_DTYPES:
            raise ValueError(f"co_sort: payload {i} must be float32 or "
                             f"int32, got {x.dtype}")
    if len(ops) - 1 > MAX_PAYLOADS:
        raise ValueError(f"co_sort takes at most {MAX_PAYLOADS} payloads")
    if ceil_pow2(n) > MAX_PAD:
        raise ValueError(f"co_sort takes at most {MAX_PAD} elements")
    return n


def co_sort(ops, block_elems: int | None = None,
            force: bool = False) -> tuple:
    """Every [N] operand sorted by ops[0] (int32) ascending; payloads are
    float32 or int32. CUDA tensors launch the kernel or raise; CPU tensors
    take co_sort_plain. `block_elems` and `force` are the JAX function's
    staging options, accepted and ignored: the output does not depend on
    the staging, and the port runs the network at every N."""
    _check(ops)
    dev = ops[0].device
    if dev.type == "cuda":
        out = _launch(ops)
        co_sort.launches += 1
        return out
    if dev.type == "cpu":
        return co_sort_plain(ops)
    raise ValueError(f"co_sort has no kernel for device {dev}")


co_sort.launches = 0


def kernel_launches(n: int) -> int:
    """The device launches one co_sort of n > 0 elements makes, as the built
    library counts them (len(launch_plan(npad)))."""
    from tpu_collide_torch.kernels._build import load_library
    return load_library().tc_co_sort_launches(max(2, ceil_pow2(n)))


def _launch(ops) -> tuple:
    from tpu_collide_torch.kernels._build import load_library

    n = ops[0].shape[0]
    dev = ops[0].device
    ops = [x if x.is_contiguous() else x.contiguous() for x in ops]
    if n == 0:
        return tuple(torch.empty_like(x) for x in ops)
    # one allocation for the outputs of each type (at 100k the host's time
    # to set a sort up exceeds the card's time to run it): every output is
    # a row of one of the two
    is_int = [x.dtype == torch.int32 for x in ops]
    n_int = sum(is_int)
    ints = iter(torch.empty((n_int, n), dtype=torch.int32,
                            device=dev).unbind(0))
    floats = iter(torch.empty((len(ops) - n_int, n), dtype=torch.float32,
                              device=dev).unbind(0))
    outs = [next(ints if i else floats) for i in is_int]
    npad = max(2, ceil_pow2(n))
    # one buffer of npad (key, position) pairs; the C interface takes its
    # two halves
    scratch = torch.empty((2 * npad,), dtype=torch.int32, device=dev)
    keys, pos = scratch[:npad], scratch[npad:]
    n_pay = len(ops) - 1
    src = (ctypes.c_void_p * max(1, n_pay))(
        *[x.data_ptr() for x in ops[1:]])
    dst = (ctypes.c_void_p * max(1, n_pay))(
        *[x.data_ptr() for x in outs[1:]])
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tc_co_sort(ops[0].data_ptr(), n, npad, n_pay, src, dst,
                            outs[0].data_ptr(), keys.data_ptr(),
                            pos.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"co_sort kernel launch failed: CUDA error {rc} "
            f"({lib.tc_error_string(rc).decode()})")
    return tuple(outs)


def co_sort_plain(ops) -> tuple:
    """co_sort in plain PyTorch, on any device: the whole network, one
    reshape-and-where pass per (j, k) over every padded operand (payloads
    move as their int32 bit patterns, so values are copied exactly)."""
    n = _check(ops)
    dev = ops[0].device
    npad = ceil_pow2(n)
    x = torch.zeros((len(ops), npad), dtype=torch.int32, device=dev)
    x[0, n:] = INT32_MAX
    for i, op in enumerate(ops):
        x[i, :n] = op.view(torch.int32)
    for j, k in network_stages(npad):
        g = npad // (2 * j)
        v = x.view(len(ops), g, 2, j)
        a, b = v[:, :, 0], v[:, :, 1]
        o = torch.arange(g, dtype=torch.int64, device=dev)[:, None]
        asc = ((o * (2 * j)) & k) == 0
        swap = torch.where(asc, a[0] > b[0], a[0] < b[0])
        x = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                        dim=2).view(len(ops), npad)
    return tuple(x[i, :n].contiguous().view(op.dtype)
                 for i, op in enumerate(ops))
