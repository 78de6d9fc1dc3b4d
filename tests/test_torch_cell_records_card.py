"""The cell list's record kernel (csrc/cell_records.cu) against its plain
version (kernels/cell_list.cell_records_plain, the gathers and torch.cat) on
a CUDA card: fields as raw bits and oids equal, 2D and 3D fleets of 1,
1,000, 100k and 1M rows with and without cls, headings of 0, +-pi, +-pi/2
and +-1e4 among them, dead rows and halo-marked oids; build_cell_list's
records through the kernel; and the wrapper's refusals. Off the card every
test skips. This file imports no JAX, so that it runs on the card's
machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cell_records_card.py
"""
import math

import pytest
import torch

from tpu_collide_torch.core.config import GridConfig, SystemConfig, \
    WorldConfig
from tpu_collide_torch.core.state import ObjectState
from tpu_collide_torch.kernels.cell_list import (build_cell_list,
                                                 cell_records,
                                                 cell_records_plain)

pytestmark = pytest.mark.card

EDGE_HEADINGS = (0.0, math.pi, -math.pi, math.pi / 2, -math.pi / 2, 1e4,
                 -1e4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the record kernel has no CPU or "
                    "interpret mode")
    return torch.device("cuda", 0)


def fleet(n, is3d, seed, dev):
    """A state of n objects drawn on `dev`: a tenth dead, every seventh oid
    marked as a halo mirror's, the edge headings first."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)
    pos = u(n, 3) * 1000.0
    vel = (u(n, 3) - 0.5) * 40.0
    acc = (u(n, 3) - 0.5) * 2.0
    if not is3d:
        for x in (pos, vel, acc):
            x[:, 2] = 0.0
    heading = (u(n) - 0.5) * (2 * math.pi)
    edge = torch.tensor(EDGE_HEADINGS, dtype=torch.float32, device=dev)
    heading[:min(n, edge.numel())] = edge[:n]
    otype = torch.randint(0, 4, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    size = torch.tensor([2.0, 4.0, 5.0, 1.0], device=dev)[otype]
    oid = torch.arange(n, dtype=torch.int32, device=dev)
    oid = torch.where(oid % 7 == 3, -(oid + 2), oid)
    return ObjectState(pos=pos, vel=vel, acc=acc, heading=heading, size=size,
                       otype=otype, alive=u(n) >= 0.1, oid=oid)


def assert_kernel_is_plain(state, order, cls):
    """One launch of the kernel through cell_records, equal bit for bit to
    the plain version on the same device."""
    before = cell_records.launches
    fields, oid = cell_records(state, order, cls)
    want_fields, want_oid = cell_records_plain(state, order, cls)
    torch.cuda.synchronize()
    assert cell_records.launches == before + (state.n > 0)
    assert fields.shape == want_fields.shape and fields.is_contiguous()
    assert oid.dtype == torch.int32 and oid.shape == want_oid.shape
    assert torch.equal(fields.view(torch.int32),
                       want_fields.view(torch.int32))
    assert torch.equal(oid, want_oid)


@pytest.mark.parametrize("with_cls", [False, True])
@pytest.mark.parametrize("n", [1, 1000, 100_000, 1_000_000])
@pytest.mark.parametrize("is3d", [False, True])
def test_records_bit_equal(card, is3d, n, with_cls):
    state = fleet(n, is3d, n + is3d, card)
    g = torch.Generator(device=card).manual_seed(n)
    order = torch.randperm(n, generator=g, device=card)
    cls = (torch.randint(0, 5, (n,), generator=g, device=card,
                         dtype=torch.int32) if with_cls else None)
    assert_kernel_is_plain(state, order, cls)


@pytest.mark.parametrize("with_cls", [False, True])
@pytest.mark.parametrize("is3d", [False, True])
def test_build_cell_list_through_the_kernel(card, is3d, with_cls):
    """build_cell_list's records and oids are the plain version's at its
    own order, and the call launched the kernel once."""
    n = 100_000
    cfg = SystemConfig(
        num_objects=n,
        world=WorldConfig(hi=(1000.0, 1000.0, 1000.0 if is3d else 0.0)),
        grid=GridConfig(cell_size=100.0))
    state = fleet(n, is3d, 7, card)
    cls = (torch.randint(0, 5, (n,), device=card, dtype=torch.int32)
           if with_cls else None)
    before = cell_records.launches
    cl = build_cell_list(state, cfg, cls=cls)
    want_fields, want_oid = cell_records_plain(state, cl.order, cls)
    torch.cuda.synchronize()
    assert cell_records.launches == before + 1
    assert torch.equal(cl.fields.view(torch.int32),
                       want_fields.view(torch.int32))
    assert torch.equal(cl.oid, want_oid)


def test_no_rows(card):
    state = fleet(0, True, 0, card)
    assert_kernel_is_plain(state, torch.zeros(0, dtype=torch.int64,
                                              device=card), None)


def test_refusals(card):
    """What the kernel does not take raises, and nothing launches."""
    n = 64
    state = fleet(n, True, 1, card)
    order = torch.randperm(n, device=card)
    wide = torch.zeros((n, 6), device=card)
    bad = (
        (state.replace(pos=state.pos.double()), order, None),
        (state.replace(otype=state.otype.long()), order, None),
        (state, order.int(), None),
        (state, order[:n - 1], None),
        (state.replace(size=state.size[:, None]), order, None),
        (state, order, torch.zeros(n - 1, device=card)),
        (state.replace(vel=wide[:, ::2]), order, None),
        (state.replace(acc=state.acc.t().contiguous().t()), order, None),
        (state.replace(heading=state.heading.cpu()), order, None),
        (state.replace(oid=state.oid.cpu()), order, None),
    )
    before = cell_records.launches
    for args in bad:
        with pytest.raises(ValueError):
            cell_records(*args)
    assert cell_records.launches == before
