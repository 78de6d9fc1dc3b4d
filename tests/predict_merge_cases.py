"""Predict slot sets for the prediction's merge per row (kernels/refine.
merge_slots), made to break a merge, and the bitwise comparison of its
outputs: shared by the CPU tests of the plain merge and the card's tests of
the merge kernel. PyTorch only, no JAX."""
import torch


def adversarial_slots(n_off, m, k_slots, seed, device="cpu"):
    """(shape, at, vals) as fused_predict_rows hands them to merge_slots, made
    to break a merge. Rows by r % 8: every slot a hit (a full row), no slot
    (a halo mirror or a dead row), occupied slots that never hit, and rows
    at densities 0.02-0.6. Occupied slots are not packed to the front, so
    the slot index matters. Other ids come from six a row, so one id recurs
    across offsets and slots; risks lie on a grid of ninths, so equal risks
    sit in different columns."""
    g = torch.Generator(device=device).manual_seed(seed)
    dens = torch.tensor([1.0, 0.0, 0.3, 0.0, 0.02, 0.1, 0.25, 0.6],
                        device=device)[torch.arange(m, device=device) % 8]
    occ = torch.rand((n_off, m, k_slots), generator=g,
                     device=device) < dens[None, :, None]
    at = occ.nonzero(as_tuple=True)
    p = at[0].numel()
    draw = lambda hi: torch.randint(0, hi, (p,), generator=g, device=device)
    other = (at[1] * 7 + draw(6)).to(torch.int32)
    hit = ((draw(20) > 2) | (at[1] % 8 == 0)) & (at[1] % 8 != 2)
    zero = torch.zeros(p, device=device)
    inf = torch.full((p,), float("inf"), device=device)
    risk = torch.where(hit, draw(10).to(torch.float32) / 9.0, zero)
    ttc = torch.where(hit, torch.rand(p, generator=g, device=device) * 10,
                      inf)
    dist = torch.where(hit, torch.rand(p, generator=g, device=device) * 50,
                       inf)
    return occ.shape, at, (other, hit, risk, ttc, dist)


def assert_bits_equal(got, want):
    """Equal dtypes, shapes and bits, floats as raw bits."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
