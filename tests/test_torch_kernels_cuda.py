"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and ``nvcc``; without a card each one skips.
On the card, from the repository root (the suite's conftest imports JAX,
which the card's machine does not have):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Shapes are ragged on purpose: T below, at and just past one 2,048-sample
block, and row counts that fill no warp. Tolerances: 1e-5 in dB on K1 (both
versions compose in float64 and round once) and 1e-5 on K2's audio.
"""

import numpy as np
import pytest
import torch

from diffmst_torch.kernels import comp_fused, scan1p

pytestmark = pytest.mark.cuda

SR = 44100.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _alpha(gen, rows, dev):
    ms = 1.0 + 249.0 * torch.rand(rows, generator=gen)
    return torch.exp(-np.log(9.0) / (SR * ms / 1e3)).to(dev)


@pytest.mark.parametrize("rows,t", [(1, 1), (3, 100), (5, 2047), (2, 2048), (7, 2049), (33, 10000)])
@pytest.mark.parametrize("per_sample", [False, True], ids=["alpha_row", "alpha_sample"])
def test_onepole_kernel_matches_plain(card, rows, t, per_sample):
    gen = torch.Generator().manual_seed(rows * t)
    g = (-40.0 * torch.rand(rows, t, generator=gen)).to(card)
    a = _alpha(gen, rows, card)
    if per_sample:
        a = a[:, None].expand(rows, t).contiguous()
        b = ((1.0 - a) * g).contiguous()
    else:
        b = ((1.0 - a)[:, None] * g).contiguous()
    before = scan1p.onepole_core.launches
    y = scan1p.onepole_core(b, a)
    torch.cuda.synchronize()
    assert scan1p.onepole_core.launches == before + 1
    torch.testing.assert_close(y, scan1p.onepole_core_plain(b, a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows,t,lookahead", [(1, 1, 0), (3, 2047, 1024), (8, 5000, 2048)])
def test_compressor_kernel_matches_plain(card, rows, t, lookahead):
    gen = torch.Generator().manual_seed(rows + t)
    x = torch.randn(rows, t, generator=gen).to(card)
    x = x / x.abs().amax(dim=-1, keepdim=True)
    xd = torch.roll(x, lookahead, dims=-1)
    u = lambda lo, hi: (lo + (hi - lo) * torch.rand(rows, generator=gen)).to(card)  # noqa: E731
    args = (x, xd, u(-40.0, -6.0), u(1.5, 10.0), u(0.0, 12.0), _alpha(gen, rows, card), u(0.0, 6.0))
    before = comp_fused.compressor_fused_gain.launches
    y = comp_fused.compressor_fused_gain(*args)
    torch.cuda.synchronize()
    assert comp_fused.compressor_fused_gain.launches == before + 1
    torch.testing.assert_close(y, comp_fused.compressor_fused_gain_plain(*args), rtol=0, atol=1e-5)


def test_kernels_refuse_what_they_do_not_take(card):
    b = torch.zeros(2, 64, device=card)
    with pytest.raises(TypeError):
        scan1p.onepole_core(b.double(), torch.zeros(2, device=card, dtype=torch.float64))
    with pytest.raises(ValueError):
        scan1p.onepole_core(b, torch.zeros(2))  # alpha on the CPU
    with pytest.raises(ValueError):
        scan1p.onepole_core(torch.zeros(64, 2, device=card).t(), torch.zeros(2, device=card))
    x = torch.zeros(2, 64, device=card)
    p = torch.ones(2, device=card)
    with pytest.raises(ValueError):
        comp_fused.compressor_fused_gain(x, x[:, :32], p, p, p, p, p)
