"""K1 and its backward on the card, with FiLM rows the wrapper has to copy
before the launch: rows of mixed dtypes (made f32) and rows with a column
stride (made contiguous). Each output is held against the plain version
(``adagn_reference``, ``adagn_bwd_reference``) at the bars ``chip_smoke.py``
holds the kernels to: max abs error over max |plain| <= 1e-4 for an f32
output and 2e-2 for a bf16 one (a bf16 FiLM's gradient under f32 x too).
The shapes take each body of the plan: one block an element (HW 1, where
x's output is the size of a copied row), a cluster of ranks, and the
stream. At HW 1 C is 1024, so a group holds 32 elements: with 2 (C 64)
the one-pass variance the contract prescribes, E[x^2] - mean^2, cancels
to a few ulps, and two f32 summation orders (the kernel's, the plain
version's) differ by more than the f32 bar.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so on a card's machine without JAX
they run past ``tests/conftest.py`` (which imports it):

    python -m pytest --noconftest tests/test_torch_adagn_card.py -m cuda -q
"""

import pytest
import torch

from infodiffusion_tpu_torch.ops.cuda.adagn import (
    adagn_bwd_cuda,
    adagn_bwd_reference,
    adagn_cuda,
    adagn_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (B, HW, C): one block an element, a cluster, the stream body
SHAPES = [(8, 1, 1024), (4, 4096, 192), (2, 65536, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernels have no CPU mode")
    return torch.device("cuda", 0)


def _films(kind, B, C, dtype, g, device):
    """Two FiLMs (s, b). ``mixed``: s in x's dtype, b in the other;
    ``strided``: the even and odd columns of a [B, 2C] projection."""
    def rows(n, dt):
        return (0.3 * torch.randn(B, n, generator=g, device=device)).to(dt)

    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    films = []
    for _ in range(2):
        if kind == "mixed":
            films.append((rows(C, dtype), rows(C, other)))
        else:
            p = rows(2 * C, dtype)
            films.append((p[:, 0::2], p[:, 1::2]))
    return films


def _assert_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    tol = TOL[got.dtype]
    got, want = got.double(), want.double()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    assert err <= tol * scale, (f"{what}: {err:.3e} over {tol:.0e} x "
                                f"{scale:.3e}")


@pytest.mark.parametrize("kind", ["mixed", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,HW,C", SHAPES)
def test_copied_film_rows(card, kind, dtype, B, HW, C):
    g = torch.Generator(device=card).manual_seed(HW + C)
    x = (torch.randn(B, HW, C, generator=g, device=card) * 2 + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(C, generator=g, device=card)
    beta = 0.1 * torch.randn(C, generator=g, device=card)
    dy = torch.randn(B, HW, C, generator=g, device=card).to(dtype)
    films = _films(kind, B, C, dtype, g, card)

    out, stats = adagn_cuda(x, 32, gamma, beta, films, return_stats=True)
    torch.cuda.synchronize()
    _assert_close(out, adagn_reference(x, 32, gamma, beta, films), "out")

    got = adagn_bwd_cuda(x, dy, 32, gamma, beta, films, stats)
    torch.cuda.synchronize()
    want = adagn_bwd_reference(x, dy, 32, gamma, beta, films)
    for what, a, b in zip(("dx", "dgamma", "dbeta"), got[:3], want[:3]):
        _assert_close(a, b, what)
    for k, (gp, wp) in enumerate(zip(got[3], want[3])):
        for w, a, b in zip("sb", gp, wp):
            _assert_close(a, b, f"d{w}{k}")
