"""K7, the fused quantize-conv, on the card: both bodies (``qconv_cuda``,
``qconv_v2_cuda``) against the plain version (``qconv_reference``) at the
flagship's 11 ResBlock conv sites (B=2, and B=140 at 8x8, past one wave of
SMs) and at odd shapes (Ctot 32, 96, 192, 320; a piece boundary inside a
16-byte panel; Cout 32, 96, 256; a ragged last row tile; columns past one
tile), with bf16 and f32 pieces and both out dtypes:
- the relative L2 error <= 1e-4 and max abs error <= 1e-2 of max |plain|
  (``chip_smoke.py``'s bars: the chain's exp and divides on the card
  against torch's sigmoid on the same f32 values may differ by an ulp,
  which can flip one int8 unit);
- v2 bitwise v1, and each call bitwise a second call;
- K7 bitwise the chainless int8 conv (``int8_conv_cuda`` with K7's scale
  and bias) on K7's own int8 values, read back through K7 with identity
  weights on the centre tap;
- the branch-free divides of K7's chain equal ``__fdiv_rn`` on every float
  of their range, and its chain equals the exact one on random and special
  values (``qconv_chain_check``).

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one. The file imports no JAX, so on a card's machine without JAX
they run past ``tests/conftest.py`` (which imports it):

    python -m pytest --noconftest tests/test_torch_qconv_card.py -m cuda -q
"""

import pytest
import torch

from infodiffusion_tpu_torch.ops import quant as Q
from infodiffusion_tpu_torch.ops.cuda import qconv as K7

pytestmark = pytest.mark.cuda

L2_TOL, MAX_TOL = 1e-4, 1e-2
# (B, H, W, piece channels, Cout)
SHAPES = [
    (2, 8, 8, (128,), 128), (2, 8, 8, (128, 128), 128),
    (2, 16, 16, (128,), 128), (2, 16, 16, (128, 128), 128),
    (2, 32, 32, (64,), 128), (2, 32, 32, (128,), 128),
    (2, 32, 32, (128, 64), 128), (2, 32, 32, (128, 128), 128),
    (2, 64, 64, (64,), 64), (2, 64, 64, (64, 64), 64),
    (2, 64, 64, (128, 64), 64), (140, 8, 8, (64,), 64),
    (3, 6, 7, (32,), 32), (2, 9, 5, (64, 32), 96),
    (2, 15, 20, (24, 40), 64), (3, 12, 12, (128, 64), 256),
    (2, 7, 9, (256, 64), 96), (1, 5, 150, (32,), 32),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(B, H, W, splits, cout, dtype, device):
    g = torch.Generator(device=device).manual_seed(H * W + cout + len(splits))
    ctot = sum(splits)
    pieces = [(0.5 * torch.randn(B, H, W, c, generator=g, device=device))
              .to(dtype) for c in splits]
    A = 1.0 + 0.1 * torch.randn(B, ctot, generator=g, device=device)
    Bv = 0.1 * torch.randn(B, ctot, generator=g, device=device)
    absmax = torch.stack([p.float().abs().amax() * 1.2 for p in pieces])
    kernel = 0.2 * torch.randn(3, 3, ctot, cout, generator=g, device=device)
    bias = 0.1 * torch.randn(cout, generator=g, device=device)
    return pieces, A, Bv, absmax, kernel, bias


def _kernel_q(run, pieces, A, Bv, s):
    """The int8 values K7's chain computes, read back through the kernel:
    identity weights on the centre tap with the act scales folded out."""
    splits = [p.shape[-1] for p in pieces]
    ctot = sum(splits)
    sc = torch.cat([s[i].expand(c) for i, c in enumerate(splits)])
    ident = torch.zeros(3, 3, ctot, ctot, device=sc.device)
    ident[1, 1] = torch.diag(1.0 / sc)
    kmat, sw = K7._fold_pack(ident, s, splits)
    out = run(pieces, A, Bv, s, kmat, sw, torch.zeros(ctot, device=sc.device),
              torch.float32)
    return torch.round(out).to(torch.int8)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_out", "bf16_out"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(
    str(v) if not isinstance(v, tuple) else "+".join(map(str, v))
    for v in s))
def test_k7_bodies_against_plain_and_each_other(card, shape, dtype,
                                                out_dtype):
    B, H, W, splits, cout = shape
    pieces, A, Bv, absmax, kernel, bias = _inputs(B, H, W, splits, cout,
                                                  dtype, card)
    s_act = Q.act_scale(absmax)
    kmat, sw = K7._fold_pack(kernel, s_act, list(splits))
    args = (pieces, A, Bv, s_act, kmat, sw, bias, out_dtype)
    v1 = K7.qconv_cuda(*args)
    v2 = K7.qconv_v2_cuda(*args)
    again = K7.qconv_cuda(*args)
    torch.cuda.synchronize()
    want = K7.qconv_reference(pieces, A, Bv, absmax, kernel, bias, out_dtype)
    assert v1.dtype == out_dtype and v1.shape == want.shape
    got, ref = v1.double(), want.double()
    assert torch.isfinite(got).all()
    l2 = ((got - ref).norm() / ref.norm()).item()
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert l2 <= L2_TOL and err <= MAX_TOL, (l2, err)
    assert torch.equal(v1, v2), "v2 is not bitwise v1"
    assert torch.equal(v1, again), "a second call differs"
    # the products and epilogue: the chainless int8 conv on K7's own values
    q = _kernel_q(K7.qconv_cuda, pieces, A, Bv, s_act)
    ctot = sum(splits)
    kq = kmat.view(3, ctot, 3, cout).permute(2, 0, 1, 3).contiguous()
    chainless = K7.int8_conv_cuda(q, kq, 1, scale=sw, bias=bias,
                                  out_dtype=out_dtype)
    assert torch.equal(v1, chainless)


def test_k7_fast_divides_and_chain_are_exact(card):
    assert K7.qconv_chain_check(0, 1.0) == 0  # 1 / d, every d in [1, 2^60)
    for s in (0.0123456789, 1.9999998 * 2**-7):  # a / s, every |a| in range
        assert K7.qconv_chain_check(1, s) == 0
    g = torch.Generator(device=card).manual_seed(3)
    x = 3 * torch.randn(1 << 22, generator=g, device=card)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -1e-40, 1e30, -1e30, 88.0,
                            -88.0, 87.4, -87.4, 3e38, -3e38, 1e-20],
                           device=card)
    x[:special.numel() * 64] = special.repeat(64)
    ab = torch.cat([1.0 + 0.1 * torch.randn(8, generator=g, device=card),
                    0.1 * torch.randn(8, generator=g, device=card)])
    for s in (0.01, 1e-35, 1e25):
        assert K7.qconv_chain_check(2, s, x, ab) == 0
