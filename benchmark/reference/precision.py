"""Lower-precision operand rounding for the control of the comparison.

``fp8`` rounds a tensor to float8 e4m3 with one scale per tensor (its
absolute maximum onto e4m3's largest finite value, 448) and back to
float32, the usual per-tensor fp8 recipe; gradients pass straight
through. The control runs the plain reference with every matrix product
and convolution taking its operands through it: the step below the bf16
that the configurations state.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().to(torch.float32)
        scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
        y = (x / scale).to(torch.float8_e4m3fn).to(x.dtype)
        return y * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(x)

