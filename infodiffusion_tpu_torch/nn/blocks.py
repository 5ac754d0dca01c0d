"""ResBlocks, resampling and the latent MLP block
(JAX counterpart: ``infodiffusion_tpu/nn/blocks.py``).

Image blocks take and return NCHW tensors in ``channels_last`` memory
format, so cuDNN's convs run NHWC-native and the NHWC view the norm and
attention kernels read is free. The AdaGN chain (GroupNorm, then one or
two FiLMs) is ``ops.norm.adagn``, kernel K1 on the card.

Ported: ``AuxResBlock`` (the backbone) and ``EncoderResBlock`` (the
Encoder), not ``ResBlock``. Dropout follows Flax ``nn.Dropout`` and is off
unless a block is called with ``deterministic=False`` and an explicit
``torch.Generator``. The skip concat is a plain ``torch.cat`` in the
caller (the JAX package's concat-free piece forms are XLA fusion structure
with the same math and param tree).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from infodiffusion_tpu_torch.nn.attention import AttnBlock
from infodiffusion_tpu_torch.nn.layers import Dense, xavier_
from infodiffusion_tpu_torch.ops.norm import adagn

_GROUPS = 32
DROPOUT = 0.1  # the rate of every ResBlock's dropout


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with p = 1 - rate, kept values scaled by
    1/p, the mask drawn from ``generator`` (never the global RNG)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    # empty_like keeps x's memory format (channels_last)
    u = torch.empty_like(x, dtype=torch.float32).uniform_(generator=generator)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The contiguous NHWC view of an NCHW tensor (free when the tensor is
    ``channels_last``)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Conv3(nn.Module):
    """torch ``Conv2d(k=3, stride, padding=1)``: symmetric padding, not
    'SAME' (asymmetric at stride 2), computed in ``dtype`` with f32
    parameters. ``repeat=2`` puts a nearest-x2 upsample before the conv
    (``UpSample``)."""

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, stride: int = 1,
                 repeat: int = 1, gain: float = 1.0):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.repeat = repeat
        self.weight = nn.Parameter(
            xavier_(torch.empty(out_ch, in_ch, 3, 3), gain)
        )
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.repeat > 1:
            x = F.interpolate(x, scale_factor=self.repeat, mode="nearest")
        return F.conv2d(
            x, self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.stride, padding=1,
        )


class ShortcutDense(Dense):
    """The ResBlock 1x1 shortcut as a Dense over the channel axis;
    ``forward(x, residual)`` returns ``residual + dense(x)`` (NCHW)."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return residual + _nchw(super().forward(_nhwc(x)))


class _GNParams(nn.Module):
    """GroupNorm scale/bias (as ``weight``/``bias``) with the math in
    ``ops.norm.adagn``, so the FiLM-fused form uses the same parameters."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, films=()) -> torch.Tensor:
        return _nchw(adagn(_nhwc(x), _GROUPS, self.weight, self.bias, films))


class AuxResBlock(nn.Module):
    """ResBlock with dual FiLM, time then aux latent: norm1-SiLU-conv1,
    [norm2 + FiLM(t) + FiLM(a)]-SiLU-dropout-conv2,
    norm3-SiLU-dropout-conv3, + shortcut, then optional attention."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 attn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = _GNParams(in_ch)
        self.conv1 = Conv3(in_ch, out_ch, dtype)
        self.temb_proj = Dense(emb_dim, 2 * out_ch, dtype)
        self.aemb_proj = Dense(emb_dim, 2 * out_ch, dtype)
        self.norm2 = _GNParams(out_ch)
        self.conv2 = Conv3(out_ch, out_ch, dtype)
        self.norm3 = _GNParams(out_ch)
        self.conv3 = Conv3(out_ch, out_ch, dtype)
        self.shortcut = (
            ShortcutDense(in_ch, out_ch, dtype) if in_ch != out_ch else None
        )
        self.attn = AttnBlock(out_ch, dtype) if attn else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                aemb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        t_scale, t_shift = self.temb_proj(F.silu(temb)).chunk(2, dim=-1)
        a_scale, a_shift = self.aemb_proj(F.silu(aemb)).chunk(2, dim=-1)
        h = self.norm2(h, films=((t_scale, t_shift), (a_scale, a_shift)))
        h = self.conv2(dropout(F.silu(h), DROPOUT, deterministic, generator))
        h = self.conv3(dropout(F.silu(self.norm3(h)), DROPOUT, deterministic,
                               generator))
        h = self.shortcut(x, h) if self.shortcut is not None else h + x
        return self.attn(h) if self.attn is not None else h


class EncoderResBlock(nn.Module):
    """The unconditioned ResBlock of the Encoder: norm1-SiLU-conv1,
    norm2-SiLU-dropout-conv2, + shortcut, then optional attention."""

    def __init__(self, in_ch: int, out_ch: int, attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = _GNParams(in_ch)
        self.conv1 = Conv3(in_ch, out_ch, dtype)
        self.norm2 = _GNParams(out_ch)
        self.conv2 = Conv3(out_ch, out_ch, dtype)
        self.shortcut = (
            ShortcutDense(in_ch, out_ch, dtype) if in_ch != out_ch else None
        )
        self.attn = AttnBlock(out_ch, dtype) if attn else None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(dropout(F.silu(self.norm2(h)), DROPOUT, deterministic,
                               generator))
        h = self.shortcut(x, h) if self.shortcut is not None else h + x
        return self.attn(h) if self.attn is not None else h


class DownSample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3(channels, channels, dtype, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UpSample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3(channels, channels, dtype, repeat=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MLPLNAct(nn.Module):
    """Linear -> [x * (condition_bias + Linear(act(cond)))] -> LayerNorm
    (f32, eps 1e-5) -> act. ``activation`` is None or 'silu'."""

    def __init__(self, in_ch: int, out_ch: int, norm: bool, use_cond: bool,
                 cond_ch: int = 0, activation: Optional[str] = None,
                 condition_bias: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in (None, "silu"):
            raise ValueError(f"activation must be None or 'silu', got "
                             f"{activation!r}")
        self.activation = activation
        self.condition_bias = condition_bias
        self.dtype = dtype
        self.linear = Dense(in_ch, out_ch, dtype)
        self.linear_emb = Dense(cond_ch, out_ch, dtype) if use_cond else None
        self.norm = nn.LayerNorm(out_ch, eps=1e-5) if norm else None

    def forward(self, x: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.linear(x)
        if self.linear_emb is not None:
            c = F.silu(cond) if self.activation is not None else cond
            x = x * (self.condition_bias + self.linear_emb(c))
        if self.norm is not None:
            x = self.norm(x.to(torch.float32)).to(self.dtype)
        if self.activation is not None:
            x = F.silu(x)
        return x
