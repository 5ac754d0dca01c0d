"""Attention blocks (JAX counterpart: ``infodiffusion_tpu/nn/attention.py``).

Single-head attention over the H*W tokens with Dense projections over the
channel axis, as in the JAX package (a 1x1 conv there is a Dense). The
softmax core is ``ops.attention.single_head_attention`` (kernel K2 on the
card below 512 tokens, the flash kernels above), the GroupNorm
``ops.norm.group_norm`` (kernel K1). ``AttnBlock`` attends within ``x``;
``CrossAttnBlock`` takes its queries from ``a`` and its keys and values
from ``x``. The reference builds a CrossAttnBlock in every AuxResBlock but
applies none in any configuration (modules.py:299-300, 325-326), so no
model here builds one: the block is the reference's module for API parity,
and the dead ``crossattn.*`` keys of a reference checkpoint are skipped
(``interop``).
"""

from __future__ import annotations

import torch
from torch import nn

from infodiffusion_tpu_torch.nn.layers import Dense
from infodiffusion_tpu_torch.ops.attention import single_head_attention
from infodiffusion_tpu_torch.ops.norm import group_norm


class _GN(nn.Module):
    """GroupNorm(32) with torch's eps, statistics in f32, over the last
    axis of an NHWC tensor."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias)


class AttnBlock(nn.Module):
    """Residual attention on an NCHW ``channels_last`` tensor."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_norm = _GN(channels)
        self.proj_q = Dense(channels, channels, dtype)
        self.proj_k = Dense(channels, channels, dtype)
        self.proj_v = Dense(channels, channels, dtype)
        self.proj = Dense(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        # a channels_last tensor's NHWC view is contiguous: no copy
        h = self.group_norm(x.permute(0, 2, 3, 1).contiguous())
        q = self.proj_q(h).reshape(B, H * W, C)
        k = self.proj_k(h).reshape(B, H * W, C)
        v = self.proj_v(h).reshape(B, H * W, C)
        h = single_head_attention(q, k, v).reshape(B, H, W, C)
        return x + self.proj(h).permute(0, 3, 1, 2)


class CrossAttnBlock(nn.Module):
    """Residual attention on NCHW ``channels_last`` tensors of one shape:
    queries from ``a``, keys and values from ``x``. One ``group_norm``
    normalizes both, as the reference shares it (modules.py:185-186)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.group_norm = _GN(channels)
        self.proj_q = Dense(channels, channels, dtype)
        self.proj_k = Dense(channels, channels, dtype)
        self.proj_v = Dense(channels, channels, dtype)
        self.proj = Dense(channels, channels, dtype)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x.permute(0, 2, 3, 1).contiguous())
        h_a = self.group_norm(a.permute(0, 2, 3, 1).contiguous())
        q = self.proj_q(h_a).reshape(B, H * W, C)
        k = self.proj_k(h).reshape(B, H * W, C)
        v = self.proj_v(h).reshape(B, H * W, C)
        h = single_head_attention(q, k, v).reshape(B, H, W, C)
        return x + self.proj(h).permute(0, 3, 1, 2)
