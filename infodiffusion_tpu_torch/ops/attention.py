"""Single-head full self-attention over image tokens
(JAX counterpart: ``infodiffusion_tpu/ops/attention.py``).

``softmax(q k^T / sqrt(C)) v`` with f32 logits and softmax. Routing as the
JAX package routes on its device (``flash_route``, ``ops/cuda``): below
``INFODIFF_FLASH_ATTN_MIN_TOKENS`` (default 512) or under
``INFODIFF_DISABLE_FLASH_ATTENTION=1`` the attention kernel K2; from there
the flash forward K3a where the JAX primary kernel's plan holds (N, C,
dtype), else the online forward K3c where its tiles divide N, else K2.
Both directions are one ``autograd.Function`` whose backward is the flash
backward K3b at every N. A CUDA tensor launches the routed kernel; a CPU
tensor takes the same route through the plain versions
(``attention_reference`` for K2 and K3a, which share a contract, and
``flash_attention_online_reference`` for K3c) and the explicit plain
backward. Nothing is saved for backward when no input needs a gradient.
Before all of that, under ``--sp`` (``parallel/sp.py``), ``sp_route``
sends an attention of at least ``INFODIFF_SP_MIN_TOKENS`` tokens to ring
attention over the ``seq`` group (``parallel/ring_attention.py``), as the
JAX op does.
"""

from __future__ import annotations

import torch

from infodiffusion_tpu_torch.ops.cuda.flash_attention import (
    backward_for,
    bwd_route,
    flash_min_tokens,
    flash_route,
    forward_for,
)
from infodiffusion_tpu_torch.parallel.ring_attention import ring_attention
from infodiffusion_tpu_torch.parallel.sp import sp_route

__all__ = ["bwd_route", "flash_min_tokens", "flash_route",
           "single_head_attention"]


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        route = flash_route(q.shape[1], q.shape[2], q.dtype)
        out = forward_for(route, q.is_cuda)(q, k, v)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v)
            ctx.bwd_route = bwd_route(q.shape[1], q.shape[2], q.dtype)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return backward_for(ctx.bwd_route, q.is_cuda)(q, k, v,
                                                      do.contiguous())


def single_head_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, C] -> [B, N, C]."""
    group = sp_route(q.shape[1])
    if group is not None:
        return ring_attention(q, k, v, group)
    return _Attention.apply(q, k, v)
