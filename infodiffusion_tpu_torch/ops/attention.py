"""Single-head full self-attention over image tokens
(JAX counterpart: ``infodiffusion_tpu/ops/attention.py``).

``softmax(q k^T / sqrt(C)) v`` with f32 logits and softmax. Routing as in
the JAX package: N >= ``flash_min_tokens()`` (``INFODIFF_FLASH_ATTN_MIN_TOKENS``,
default 512) takes the flash forward K3a, fewer tokens the attention
kernel K2 (``ops/cuda``). Both directions are one ``autograd.Function``
whose backward is the flash backward K3b at every N. On a CPU tensor the
same Function runs the plain forward and the explicit plain backward.
Nothing is saved for backward when no input needs a gradient. The JAX
package's ring (sequence-parallel) route is not ported.
"""

from __future__ import annotations

import os

import torch

from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)
from infodiffusion_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_reference,
    flash_attention_cuda,
)


def flash_min_tokens() -> int:
    return int(os.environ.get("INFODIFF_FLASH_ATTN_MIN_TOKENS", "512"))


def attention_route(n_tokens: int) -> str:
    """'flash' (K3a) or 'attention' (K2) for a call with ``n_tokens``."""
    return "flash" if n_tokens >= flash_min_tokens() else "attention"


class _Attention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v):
        if q.is_cuda:
            kernel = (flash_attention_cuda
                      if attention_route(q.shape[1]) == "flash"
                      else attention_cuda)
            out = kernel(q, k, v)
        else:
            # K2 and K3a share one contract and so one plain version
            out = attention_reference(q, k, v)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        do = do.contiguous()
        if q.is_cuda:
            return flash_attention_bwd_cuda(q, k, v, do)
        return flash_attention_bwd_reference(q, k, v, do)


def single_head_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, C] -> [B, N, C]."""
    return _Attention.apply(q, k, v)
