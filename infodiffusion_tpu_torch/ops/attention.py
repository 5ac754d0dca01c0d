"""Single-head full self-attention over image tokens
(JAX counterpart: ``infodiffusion_tpu/ops/attention.py``).

``softmax(q k^T / sqrt(C)) v`` with f32 logits and softmax. A CUDA tensor
runs kernel K2 (``ops/cuda/attention.py``), a CPU tensor its plain
version. The JAX package's ring (sequence-parallel) and flash routes take
over only beyond 64px and are not ported yet.
"""

from __future__ import annotations

import torch

from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)


def single_head_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, N, C] -> [B, N, C]."""
    if q.is_cuda:
        return attention_cuda(q, k, v)
    return attention_reference(q, k, v)
