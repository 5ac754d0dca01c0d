"""K2: single-head attention, a CUDA kernel and its plain version.

Replaces ``infodiffusion_tpu/ops/pallas/attention.py``
(``attention_pallas``, ``_kernel``). Kernel: ``csrc/attention.cu``.

Contract (both versions), that of ``_attention_xla``
(``infodiffusion_tpu/ops/attention.py``), which the JAX main path runs:
``softmax(q k^T * C^-1/2)`` in f32, the weights rounded to v's dtype
before PV, PV accumulated in f32, the output in v's dtype. The Pallas
kernel keeps the weights in f32; the two agree in f32 and differ by the
rounding of w in bf16.

On the card the kernel is bound by instruction issue at the flagship's
N = 256 and N = 64 (C = 128): it does its products as plain f32 FMAs and
computes q k^T twice, once for the row max and sum and once for the
weights, so that w can be rounded exactly as the contract says. A block
owns 16 query rows and walks k/v in 32-row tiles through shared memory,
so it takes any N.
"""

from __future__ import annotations

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

CHANNELS = 128  # the only C the kernel is compiled for


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2. q, k, v: [B, N, C] -> [B, N, C] in v's dtype."""
    C = q.shape[-1]
    logits = torch.einsum(
        "bnc,bmc->bnm", q.to(torch.float32), k.to(torch.float32)
    ) * (C ** -0.5)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bnm,bmc->bnc", w.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.to(v.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Launch K2 on contiguous CUDA q, k, v [B, N, 128] of one dtype
    (f32 or bf16). Raises on anything else."""
    _lib.check_tensor(q, "q", dtypes=tuple(_lib.DTYPE_CODES))
    if q.ndim != 3 or q.shape[-1] != CHANNELS or q.shape[1] == 0:
        raise ValueError(
            f"attention kernel takes [B, N>0, {CHANNELS}], got {tuple(q.shape)}"
        )
    for name, t in (("k", k), ("v", v)):
        _lib.check_tensor(t, name, shape=q.shape, dtypes=(q.dtype,),
                          device=q.device)
    B, N, C = q.shape
    out = torch.empty_like(v)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, C,
            _lib.DTYPE_CODES[q.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "attention")
    attention_cuda.launches += 1
    return out


attention_cuda.launches = 0
