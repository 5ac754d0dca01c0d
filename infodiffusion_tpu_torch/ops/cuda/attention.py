"""K2 and K2': single-head attention, CUDA kernels and their plain
versions.

Replaces ``infodiffusion_tpu/ops/pallas/attention.py``
(``attention_pallas``, ``_kernel``). Kernel: ``csrc/attention.cu``.

Contract (both versions), that of ``_attention_xla``
(``infodiffusion_tpu/ops/attention.py``), which the JAX main path runs:
``softmax(q k^T * C^-1/2)`` in f32, the weights rounded to v's dtype
before PV, PV accumulated in f32, the output in v's dtype. The Pallas
kernel keeps the weights in f32; the two agree in f32 and differ by the
rounding of w in bf16.

As the TPU kernel does, a block holds the f32 logit strip of its query rows
on chip: q k^T is computed once, the softmax finished, w rounded, and only
then PV. In bf16 every product runs on the tensor cores (``mma.sync``, f32
accumulation); a block of BQ / 16 warps owns BQ = 16, 32 or 64 query rows
of one batch element (fewer at small N and small grids) and streams its k
and v once each. Where the strip would leave an SM fewer than 4 warps (N
beyond 768 at BQ = 64, 512 at BQ = 16) the block makes K3a's two passes
over k instead. f32 makes K3a's two passes with exact f32 FMAs.
``attention_plan`` says what a shape launches. It is compiled for C = 64
(the InfoDiff UNet at ch 32: mnist, fmnist, dsprites, chairs), 128 (ch 64),
256 and 512 (the vanilla UNet and the VAE, ch_mult (1, 2, 4, 8)); any other
C raises.

K2' replaces ``tools/microbench_attention.py`` (``attention_pallas_tiled``
/ ``_tiled_kernel``), the attention microbenchmark's variant with ``tb``
batch elements per grid step: q, k, v upcast to f32, f32 logits and
softmax, PV with w unrounded in f32, the output in v's dtype. In f32 it is
K2's function; in bf16 it differs from K2 by the rounding of w. Its
kernels are K2's with w split into hi = bf16(w) and lo = bf16(w - hi), PV
run on both (about 2^-17 relative to w); ``tb`` does not change the
function and is checked, not looped over.
"""

from __future__ import annotations

import ctypes

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

CHANNELS = (64, 128, 256, 512)  # the C the kernel is compiled for


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
    """Launch K2 on contiguous CUDA q, k, v [B, N, C] of one dtype (f32 or
    bf16), C in ``CHANNELS``. Raises on anything else."""
    _lib.check_tensor(q, "q", dtypes=tuple(_lib.DTYPE_CODES))
    if q.ndim != 3 or q.shape[-1] not in CHANNELS or q.shape[1] == 0:
        raise ValueError(
            f"attention kernel takes [B, N>0, C] with C in {CHANNELS}, got "
            f"{tuple(q.shape)}"
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
    attention_cuda.launches_by_c[C] += 1
    return out


attention_cuda.launches = 0
attention_cuda.launches_by_c = dict.fromkeys(CHANNELS, 0)  # per C


def attention_plan(B: int, N: int, C: int, dtype: torch.dtype,
                   tiled: bool = False) -> dict:
    """What K2 (K2' with ``tiled``) launches for [B, N, C] of ``dtype`` on
    the current card: query rows a block (``bq``), ``blocks``,
    ``threads``, ``smem`` bytes, ``strip`` (the one-pass resident strip,
    else two passes over k) and ``per_sm`` (resident blocks per SM)."""
    info = (ctypes.c_int * 6)()
    err = _lib.library().lib.infodiff_attention_plan(
        B, N, C, _lib.DTYPE_CODES[dtype], int(tiled), info)
    _lib.check_launch(err, "attention_plan")
    keys = ("bq", "blocks", "threads", "smem", "strip", "per_sm")
    plan = dict(zip(keys, info))
    plan["strip"] = bool(plan["strip"])
    return plan


def attention_tiled_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, tb: int = 8) -> torch.Tensor:
    """Plain PyTorch K2': q, k, v [B, N, C] -> [B, N, C] in v's dtype; B
    must be a multiple of ``tb``, as the JAX tool asserts."""
    _check_tb(q.shape[0], tb)
    f32 = torch.float32
    C = q.shape[-1]
    logits = torch.einsum("bnc,bmc->bnm", q.to(f32), k.to(f32)) * (C ** -0.5)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bnm,bmc->bnc", w, v.to(f32)).to(v.dtype)


def _check_tb(batch: int, tb: int) -> None:
    if tb < 1 or batch % tb:
        raise ValueError(f"tb={tb} must divide the batch {batch}")


def attention_tiled_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         tb: int = 8) -> torch.Tensor:
    """Launch K2' on contiguous CUDA q, k, v [B, N, C] of one dtype (f32 or
    bf16), C in ``CHANNELS``, ``tb`` dividing B. Raises on anything else."""
    _lib.check_tensor(q, "q", dtypes=tuple(_lib.DTYPE_CODES))
    if q.ndim != 3 or q.shape[-1] not in CHANNELS or q.shape[1] == 0:
        raise ValueError(
            f"tiled attention kernel takes [B, N>0, C] with C in {CHANNELS}, "
            f"got {tuple(q.shape)}"
        )
    _check_tb(q.shape[0], tb)
    for name, t in (("k", k), ("v", v)):
        _lib.check_tensor(t, name, shape=q.shape, dtypes=(q.dtype,),
                          device=q.device)
    B, N, C = q.shape
    out = torch.empty_like(v)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_attention_tiled(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, C,
            _lib.DTYPE_CODES[q.dtype], tb, _lib.stream_handle(),
        )
    _lib.check_launch(err, "attention_tiled")
    attention_tiled_cuda.launches += 1
    return out


attention_tiled_cuda.launches = 0
