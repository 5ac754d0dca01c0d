"""K1: fused GroupNorm + K FiLMs (AdaGN), a CUDA kernel and its plain version.

Replaces ``infodiffusion_tpu/ops/pallas/adagn.py`` (``adagn_pallas``,
``_kernel``). Kernel: ``csrc/adagn.cu``. What bounds it on the card is
memory bandwidth: it reads x twice (statistics, then apply) and writes it
once, with a few FLOPs per element. A batch element at the flagship's
first level (HW 4096 x C 64) is far beyond one SM's shared memory, so the
TPU kernel's one-block-per-element design does not carry over: the kernel
runs over a (row split, batch) grid with per-split partial sums, which also
keeps the card busy at small batches.

Contract (both versions): statistics in f32 with one-pass
``var = E[x^2] - mean^2`` clamped at 0 (the XLA form in
``ops/norm.py``; the Pallas kernel lacks the clamp), eps 1e-5, then
``(x - mean) * rstd * gamma + beta`` and ``h * (1 + s_k) + b_k`` for each
FiLM, all in f32, rounded once to x's dtype. (The JAX XLA form rounds to
x's dtype after the affine as well, before the FiLMs; in f32 that is the
same.) SiLU is not fused, as in the JAX kernel.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

EPS = 1e-5
MAX_FILMS = 2
_MAX_SPLITS = 32  # bounds the partial sums each apply block folds


def adagn_reference(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """Plain PyTorch K1. x: [B, ..., C]; each film (s, b): [B, C]."""
    B, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by {num_groups}")
    xf = x.to(torch.float32).reshape(B, -1, num_groups, C // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    mean_sq = xf.square().mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(torch.clamp(mean_sq - mean.square(), min=0.0) + EPS)
    h = ((xf - mean) * rstd).reshape(B, -1, C)
    h = h * scale.to(torch.float32) + bias.to(torch.float32)
    for s, b in films:
        h = (h * (1.0 + s.to(torch.float32)[:, None, :])
             + b.to(torch.float32)[:, None, :])
    return h.reshape(x.shape).to(x.dtype)


def adagn_cuda(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """Launch K1 on a contiguous CUDA x [B, ..., C] (f32 or bf16).

    Limits: C <= 1024, C % num_groups == 0, at most two FiLMs. Raises on
    anything else; never falls back to the plain version.
    """
    _lib.check_tensor(x, "x", dtypes=tuple(_lib.DTYPE_CODES))
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C) if B * C else 0
    G, K = num_groups, len(films)
    if C % G or C > 1024 or K > MAX_FILMS or HW == 0:
        raise ValueError(
            f"adagn kernel takes C <= 1024 divisible by groups, <= "
            f"{MAX_FILMS} films, a non-empty tensor; got C={C}, G={G}, K={K}, "
            f"HW={HW}"
        )
    for name, t in (("scale", scale), ("bias", bias)):
        _lib.check_tensor(t, name, shape=(C,), dtypes=(torch.float32,),
                          device=x.device)
    stacked = None
    if K:
        stacked = torch.stack(
            [t for pair in films for t in pair], dim=1
        ).to(torch.float32).contiguous()
        _lib.check_tensor(stacked, "films", shape=(B, 2 * K, C),
                          device=x.device)

    threads = max(1, 512 // C) * C
    rows_per_pass = threads // C
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(_MAX_SPLITS, math.ceil(4 * sms / B),
                        math.ceil(HW / rows_per_pass)))
    rows_per_split = math.ceil(HW / splits)
    splits = math.ceil(HW / rows_per_split)

    partial = torch.empty((B, splits, 2, C), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    lib = _lib.library().lib
    with torch.cuda.device(x.device):
        err = lib.infodiff_adagn(
            x.data_ptr(), partial.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), stacked.data_ptr() if K else None,
            out.data_ptr(), B, HW, C, G, K, splits, rows_per_split, threads,
            _lib.DTYPE_CODES[x.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "adagn")
    adagn_cuda.launches += 1
    return out


adagn_cuda.launches = 0
