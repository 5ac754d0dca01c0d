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

The backward (``adagn_bwd_cuda``, ``csrc/adagn_bwd.cu``; plain version
``adagn_bwd_reference``) is the gradient XLA's autodiff of
``infodiffusion_tpu/ops/norm.py`` ``adagn`` computes; the JAX package
has no Pallas kernel for it. It reuses the forward's statistics partials.
``ops.norm.adagn`` wraps both directions in one ``autograd.Function``.
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




def adagn_bwd_reference(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
):
    """Plain PyTorch K1 backward: the closed-form gradient of
    ``adagn_reference`` in f32 (the same formulas as ``csrc/adagn_bwd.cu``,
    not autograd). Returns ``(dx, dscale, dbias, dfilms)`` with dx in x's
    dtype, dscale/dbias f32 and each (ds, db) in its FiLM's dtype. Where
    the var clamp binds the gradient through var is 0, as in JAX."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    gs = C // G
    xf = x.to(torch.float32).reshape(B, -1, G, gs)
    n = xf.shape[1] * gs
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + EPS)
    keep = (var >= 0).to(torch.float32).reshape(B, G)
    xh = ((xf - mean) * rstd).reshape(B, -1, C)
    rstd_c = rstd.expand(B, 1, G, gs).reshape(B, 1, C)
    d = dy.to(torch.float32).reshape(B, -1, C)
    s1 = d.sum(dim=1)          # [B, C]
    s2 = (d * xh).sum(dim=1)
    fs = [1.0 + s.to(torch.float32) for s, _ in films]
    fb = [b.to(torch.float32) for _, b in films]
    P = torch.ones_like(s1)
    for f in fs:
        P = P * f
    alpha = scale.to(torch.float32).expand(B, C)
    beta = bias.to(torch.float32).expand(B, C)
    dfilms = []
    for k, (s, b) in enumerate(films):
        q = torch.ones_like(s1)
        for f in fs[k + 1:]:
            q = q * f
        dfilms.append(((q * (alpha * s2 + beta * s1)).to(s.dtype),
                       (q * s1).to(b.dtype)))
        alpha = alpha * fs[k]
        beta = beta * fs[k] + fb[k]
    a = scale.to(torch.float32) * P
    m1 = (a * s1).reshape(B, G, gs).sum(-1) / n
    m2 = (a * s2).reshape(B, G, gs).sum(-1) / n * keep

    def per_channel(m):
        return m[:, :, None].expand(B, G, gs).reshape(B, 1, C)

    dx = rstd_c * (a[:, None, :] * d - per_channel(m1) - xh * per_channel(m2))
    return (dx.reshape(x.shape).to(x.dtype), (P * s2).sum(0),
            (P * s1).sum(0), dfilms)


def _plan(x: torch.Tensor, B: int, HW: int, C: int):
    """(threads, splits, rows per split) of the (split, batch) grid."""
    threads = max(1, 512 // C) * C
    rows_per_pass = threads // C
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = max(1, min(_MAX_SPLITS, math.ceil(4 * sms / B),
                        math.ceil(HW / rows_per_pass)))
    rows_per_split = math.ceil(HW / splits)
    return threads, math.ceil(HW / rows_per_split), rows_per_split


def _check_args(x, num_groups, scale, bias, films):
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
    return B, HW, C, G, K, stacked


def adagn_cuda(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
    *,
    return_stats: bool = False,
):
    """Launch K1 on a contiguous CUDA x [B, ..., C] (f32 or bf16).

    Limits: C <= 1024, C % num_groups == 0, at most two FiLMs. Raises on
    anything else; never falls back to the plain version. With
    ``return_stats`` also returns the statistics partials [B, S, 2, C]
    (sum x, sum x^2 per split) that the backward kernel reuses.
    """
    B, HW, C, G, K, stacked = _check_args(x, num_groups, scale, bias, films)
    threads, splits, rows_per_split = _plan(x, B, HW, C)
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
    return (out, partial) if return_stats else out


adagn_cuda.launches = 0


def adagn_bwd_cuda(
    x: torch.Tensor,
    dy: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    stats: torch.Tensor,
):
    """Launch the K1 backward kernel (``csrc/adagn_bwd.cu``) on CUDA
    tensors; ``stats`` are the forward's partials
    (``adagn_cuda(..., return_stats=True)``). Returns what
    ``adagn_bwd_reference`` returns. Raises on what the kernel does not
    take."""
    B, HW, C, G, K, stacked = _check_args(x, num_groups, scale, bias, films)
    _lib.check_tensor(dy, "dy", shape=x.shape, dtypes=(x.dtype,),
                      device=x.device)
    _lib.check_tensor(stats, "stats", dtypes=(torch.float32,),
                      device=x.device)
    if stats.ndim != 4 or stats.shape[0] != B or stats.shape[2:] != (2, C):
        raise ValueError(f"stats: shape {tuple(stats.shape)}, expected "
                         f"[{B}, S, 2, {C}]")
    threads, splits, rows_per_split = _plan(x, B, HW, C)
    f32 = dict(dtype=torch.float32, device=x.device)
    partial = torch.empty((B, splits, 2, C), **f32)
    gpart = torch.empty((B, 2, C), **f32)
    rows = torch.empty((B, 4, G), **f32)
    dx = torch.empty_like(x)
    dscale = torch.empty((C,), **f32)
    dbias = torch.empty((C,), **f32)
    dstack = torch.empty((B, 2 * K, C), **f32) if K else None
    lib = _lib.library().lib
    with torch.cuda.device(x.device):
        err = lib.infodiff_adagn_bwd(
            x.data_ptr(), dy.data_ptr(), stats.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), stacked.data_ptr() if K else None,
            partial.data_ptr(), gpart.data_ptr(), rows.data_ptr(),
            dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
            dstack.data_ptr() if K else None, B, HW, C, G, K,
            stats.shape[1], splits, rows_per_split, threads,
            _lib.DTYPE_CODES[x.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "adagn_bwd")
    adagn_bwd_cuda.launches += 1
    dfilms = [(dstack[:, 2 * k].to(s.dtype), dstack[:, 2 * k + 1].to(b.dtype))
              for k, (s, b) in enumerate(films)]
    return dx, dscale, dbias, dfilms


adagn_bwd_cuda.launches = 0
