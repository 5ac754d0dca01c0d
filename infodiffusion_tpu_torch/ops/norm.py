"""GroupNorm and fused GroupNorm+FiLM (AdaGN)
(JAX counterpart: ``infodiffusion_tpu/ops/norm.py``).

``x`` is NHWC ``[B, H, W, C]`` or ``[B, N, C]``; ``num_groups`` groups over
the channel (last) axis; statistics in f32. With gradients on, every
GroupNorm site goes through one ``autograd.Function``: on a CUDA tensor its
forward is kernel K1 and its backward the K1 backward kernel
(``ops/cuda/adagn.py``); on a CPU tensor the plain forward and the explicit
plain backward, so the CPU tests run the same wiring and formulas the card
runs. FiLM-free sites run with K=0. Nothing is saved for backward when no
input needs a gradient; with gradients off (``torch.no_grad()``,
inference) the forward is called without the Function.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from infodiffusion_tpu_torch.ops.cuda.adagn import (
    EPS,
    adagn_bwd_cuda,
    adagn_bwd_reference,
    adagn_cuda,
    adagn_reference,
)


class _AdaGN(torch.autograd.Function):
    """(x, num_groups, scale, bias, s_1, b_1, ..., s_K, b_K) -> y."""

    @staticmethod
    def forward(ctx, x, num_groups, scale, bias, *films_flat):
        films = list(zip(films_flat[0::2], films_flat[1::2]))
        ctx.num_groups = num_groups
        save = any(ctx.needs_input_grad)
        stats = ()
        if x.is_cuda:
            out = adagn_cuda(x, num_groups, scale, bias, films,
                             return_stats=save)
            if save:
                out, stats = out[0], (out[1],)
        else:
            out = adagn_reference(x, num_groups, scale, bias, films)
        if save:
            ctx.save_for_backward(x, scale, bias, *films_flat, *stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, *rest = ctx.saved_tensors
        G = ctx.num_groups
        dy = dy.contiguous()
        if x.is_cuda:
            *films_flat, stats = rest
            films = list(zip(films_flat[0::2], films_flat[1::2]))
            dx, dscale, dbias, dfilms = adagn_bwd_cuda(
                x, dy, G, scale, bias, films, stats)
        else:
            films = list(zip(rest[0::2], rest[1::2]))
            dx, dscale, dbias, dfilms = adagn_bwd_reference(
                x, dy, G, scale, bias, films)
        return (dx, None, dscale, dbias, *(t for pair in dfilms for t in pair))


def adagn(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """GroupNorm, then the FiLMs ``h = h * (1 + s) + b`` in order: one for
    time, a second for the aux latent in AuxResBlock. Each (s, b): [B, C].
    With gradients off (sampling) the forward runs without the
    ``autograd.Function``, whose host cost there buys nothing."""
    if not torch.is_grad_enabled():
        run = adagn_cuda if x.is_cuda else adagn_reference
        return run(x, num_groups, scale, bias, films)
    return _AdaGN.apply(x, num_groups, scale, bias,
                        *(t for pair in films for t in pair))


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain GroupNorm over the last axis (AdaGN with no FiLM)."""
    return adagn(x, num_groups, scale, bias)


def group_norm_affine(
    x,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm-apply and the FiLMs collapsed into per-(batch, channel)
    f32 rows ``(A, B)`` [B, C] with ``adagn(x) == x * A + B`` up to f32
    reassociation. ``x`` is one NHWC tensor or a list of skip-concat pieces
    (joint statistics over the concat, from per-piece sums: the concat is
    never built). One-pass statistics in f32, var clamped at 0, eps 1e-5.
    The rows feed the fused quantize-conv kernel (``ops/cuda/qconv.py``).
    Plain torch, as the JAX package leaves them to XLA."""
    pieces = list(x) if isinstance(x, (tuple, list)) else [x]
    B = pieces[0].shape[0]
    C = sum(p.shape[-1] for p in pieces)
    f32 = torch.float32
    flat = [p.to(f32).reshape(B, -1, p.shape[-1]) for p in pieces]
    n = flat[0].shape[1]
    s1 = torch.cat([p.sum(dim=1) for p in flat], dim=-1)
    s2 = torch.cat([p.square().sum(dim=1) for p in flat], dim=-1)
    gs = C // num_groups
    count = n * gs
    mean = s1.reshape(B, num_groups, gs).sum(-1) / count
    var = s2.reshape(B, num_groups, gs).sum(-1) / count - mean.square()
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + EPS)
    mean_c = mean.repeat_interleave(gs, dim=1)
    rstd_c = rstd.repeat_interleave(gs, dim=1)
    A = rstd_c * scale.to(f32)[None, :]
    Brow = bias.to(f32)[None, :] - mean_c * A
    for fs, fb in films:
        fs, fb = fs.to(f32), fb.to(f32)
        A = A * (1.0 + fs)
        Brow = Brow * (1.0 + fs) + fb
    return A, Brow
