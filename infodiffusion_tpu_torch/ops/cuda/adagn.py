"""K1: fused GroupNorm + K FiLMs (AdaGN), a CUDA kernel and its plain version.

Replaces ``infodiffusion_tpu/ops/pallas/adagn.py`` (``adagn_pallas``,
``_kernel``). Kernel: ``csrc/adagn.cu``. What bounds it on the card is
memory bandwidth: a few FLOPs an element, so the least it can take is x
read once and written once. :func:`adagn_launch_plan` picks its body: where
one batch element fits a thread-block cluster's shared memory (every 64px
site), the cluster holds it, sums it and exchanges the group sums through
distributed shared memory, so x crosses HBM once in one launch; beyond 16
ranks (the 512px levels) a (split, batch) grid that fills the card streams
x twice with 16-byte accesses.

Contract (both versions): statistics in f32 with one-pass
``var = E[x^2] - mean^2`` clamped at 0 (the XLA form in
``ops/norm.py``; the Pallas kernel lacks the clamp), eps 1e-5, then
``(x - mean) * rstd * gamma + beta`` and ``h * (1 + s_k) + b_k`` for each
FiLM, all in f32, rounded once to x's dtype. (The JAX XLA form rounds to
x's dtype after the affine as well, before the FiLMs; in f32 that is the
same.) SiLU is not fused, as in the JAX kernel. The kernel takes C <= 1024
with C % 32 == 0, any HW >= 1, f32 and bf16 x, FiLM rows [B, C] of either
dtype with any row stride (the ``chunk`` of a projection) read in place.

The backward (``adagn_bwd_cuda``, ``csrc/adagn_bwd.cu``; plain version
``adagn_bwd_reference``) is the gradient XLA's autodiff of
``infodiffusion_tpu/ops/norm.py`` ``adagn`` computes; the JAX package
has no Pallas kernel for it. It runs on the same plan with x and dy
resident, and reuses the forward's per-(b, g) mean, rstd and clamp flag
[B, 3, G]. ``ops.norm.adagn`` wraps both directions in one
``autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence, Tuple

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

EPS = 1e-5
MAX_FILMS = 2
MAX_C = 1024
# the plan's arithmetic (csrc/adagn_common.cuh make_plan)
_SM_SMEM = 233472       # bytes of shared memory an SM has, 1 KB a block kept
_THREAD_TARGET = 256
_BAR_BYTES = 8 * 16     # a chunk's mbarrier, 16 chunks
_STREAM_BLOCKS = 16     # stream blocks an SM, at any batch
_MIN_ROWS = 4           # rows a lane, at least, in a split


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


def _vec(dtype: torch.dtype) -> int:
    """Elements of a 16-byte vector."""
    return 8 if dtype == torch.bfloat16 else 4


def adagn_threads(C: int, dtype: torch.dtype) -> int:
    """Threads of a K1 block: a multiple of the row's vpr = C / V vectors
    (each thread keeps one vector column, so the same V channels) near 256,
    a multiple of 32 where one is."""
    vpr = C // _vec(dtype)
    step = 32 // math.gcd(vpr, 32)
    return max(step, _THREAD_TARGET // vpr // step * step) * vpr


@functools.lru_cache(maxsize=None)
def adagn_launch_plan(B: int, HW: int, C: int, K: int, dtype: torch.dtype,
                      sms: int, max_active_clusters: int, *,
                      groups: int = 32, backward: bool = False) -> dict:
    """What K1 (``backward``: its backward, with x and dy resident)
    launches for x [B, HW, C] of ``dtype`` with K FiLMs on a card of
    ``sms`` SMs that co-schedules ``max_active_clusters`` clusters of 16
    blocks at the most shared memory.

    ``body`` "resident": clusters of ``ranks`` (1, 2, 4, 8, 16) blocks, one
    a batch element, rank q holding rows [q rows, (q + 1) rows) in
    ``smem`` bytes of shared memory: the most blocks an SM (4, 3, 2, 1) at
    which some rank count holds the element, then the fewest ranks (16
    only where the card holds such a cluster). ``body`` "stream"
    otherwise: ``splits`` splits of ``rows`` rows a batch element, about
    16 blocks an SM at any batch. ``threads`` a block
    (:func:`adagn_threads`), ``lanes`` row lanes of it. Cached: the dict is
    shared, so callers read it only."""
    if C % 32 or not 32 <= C <= MAX_C or C % groups or HW < 1 or B < 1:
        raise ValueError(f"adagn kernel takes C <= {MAX_C}, a multiple of 32 "
                         f"and of the groups, HW >= 1; got C={C}, "
                         f"G={groups}, HW={HW}, B={B}")
    threads = adagn_threads(C, dtype)
    e = torch.finfo(dtype).bits // 8
    lanes = threads // (C // _vec(dtype))
    # the channel sums a block folds, one row a warp where a warp holds
    # several row lanes of each vector column, else one a row lane
    vpr = C // _vec(dtype)
    sum_rows = threads // (32 if vpr < 32 and 32 % vpr == 0 else vpr)
    rows_c, rows_g = (5, 5) if backward else (2, 4)
    extra = 4 * (2 * sum_rows * C + rows_c * C + rows_g * groups)
    common = dict(threads=threads, lanes=lanes, sms=sms,
                  max_active_clusters=max_active_clusters)
    ranks = (1, 2, 4, 8, 16) if max_active_clusters > 0 else (1, 2, 4, 8)
    for per_sm in (4, 3, 2, 1):
        limit = (_SM_SMEM - per_sm * 1024) // per_sm
        for r in ranks:
            rows = _cdiv(HW, r)
            slab = rows * C * e * (2 if backward else 1)
            smem = _BAR_BYTES + extra + _cdiv(slab, 128) * 128
            if smem <= limit:
                return dict(body="resident", ranks=r, rows=rows, splits=1,
                            smem=smem, per_sm=per_sm, blocks=B * r,
                            **common)
    s0 = max(1, min(_cdiv(_STREAM_BLOCKS * sms, B),
                    HW // (_MIN_ROWS * lanes)))
    rows = _cdiv(_cdiv(HW, s0), lanes) * lanes
    splits = _cdiv(HW, rows)
    return dict(body="stream", ranks=1, rows=rows, splits=splits,
                smem=extra, per_sm=None, blocks=B * splits, **common)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def _card(index: int, dtype: torch.dtype, backward: bool):
    """(SMs, clusters of 16 resident blocks the card co-schedules) of card
    ``index`` for K1 (``backward``: its backward) of ``dtype``."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    lib = _lib.library().lib
    fn = lib.infodiff_adagn_bwd_clusters if backward else \
        lib.infodiff_adagn_clusters
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(_lib.DTYPE_CODES[dtype], ctypes.byref(n))
    _lib.check_launch(err, "adagn_clusters")
    return sms, n.value


@functools.lru_cache(maxsize=None)
def _config(index: int, B: int, HW: int, C: int, G: int, K: int,
            dtype: torch.dtype, fstrides: tuple, fcode: int, backward: bool):
    """(plan, the address of the C entries' config ints: card, shapes,
    FiLM strides and dtype, x's dtype, then the plan with what it was made
    from) on card ``index``; cached with the array it points into."""
    sms, active = _card(index, dtype, backward)
    plan = adagn_launch_plan(B, HW, C, K, dtype, sms, active, groups=G,
                             backward=backward)
    ints = (ctypes.c_int * 20)(
        index, B, HW, C, G, K, *fstrides, fcode, _lib.DTYPE_CODES[dtype],
        sms, active, 0 if plan["body"] == "resident" else 1, plan["ranks"],
        plan["rows"], plan["splits"], plan["threads"], plan["smem"])
    return plan, ctypes.addressof(ints), ints


def adagn_plan_on(device, B: int, HW: int, C: int, K: int,
                  dtype: torch.dtype, groups: int = 32,
                  backward: bool = False) -> dict:
    """:func:`adagn_launch_plan` for the card ``device`` is on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return adagn_launch_plan(B, HW, C, K, dtype, *_card(index, dtype,
                                                        backward),
                             groups=groups, backward=backward)


_X_DTYPES = tuple(_lib.DTYPE_CODES)
_NO_FILMS = ((None,) * 4, (0,) * 4, 0, [])


def _check_args(x, num_groups, scale, bias, films):
    _lib.check_tensor(x, "x", dtypes=_X_DTYPES)
    B, C = x.shape[0], x.shape[-1]
    HW = x.numel() // (B * C) if B * C else 0
    G, K = num_groups, len(films)
    if C % 32 or C % G or C > MAX_C or K > MAX_FILMS or HW == 0:
        raise ValueError(
            f"adagn kernel takes C <= {MAX_C}, a multiple of 32 divisible by "
            f"the groups, <= {MAX_FILMS} films, a non-empty tensor; got "
            f"C={C}, G={G}, K={K}, HW={HW}"
        )
    for name, t in (("scale", scale), ("bias", bias)):
        _lib.check_tensor(t, name, shape=(C,), dtypes=(torch.float32,),
                          device=x.device)
    return B, HW, C, G, K


def _film_args(films, B: int, C: int, x: torch.Tensor):
    """The FiLM rows as the C entries take them: (4 pointers, 4 row
    strides, their dtype code, the tensors). Rows [B, C] of one dtype (f32
    or bf16) on x's card are read in place at any row stride; rows of
    mixed dtypes are made f32, rows with a column stride contiguous."""
    flat = [t for pair in films for t in pair]
    if not flat:
        return _NO_FILMS
    dtype = flat[0].dtype
    if dtype not in _lib.DTYPE_CODES or any(t.dtype != dtype for t in flat):
        flat, dtype = [t.to(torch.float32) for t in flat], torch.float32
    index = x.get_device()
    ptrs, strides = [None] * 4, [0] * 4
    for i, t in enumerate(flat):
        if t.shape != (B, C) or t.get_device() != index:
            raise ValueError(f"films: [{B}, {C}] rows on {x.device} "
                             f"expected, got {tuple(t.shape)} on {t.device}")
        if t.stride(1) != 1:
            flat[i] = t = t.contiguous()
        ptrs[i], strides[i] = t.data_ptr(), t.stride(0)
    return ptrs, tuple(strides), _lib.DTYPE_CODES[dtype], flat


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

    Limits: C <= 1024 a multiple of 32, C % num_groups == 0, at most two
    FiLMs. Raises on anything else; never falls back to the plain version.
    With ``return_stats`` also returns the per-(b, g) mean, rstd and clamp
    flag [B, 3, G] that the backward kernel reuses.
    """
    B, HW, C, G, K = _check_args(x, num_groups, scale, bias, films)
    # flat holds the FiLM rows _film_args made (f32 or contiguous copies),
    # which the launch reads: bound to a name, they outlive it
    fptrs, fstrides, fcode, flat = _film_args(films, B, C, x)
    index = x.get_device()
    plan, config, _ = _config(index, B, HW, C, G, K, x.dtype, fstrides,
                              fcode, False)
    stream = plan["body"] == "stream"
    stats = (torch.empty((B, 3, G), dtype=torch.float32, device=x.device)
             if return_stats or stream else None)
    scratch = (torch.empty((B, plan["splits"], 2, G), dtype=torch.float32,
                           device=x.device) if stream else None)
    out = torch.empty_like(x)
    err = _lib.library().lib.infodiff_adagn(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), *fptrs,
        out.data_ptr(), stats.data_ptr() if stats is not None else None,
        scratch.data_ptr() if stream else None, config,
        _lib.stream_handle(index))
    _lib.check_launch(err, "adagn")
    adagn_cuda.launches += 1
    return (out, stats) if return_stats else out


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
    tensors; ``stats`` is the forward's [B, 3, G]
    (``adagn_cuda(..., return_stats=True)``). Returns what
    ``adagn_bwd_reference`` returns. Raises on what the kernel does not
    take."""
    B, HW, C, G, K = _check_args(x, num_groups, scale, bias, films)
    _lib.check_tensor(dy, "dy", shape=x.shape, dtypes=(x.dtype,),
                      device=x.device)
    _lib.check_tensor(stats, "stats", shape=(B, 3, G),
                      dtypes=(torch.float32,), device=x.device)
    fptrs, fstrides, fcode, flat = _film_args(films, B, C, x)
    index = x.get_device()
    plan, config, _ = _config(index, B, HW, C, G, K, x.dtype, fstrides,
                              fcode, True)
    # gpart [B, 2, C] and the stream body's scratch; dgamma and dbeta in a
    # buffer of their own, so the gradients keep no scratch alive
    extra = (B * plan["splits"] * 2 * C + B * 2 * G
             if plan["body"] == "stream" else 0)
    buf = torch.empty(2 * B * C + extra, dtype=torch.float32,
                      device=x.device)
    dgb = torch.empty((2, C), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dfl = (torch.empty((2 * K, B, C), dtype=flat[0].dtype, device=x.device)
           if K else None)
    ptr = buf.data_ptr()
    err = _lib.library().lib.infodiff_adagn_bwd(
        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), *fptrs, dx.data_ptr(),
        dfl.data_ptr() if K else None, ptr,
        ptr + 2 * B * C * 4 if extra else None, dgb[0].data_ptr(),
        dgb[1].data_ptr(), config, _lib.stream_handle(index))
    _lib.check_launch(err, "adagn_bwd")
    adagn_bwd_cuda.launches += 1
    # in each FiLM's dtype (made f32 above where the rows' dtypes differ)
    dfilms = [(_as(dfl[2 * k], s.dtype), _as(dfl[2 * k + 1], b.dtype))
              for k, (s, b) in enumerate(films)]
    return dx, dgb[0], dgb[1], dfilms


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


adagn_bwd_cuda.launches = 0
