"""K3a, K3b and K3c: the flash-attention forwards and backward, CUDA
kernels and their plain versions, and the route between them and K2.

Replace ``infodiffusion_tpu/ops/pallas/flash_attention.py``: K3a the
primary forward (``_kernel`` / ``_fwd_call``), kernel
``csrc/flash_attention.cu``; K3b the backward (``_bwd_kernel`` /
``_bwd_call``), kernel ``csrc/flash_attention_bwd.cu``; K3c the online
forward (``_online_kernel`` / ``flash_attention_online``), kernel
``csrc/flash_attention_online.cu``. Each takes C = 64, 128, 256 or 512
and any N, and counts its launches in total and per C (``launches_by_c``).
At C = 64 the kernels' 128-channel tiles hold zeros in channels 64-127
and store only the first 64: the function is exactly that of C = 64.

Forward contract of K3a (``_kernel``, the same as K2's): f32 logits times
C^-1/2, f32 softmax, the weights rounded to v's dtype before PV, f32
accumulation, the output in v's dtype. Its plain version is
``attention_reference``.

Forward contract of K3c (``_online_kernel``), per k tile: m' = max(m,
rowmax s), p = exp(s - m') in f32, l' = l exp(m - m') + rowsum(p), acc' =
acc exp(m - m') + (p rounded to v's dtype) v, and out = acc / l in v's
dtype. In bf16 that differs from K3a's function: p is rounded before the
division by l. Its plain version ``flash_attention_online_reference`` walks
k in the JAX package's tiles; the kernel's tiles are 64 keys, so in bf16
the two differ by the rounding of p.

Backward contract (``_bwd_kernel``, the backward of both forwards): w
recomputed in f32, ``dp = do v^T``, ``delta = rowsum(w dp)``,
``ds = w (dp - delta) scale``, then ``dq = ds_c k``, ``dk = ds_c^T q``,
``dv = w_c^T do`` with ds rounded to q's dtype and w to v's, accumulated
in f32. In bf16 that differs from autograd of ``attention_reference``
(which rounds dp through the cast); the plain version
``flash_attention_bwd_reference`` follows the kernel.

The route (``flash_route``) is the JAX package's, as arithmetic on (N, C,
dtype): its gate (``flash_enabled``: ``INFODIFF_DISABLE_FLASH_ATTENTION``,
``INFODIFF_FLASH_ATTN_MIN_TOKENS``), then ``flash_attention``'s choice
between the primary kernel, whose whole-k/v plan must fit
``_FWD_PLAN_LIMIT`` (``_pick_block_q``, ``_check_envelope``), and the
online kernel, whose tiles must divide N (``_pick_online_tiles``); where
neither takes the shape, the dense attention K2. These TPU VMEM budgets
decide which function (K3a's or K3c's rounding) a shape gets, so they are
kept as they are; the card's kernels have no such limits. The mesh
refusal has no counterpart: the port has no mesh.

The products bound the kernels at the model's shapes: bf16 runs them on
the tensor cores (``mma.sync``, f32 accumulation, ``csrc/flash_mma.cuh``),
f32 as FMAs on f32 tiles (``csrc/flash_common.cuh``).
"""

from __future__ import annotations

import os

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib
from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)

CHANNELS = (64, 128, 256, 512)  # the C the flash kernels are compiled for

# the JAX package's plan arithmetic (flash_attention.py), in bytes
_LOGITS_BUDGET = 4 * 1024 * 1024
_FWD_PLAN_LIMIT = 15 * 1024 * 1024 + 512 * 1024
_ONLINE_BQ = 256
_ONLINE_BK = 1024


def flash_min_tokens() -> int:
    return int(os.environ.get("INFODIFF_FLASH_ATTN_MIN_TOKENS", "512"))


def flash_enabled(n_tokens: int) -> bool:
    """The JAX gate: flash attention from ``flash_min_tokens()`` tokens,
    never under ``INFODIFF_DISABLE_FLASH_ATTENTION=1``."""
    if os.environ.get("INFODIFF_DISABLE_FLASH_ATTENTION") == "1":
        return False
    return n_tokens >= flash_min_tokens()


def _pick_block_q(n: int, c: int) -> int:
    """The primary kernel's q tile: the largest power of two from 512 down
    to 8 whose [BQ, N] f32 strip fits ``_LOGITS_BUDGET`` and divides N."""
    bq = 512
    while bq > 8 and (bq * n * 4 > _LOGITS_BUDGET or n % bq != 0):
        bq //= 2
    return bq


def _check_envelope(n: int, c: int, itemsize: int, bq: int) -> bool:
    """Whether the primary kernel's plan fits: k and v whole and double
    buffered, the f32 strip, the q and o tiles double buffered."""
    kv = 2 * n * c * itemsize
    strip = bq * n * 4
    tiles = 4 * bq * c * itemsize
    return 2 * kv + strip + tiles <= _FWD_PLAN_LIMIT


def _pick_online_tiles(n: int) -> tuple[int, int]:
    bq, bk = _ONLINE_BQ, _ONLINE_BK
    while bq > 8 and n % bq:
        bq //= 2
    while bk > 128 and n % bk:
        bk //= 2
    return bq, bk


def flash_plan(n: int, c: int, dtype: torch.dtype) -> str:
    """``flash_attention``'s choice for [B, n, c] of ``dtype``: 'flash'
    (K3a) where the primary plan fits, else 'flash_online' (K3c) where the
    online tiles divide n, else 'attention' (K2)."""
    bq = _pick_block_q(n, c)
    itemsize = torch.finfo(dtype).bits // 8
    if n % bq == 0 and _check_envelope(n, c, itemsize, bq):
        return "flash"
    obq, obk = _pick_online_tiles(n)
    if n % obq or n % obk:
        return "attention"
    return "flash_online"


def flash_route(n: int, c: int, dtype: torch.dtype) -> str:
    """The kernel the JAX package's ``single_head_attention`` runs on its
    device for q [B, n, c] of ``dtype``: 'attention' (K2), 'flash' (K3a)
    or 'flash_online' (K3c)."""
    if not flash_enabled(n):
        return "attention"
    return flash_plan(n, c, dtype)


def flash_attention_online_reference(q, k, v, block_k=None):
    """Plain PyTorch K3c: q, k, v [B, N, C] -> [B, N, C] in v's dtype,
    walking k in ``block_k``-key tiles (default: the JAX package's,
    ``_pick_online_tiles``). Never forms the [B, N, N] logits."""
    B, N, C = q.shape
    bk = block_k or _pick_online_tiles(N)[1]
    f32 = torch.float32
    qf = q.to(f32)
    m = torch.full((B, N, 1), -torch.inf, dtype=f32, device=q.device)
    l = torch.zeros((B, N, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, N, C), dtype=f32, device=q.device)
    for j in range(0, N, bk):
        s = torch.einsum("bnc,bmc->bnm", qf, k[:, j:j + bk].to(f32)) * (
            C ** -0.5)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bnm,bmc->bnc", p.to(v.dtype).to(f32), v[:, j:j + bk].to(f32))
        m = m_new
    return (acc / l).to(v.dtype)


def flash_attention_bwd_reference(q, k, v, do):
    """Plain PyTorch K3b: (dq, dk, dv) for q, k, v, do [B, N, C]."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    w = torch.softmax(torch.einsum("bnc,bmc->bnm", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bnc,bmc->bnm", dof, vf)
    delta = (w * dp).sum(dim=-1, keepdim=True)
    ds = (w * (dp - delta)) * scale
    ds_c = ds.to(q.dtype).to(f32)
    w_c = w.to(v.dtype).to(f32)
    dq = torch.einsum("bnm,bmc->bnc", ds_c, kf)
    dk = torch.einsum("bnm,bnc->bmc", ds_c, qf)
    dv = torch.einsum("bnm,bnc->bmc", w_c, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(tensors, names):
    q = tensors[0]
    _lib.check_tensor(q, names[0], dtypes=tuple(_lib.DTYPE_CODES))
    if q.ndim != 3 or q.shape[-1] not in CHANNELS or q.shape[1] == 0:
        raise ValueError(f"flash attention kernels take [B, N>0, C] with C "
                         f"in {CHANNELS}, got {tuple(q.shape)}")
    for name, t in zip(names[1:], tensors[1:]):
        _lib.check_tensor(t, name, shape=q.shape, dtypes=(q.dtype,),
                          device=q.device)


def _forward(entry, fn, q, k, v):
    _check((q, k, v), ("q", "k", "v"))
    B, N, C = q.shape
    out = torch.empty_like(v)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, C,
            _lib.DTYPE_CODES[q.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, entry)
    fn.launches += 1
    fn.launches_by_c[C] += 1
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Launch K3a on contiguous CUDA q, k, v [B, N, C] of one dtype (f32
    or bf16), C in ``CHANNELS``. Raises on anything else."""
    return _forward("infodiff_flash_attention", flash_attention_cuda, q, k, v)


def flash_attention_online_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """Launch K3c on contiguous CUDA q, k, v [B, N, C] of one dtype (f32
    or bf16), C in ``CHANNELS``. Raises on anything else."""
    return _forward("infodiff_flash_attention_online",
                    flash_attention_online_cuda, q, k, v)


def flash_attention_bwd_cuda(q, k, v, do):
    """Launch K3b on contiguous CUDA q, k, v, do [B, N, C] of one dtype, C
    in ``CHANNELS``; returns (dq, dk, dv). Raises on anything else."""
    _check((q, k, v, do), ("q", "k", "v", "do"))
    B, N, C = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rowstats = torch.empty((B, N, 3), dtype=torch.float32, device=q.device)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rowstats.data_ptr(),
            B, N, C, _lib.DTYPE_CODES[q.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_c[C] += 1
    return dq, dk, dv


for _fn in (flash_attention_cuda, flash_attention_online_cuda,
            flash_attention_bwd_cuda):
    _fn.launches = 0
    _fn.launches_by_c = dict.fromkeys(CHANNELS, 0)  # per C

# route -> (kernel, plain version); K3a shares K2's contract and plain version
_FORWARDS = {
    "attention": (attention_cuda, attention_reference),
    "flash": (flash_attention_cuda, attention_reference),
    "flash_online": (flash_attention_online_cuda,
                     flash_attention_online_reference),
}


def forward_for(route: str, cuda: bool):
    """The forward ``flash_route`` names: its kernel for CUDA tensors
    (``cuda``), else its plain version."""
    kernel, plain = _FORWARDS[route]
    return kernel if cuda else plain
