"""K3a, K3b and K3c: the flash-attention forwards and backward, CUDA
kernels and their plain versions, and the route between them and K2.

Replace ``infodiffusion_tpu/ops/pallas/flash_attention.py``: K3a the
primary forward (``_kernel`` / ``_fwd_call``), kernel
``csrc/flash_attention.cu``; K3b the backward (``_bwd_kernel`` /
``_bwd_call``), kernel ``csrc/flash_attention_bwd.cu``; K3c the online
forward (``_online_kernel`` / ``flash_attention_online``), kernel
``csrc/flash_attention_online.cu``. Each takes C = 64, 128, 256 or 512
and any N, and counts its launches in total and per C (``launches_by_c``);
K3b also per contract (``launches_by_contract``).

Forward contract of K3a (``_kernel``, the same as K2's): f32 logits times
C^-1/2, f32 softmax, the weights rounded to v's dtype before PV, f32
accumulation, the output in v's dtype. Its plain version is
``attention_reference``.

Forward contract of K3c (``_online_kernel``), per k tile: m' = max(m,
rowmax s), p = exp(s - m') in f32, l' = l exp(m - m') + rowsum(p), acc' =
acc exp(m - m') + (p rounded to v's dtype) v, and out = acc / l in v's
dtype. In bf16 that differs from K3a's function: p is rounded before the
division by l. Its plain version ``flash_attention_online_reference`` walks
k in ``block_k``-key tiles (default the JAX package's); the kernel's tile
is ``flash_launch_plan``'s BK, so in bf16 the two differ by the rounding
of p unless the plain version is given the kernel's tile.

The bf16 forwards run on Hopper's warpgroup products (``wgmma``, f32
accumulation; ``csrc/flash_wgmma.cuh``) with k and v streamed by TMA through
a ring in shared memory; ``flash_launch_plan`` says what a shape launches.
The bf16 backward runs on the same design (``csrc/flash_bwd_wgmma.cuh``:
the row statistics in one online pass, then dq; dk and dv in a second
launch); ``flash_bwd_launch_plan`` says what it launches. f32 runs them as
FMAs on f32 tiles (``csrc/flash_common.cuh``).

The backward has two contracts, and ``bwd_route`` picks the one the JAX
package differentiates for (N, C, dtype):

- ``"flash"``, the Pallas backward's (``_bwd_kernel``), where JAX runs
  ``_bwd_call``: w recomputed in f32, ``dp = do v^T``, ``delta =
  rowsum(w dp)``, ``ds = w (dp - delta) scale``, then ``dq = ds_c k``,
  ``dk = ds_c^T q``, ``dv = w_c^T do`` with ds rounded to q's dtype and w
  to v's, accumulated in f32. Plain version
  ``flash_attention_bwd_reference``.
- ``"dense"``, XLA's autodiff of ``_attention_xla``, which JAX runs below
  ``flash_min_tokens()`` (the K2 route has no VJP of its own) and wherever
  ``_bwd_call``'s plan refuses the shape (``_flash_bwd`` falls back to
  ``_dense_vjp``): dp = do v^T rounded to v's dtype, ``delta =
  rowsum(w dp)``, ds = w (dp - delta) scale kept in f32 into ``dq = ds k``
  and ``dk = ds^T q``, ``dv = w_c^T do``. Plain version
  ``attention_dense_bwd_reference``; the kernel carries ds into its bf16
  products as hi = bf16(ds) plus lo = bf16(ds - hi).

In f32 the two contracts are one function. Both run on K3b's kernels.

The routes (``flash_route``, ``bwd_route``) are the JAX package's, as
arithmetic on (N, C, dtype): its gate (``flash_enabled``:
``INFODIFF_DISABLE_FLASH_ATTENTION``, ``INFODIFF_FLASH_ATTN_MIN_TOKENS``),
then ``flash_attention``'s choice between the primary kernel, whose
whole-k/v plan must fit ``_FWD_PLAN_LIMIT`` (``_pick_block_q``,
``_check_envelope``), and the online kernel, whose tiles must divide N
(``_pick_online_tiles``); where neither takes the shape, the dense
attention K2. The backward's plan is ``_bwd_call``'s (``_ACC_BUDGET``,
``_pick_block_q_bwd``, ``_BWD_PLAN_LIMIT``). These TPU VMEM budgets
decide which function a shape gets, so they are kept as they are; the
card's kernels have no such limits. The mesh refusal has no counterpart:
the port has no mesh.
"""

from __future__ import annotations

import functools
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
_ACC_BUDGET = 8 * 1024 * 1024
_BWD_PLAN_LIMIT = 16 * 1024 * 1024


# the bf16 forwards' tiles (csrc/flash_wgmma.cuh), per C: the k/v tile BK
# and the stages of each ring
_WGMMA_TILES = {64: (128, 3), 128: (128, 2), 256: (64, 2), 512: (32, 2)}
SMS = 132  # the H100's streaming multiprocessors


def flash_launch_plan(B: int, N: int, C: int, dtype: torch.dtype) -> dict:
    """What K3a and K3c launch in bf16 for [B, N, C] (their body,
    ``csrc/flash_wgmma.cuh``): query rows a block ``bq``, consumer
    ``warpgroups``, the k/v tile ``bk``, the ring's ``stages``, the
    ``threads``, ``smem`` bytes and ``blocks`` of the grid. BQ is 128 (two
    warpgroups of 64 rows) while that grid has at least as many blocks as
    the card has SMs, else 64 (one); C = 512 takes 64 rows on two
    warpgroups, which split the output's channels."""
    if dtype != torch.bfloat16 or C not in _WGMMA_TILES:
        raise ValueError(f"the wgmma body takes bf16 at C in {CHANNELS}, got "
                         f"{dtype} at C={C}")
    bk, stages = _WGMMA_TILES[C]
    split = C == 512
    bq = 64 if split or B * -(-N // 128) < SMS else 128
    warpgroups = 2 if split else bq // 64
    smem = (1024 + bq * C * 2 + 2 * stages * bk * C * 2
            + (64 * bk * 2 + 2 * 64 * 4 if split else 0) + 128)
    return dict(bq=bq, warpgroups=warpgroups, bk=bk, stages=stages,
                threads=128 * (warpgroups + 1), smem=smem,
                blocks=B * -(-N // bq))


# K3b's bf16 tiles (csrc/flash_bwd_wgmma.cuh), per C: the streamed tile
# (k/v rows of the rows launch, q/do rows of the cols launch) and the
# stages of each ring
_BWD_TILES = {64: (64, 3), 128: (64, 3), 256: (64, 2), 512: (32, 1)}
STAT_ALIGN = 128  # the statistics scratch's rows: N rounded up to this


def flash_bwd_launch_plan(B: int, N: int, C: int, dtype: torch.dtype) -> dict:
    """What K3b launches in bf16 for [B, N, C] (its body,
    ``csrc/flash_bwd_wgmma.cuh``), both contracts: ``rows`` (dq and the row
    statistics: query rows a block ``bq``, the k/v tile ``bk``) and
    ``cols`` (dk and dv: keys a block ``bk``, the q/do tile ``bq``), each
    with its consumer ``warpgroups``, ring ``stages``, ``threads``,
    ``smem`` bytes and ``blocks``; ``stat_rows`` is the statistics
    scratch's rows per batch element (f32 [B, 2, stat_rows]). At C = 64 /
    128 a warpgroup owns 64 rows (keys), two a block while the grid of
    128-row blocks has at least as many blocks as the card has SMs, else
    one; at C = 256 / 512 two warpgroups share 64 rows and split the
    output's channels."""
    if dtype != torch.bfloat16 or C not in _BWD_TILES:
        raise ValueError(f"K3b's wgmma body takes bf16 at C in {CHANNELS}, "
                         f"got {dtype} at C={C}")
    tile, stages = _BWD_TILES[C]
    split = C >= 256
    wg = 2 if split or B * -(-N // 128) >= SMS else 1
    own = 64 if split else 64 * wg  # rows (keys) a block
    threads = 128 * (wg + 1)
    ring = 2 * stages * tile * C * 2  # two tiles a stage
    rows = dict(bq=own, bk=tile, warpgroups=wg, stages=stages,
                threads=threads, blocks=B * -(-N // own),
                smem=1024 + 2 * own * C * 2 + ring
                + (2 * 64 * tile * 2 if split else 0) + 64)
    cols = dict(bk=own, bq=tile, warpgroups=wg, stages=stages,
                threads=threads, blocks=B * -(-N // own),
                smem=1024 + 2 * own * C * 2 + ring + stages * 2 * tile * 4
                + (3 * 64 * tile * 2 if split else 0) + 64)
    return dict(rows=rows, cols=cols,
                stat_rows=-(-N // STAT_ALIGN) * STAT_ALIGN)


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


def _pick_block_q_bwd(n: int, c: int) -> int:
    """The backward's q tile: its three live [BQ, N] f32 strips get the
    logits budget."""
    bq = 512
    while bq > 8 and (3 * bq * n * 4 > _LOGITS_BUDGET or n % bq != 0):
        bq //= 2
    return bq


def bwd_route(n: int, c: int, dtype: torch.dtype) -> str:
    """The gradient the JAX package takes for q [B, n, c] of ``dtype``:
    'flash' where its forward is a flash kernel and ``_bwd_call``'s plan
    takes the shape (the Pallas backward's contract), else 'dense' (XLA's
    autodiff of the dense attention)."""
    if flash_route(n, c, dtype) == "attention":
        return "dense"
    if 2 * n * c * 4 > _ACC_BUDGET:
        return "dense"
    bq = _pick_block_q_bwd(n, c)
    if n % bq:
        return "dense"
    kv = 2 * n * c * (torch.finfo(dtype).bits // 8)
    acc = 2 * n * c * 4
    if 2 * kv + 2 * acc + 3 * bq * n * 4 > _BWD_PLAN_LIMIT:
        return "dense"
    return "flash"


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


def attention_dense_bwd_reference(q, k, v, do):
    """Plain PyTorch K3b on the dense contract: (dq, dk, dv) for q, k, v,
    do [B, N, C], XLA's autodiff of ``_attention_xla``: dp rounded to v's
    dtype, ds in f32 into dq and dk, w rounded to v's dtype for dv."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    w = torch.softmax(torch.einsum("bnc,bmc->bnm", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bnc,bmc->bnm", dof, vf).to(v.dtype).to(f32)
    delta = (w * dp).sum(dim=-1, keepdim=True)
    ds = (w * (dp - delta)) * scale
    dq = torch.einsum("bnm,bmc->bnc", ds, kf)
    dk = torch.einsum("bnm,bnc->bmc", ds, qf)
    dv = torch.einsum("bnm,bnc->bmc", w.to(v.dtype).to(f32), dof)
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
    plan = (flash_launch_plan(B, N, C, q.dtype) if q.dtype == torch.bfloat16
            else dict(bq=0, smem=0))
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, C,
            _lib.DTYPE_CODES[q.dtype], plan["bq"], plan["smem"],
            _lib.stream_handle(),
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


CONTRACTS = {"flash": 0, "dense": 1}  # K3b's contract codes


def flash_attention_bwd_cuda(q, k, v, do, contract: str = "flash"):
    """Launch K3b on contiguous CUDA q, k, v, do [B, N, C] of one dtype, C
    in ``CHANNELS``, on ``contract`` ('flash' or 'dense', ``bwd_route``);
    returns (dq, dk, dv). Raises on anything else."""
    code = CONTRACTS[contract]
    _check((q, k, v, do), ("q", "k", "v", "do"))
    B, N, C = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        plan = flash_bwd_launch_plan(B, N, C, q.dtype)
        launch = (plan["rows"]["bq"], plan["rows"]["smem"],
                  plan["cols"]["bk"], plan["cols"]["smem"], plan["stat_rows"])
        stats = torch.empty((B, 2, plan["stat_rows"]), dtype=torch.float32,
                            device=q.device)
    else:
        launch = (0, 0, 0, 0, 0)
        stats = torch.empty((B, N, 3), dtype=torch.float32, device=q.device)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, N, C, _lib.DTYPE_CODES[q.dtype], code, *launch,
            _lib.stream_handle(),
        )
    _lib.check_launch(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_c[C] += 1
    flash_attention_bwd_cuda.launches_by_contract[contract] += 1
    return dq, dk, dv


for _fn in (flash_attention_cuda, flash_attention_online_cuda,
            flash_attention_bwd_cuda):
    _fn.launches = 0
    _fn.launches_by_c = dict.fromkeys(CHANNELS, 0)  # per C
flash_attention_bwd_cuda.launches_by_contract = dict.fromkeys(CONTRACTS, 0)

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


def backward_for(route: str, cuda: bool):
    """The backward ``bwd_route`` names, as fn(q, k, v, do) -> (dq, dk,
    dv): K3b on that contract for CUDA tensors (``cuda``), else the
    contract's plain version."""
    if cuda:
        return functools.partial(flash_attention_bwd_cuda, contract=route)
    return {"flash": flash_attention_bwd_reference,
            "dense": attention_dense_bwd_reference}[route]
