"""K6: the fused residual + 1x1 shortcut epilogue of a ResBlock, a CUDA
kernel and its plain version.

Replaces ``infodiffusion_tpu/ops/pallas/shortcut_fused.py``
(``fused_shortcut_add``, ``_kernel``). Kernel: ``csrc/shortcut_fused.cu``;
what bounds it and what its design does about that: see the source.

Contract (both versions)::

    out = f32(h) + f32(bias) + sum_i p_i . W[:, o_i : o_i + C_i]^T

with the product inputs in h's dtype, f32 accumulation and the output in
h's dtype, rounded once. h [..., N] and the pieces [..., C_i] share their
leading dims (NHWC: the rows are pixels); the pieces (one, or the two of
an up block's skip concat) are never concatenated. ``weight`` is the
shortcut's [N, sum C_i] matrix as the ``Dense`` stores it (the transpose
of the Flax kernel), so the kernel reads the parameter in place, cast to
h's dtype; ``bias`` [N].

Opt-in, as in the JAX package: ``INFODIFF_ENABLE_FUSED_SHORTCUT=1`` routes
the shortcuts of a model on a CUDA tensor through K6;
``INFODIFF_FORCE_FUSED_SHORTCUT=1`` takes the route on any device (the
plain version on the CPU); ``INFODIFF_DISABLE_PALLAS=1`` wins over both.
The default route (``nn.blocks.ShortcutDense``) rounds twice in bf16
(``x W + b``, then ``+ h``); K6 rounds once. The two agree in f32.

The gradient is one ``autograd.Function`` on both devices, its backward
plain torch products (the JAX package has no backward kernel either):
dh = dout, dp_i = dout W_i, dW_i = dout^T p_i, db = sum dout.
"""

from __future__ import annotations

import functools
import os
from typing import Sequence

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

MAX_PIECES = 2
# the bf16 body's launch arithmetic (csrc/shortcut_fused.cu make_plan)
_SMS = 132             # H100 SXM
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use
_ALIGN = 1024          # the 128-byte swizzle's atoms
_MAX_STAGES = 4
_BAR_BYTES = 8 * (2 * _MAX_STAGES + 2)
_ROWS = 128            # rows a tile


def use_fused_shortcut(x: torch.Tensor) -> bool:
    """Route the ResBlock shortcuts of a model on ``x``'s device through
    K6 (see the module docstring for the variables)."""
    if os.environ.get("INFODIFF_DISABLE_PALLAS") == "1":
        return False
    if os.environ.get("INFODIFF_FORCE_FUSED_SHORTCUT") == "1":
        return True
    return (os.environ.get("INFODIFF_ENABLE_FUSED_SHORTCUT") == "1"
            and x.is_cuda)


def fused_shortcut_supported(piece_channels: Sequence[int], n: int) -> bool:
    """K6's gate: 1 or 2 pieces, N and every piece's channels multiples of
    8 (the kernel moves 16-byte vectors). Every shortcut site of the
    reference's UNets passes."""
    cs = list(piece_channels)
    return (1 <= len(cs) <= MAX_PIECES and n % 8 == 0
            and all(c > 0 and c % 8 == 0 for c in cs))


@functools.lru_cache(maxsize=None)
def shortcut_launch_plan(M: int, c0: int, c1: int, N: int,
                         dtype: torch.dtype) -> dict:
    """What K6's bf16 body launches for ``M`` rows, pieces of ``c0`` and
    ``c1`` channels (``c1`` 0: one piece) and ``N`` outputs, in tiles of
    128 rows. W stays ``resident`` where a block can hold all of N (up to
    256) and W fits beside the ring, so each piece row is read once; else
    the tiles are a GEMM's, 128 rows x 128 columns, W streamed beside the
    pieces, both by TMA (``tma``) where no 64-channel K tile straddles the
    pieces. Keys: a block's columns ``nw`` (N padded to 64 / 128 / 256:
    the W rows it holds) and column tiles ``nsplit``, 64-channel K tiles
    ``kt``, the ring's ``stages`` of ``stage_bytes``, the A tile / W panel
    / W / h tile bytes and h's row stride ``h_ld``, ``smem`` bytes,
    ``tiles`` and ``blocks`` (persistent, at most one per SM) of
    ``threads``. Raises where no plan fits. Cached: the dict is shared, so
    callers read it only."""
    if dtype != torch.bfloat16:
        raise ValueError(f"K6's wgmma body takes bf16, got {dtype}")
    if not fused_shortcut_supported([c0] + ([c1] if c1 else []), N) or M < 1:
        raise ValueError(f"K6 takes no plan for M={M} pieces {c0}, {c1} "
                         f"-> {N}")
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    kt = cdiv(c0 + c1, 64)
    for resident in (True, False):
        if resident and N > 256:
            continue
        nw = 64 if N <= 64 else 128 if N <= 128 or not resident else 256
        nsplit = cdiv(N, nw)
        a_bytes, w_panel = _ROWS * 128, nw * 128
        w_bytes = kt * w_panel
        h_ld = N if nsplit == 1 else nw
        h_bytes = _ROWS * h_ld * 2
        fixed = _ALIGN + h_bytes + _BAR_BYTES
        stage = a_bytes + (0 if resident else w_panel)
        stages = next((s for s in range(_MAX_STAGES, 1, -1)
                       if fixed + (w_bytes if resident else 0) + s * stage
                       <= _SMEM_LIMIT), 0)
        if stages:
            break
    else:
        raise ValueError(f"K6: no plan fits the shared memory for pieces "
                         f"{c0}, {c1} -> {N}")
    tiles = cdiv(M, _ROWS) * nsplit
    return dict(nw=nw, nsplit=nsplit, kt=kt, resident=resident,
                tma=not resident and c0 % 64 == 0, stages=stages,
                stage_bytes=stage, a_bytes=a_bytes, w_panel=w_panel,
                w_bytes=w_bytes, h_ld=h_ld, h_bytes=h_bytes,
                smem=fixed + (w_bytes if resident else 0) + stages * stage,
                tiles=tiles, blocks=min(tiles, _SMS), threads=384)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def shortcut_fused_reference(h: torch.Tensor, pieces: Sequence[torch.Tensor],
                             weight: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6 (arguments as in the module docstring)."""
    f32 = torch.float32
    acc = h.to(f32) + bias.to(f32)
    o = 0
    for p in pieces:
        c = p.shape[-1]
        w = weight[:, o:o + c].to(h.dtype).to(f32)
        acc = acc + p.to(h.dtype).to(f32) @ w.T
        o += c
    return acc.to(h.dtype)


def shortcut_fused_cuda(h: torch.Tensor, pieces: Sequence[torch.Tensor],
                        weight: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """Launch K6 on CUDA tensors (arguments as in the module docstring;
    the pieces and the weight are cast to h's dtype, except an f32 weight
    the bf16 plan keeps resident, which the kernel rounds as it loads it),
    bf16 as :func:`shortcut_launch_plan` says. Raises on what the kernel
    does not take."""
    pieces = list(pieces)
    _lib.check_tensor(h, "h", dtypes=tuple(_lib.DTYPE_CODES))
    dev, dtype, N = h.device, h.dtype, h.shape[-1]
    cs = [int(p.shape[-1]) for p in pieces]
    if not fused_shortcut_supported(cs, N):
        raise ValueError(f"fused shortcut kernel does not take pieces {cs} "
                         f"-> {N}")
    # (casts and copies only where needed: the route is host-bound)
    rows = [p if p.dtype == dtype else p.to(dtype) for p in pieces]
    M = h.numel() // N
    for i, (p, c) in enumerate(zip(rows, cs)):
        if p.numel() // c != M:
            raise ValueError(f"piece {i}: {p.numel() // c} rows, h has {M}")
        _lib.check_tensor(p, f"piece {i}", dtypes=(dtype,), device=dev)
    c1 = cs[1] if len(rows) > 1 else 0
    plan = (shortcut_launch_plan(M, cs[0], c1, N, dtype)
            if dtype == torch.bfloat16 else dict(stages=0, smem=0, blocks=0))
    # an f32 weight that stays resident is rounded to bf16 in the kernel
    w_f32 = plan.get("resident", False) and weight.dtype == torch.float32
    w = weight if w_f32 or weight.dtype == dtype else weight.to(dtype)
    w = w.contiguous()
    _lib.check_tensor(w, "weight", shape=(N, sum(cs)),
                      dtypes=(torch.float32,) if w_f32 else (dtype,),
                      device=dev)
    b = bias if bias.dtype == torch.float32 else bias.to(torch.float32)
    b = b.contiguous()
    _lib.check_tensor(b, "bias", shape=(N,), device=dev)
    out = torch.empty_like(h)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_shortcut_fused(
            h.data_ptr(), rows[0].data_ptr(),
            rows[1].data_ptr() if len(rows) > 1 else None,
            cs[0], c1, w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
            _lib.DTYPE_CODES[dtype], int(w_f32), plan["stages"],
            plan["smem"], plan["blocks"], _lib.stream_handle(),
        )
    _lib.check_launch(err, "shortcut_fused")
    shortcut_fused_cuda.launches += 1
    return out


shortcut_fused_cuda.launches = 0


class _FusedShortcut(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, weight, bias, *pieces):
        run = shortcut_fused_cuda if h.is_cuda else shortcut_fused_reference
        out = run(h, pieces, weight, bias)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(weight, *pieces)
        return out

    @staticmethod
    def backward(ctx, dout):
        weight, *pieces = ctx.saved_tensors
        f32 = torch.float32
        d = _rows(dout).to(f32)
        dps, dws, o = [], [], 0
        for p in pieces:
            c = p.shape[-1]
            w = weight[:, o:o + c].to(dout.dtype).to(f32)
            dps.append((d @ w).reshape(p.shape).to(p.dtype))
            dws.append(d.T @ _rows(p).to(f32))
            o += c
        dw = torch.cat(dws, dim=1).to(weight.dtype)
        return dout, dw, d.sum(0).to(f32), *dps


def fused_shortcut_add(h: torch.Tensor, pieces: Sequence[torch.Tensor],
                       weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """``h + concat(pieces) @ weight.T + bias`` in one pass: K6 on a CUDA
    ``h``, the plain version on a CPU one (arguments as in the module
    docstring). Differentiable in every input."""
    return _FusedShortcut.apply(h.contiguous(), weight, bias,
                                *(p.contiguous() for p in pieces))
