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

import os
from typing import Sequence

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

MAX_PIECES = 2


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
    the pieces and the weight are cast to h's dtype). Raises on what the
    kernel does not take."""
    pieces = list(pieces)
    _lib.check_tensor(h, "h", dtypes=tuple(_lib.DTYPE_CODES))
    dev, dtype, N = h.device, h.dtype, h.shape[-1]
    cs = [int(p.shape[-1]) for p in pieces]
    if not fused_shortcut_supported(cs, N):
        raise ValueError(f"fused shortcut kernel does not take pieces {cs} "
                         f"-> {N}")
    rows = [_rows(p.to(dtype)) for p in pieces]
    for i, p in enumerate(rows):
        if p.shape[0] != h.numel() // N:
            raise ValueError(f"piece {i}: {p.shape[0]} rows, h has "
                             f"{h.numel() // N}")
        _lib.check_tensor(p, f"piece {i}", dtypes=(dtype,), device=dev)
    w = weight.to(dtype).contiguous()
    _lib.check_tensor(w, "weight", shape=(N, sum(cs)), dtypes=(dtype,),
                      device=dev)
    b = bias.to(torch.float32).contiguous()
    _lib.check_tensor(b, "bias", shape=(N,), device=dev)
    out = torch.empty_like(h)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_shortcut_fused(
            h.data_ptr(), rows[0].data_ptr(),
            rows[1].data_ptr() if len(rows) > 1 else None,
            cs[0], cs[1] if len(rows) > 1 else 0, w.data_ptr(), b.data_ptr(),
            out.data_ptr(), h.numel() // N, N, _lib.DTYPE_CODES[dtype],
            _lib.stream_handle(),
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
