"""K7, the fused [GN/FiLM affine -> SiLU -> int8 quantize -> 3x3 conv ->
dequant], and the int8 x int8 -> int32 conv: CUDA kernels and their plain
versions.

Replaces ``infodiffusion_tpu/ops/pallas/qconv.py`` (``qconv_fused``, bodies
``_kernel`` and ``_kernel_v2``) and the XLA int8 conv of
``infodiffusion_tpu/ops/quant.py`` (``int8_conv``). Both run on one
warpgroup core, ``csrc/int8_conv_wgmma.cuh``: an int8 implicit-GEMM conv on
the tensor cores whose window a producer fills, by copying int8 input (the
chainless conv, ``int8_conv_cuda``, the tier's default route) or by running
the chain on the raw pieces (K7: ``qconv_cuda``, ``csrc/qconv.cu``, and
``qconv_v2_cuda``, the pipelined body, ``csrc/qconv_v2.cu``). What bounds
them and what their design does about it: see the sources.

What K7 computes (NHWC):

    h   = silu(concat(pieces) * A + B)   # A, B: f32 [B, Ctot] rows that
                                         # collapse GN-apply and the FiLMs
    q_i = clip(round(h_i / s_i), +-127)  # per-piece static scales
    out = conv3x3(q, Kq) * sw + bias     # s32 sum, the act scales folded
                                         # into Kq's input-channel slices

The chain stays f32 up to the quantize (the default route casts the adagn
output to the module dtype first), so the two routes differ by design by
one-unit int8 flips; see ``qconv_fused``.

The port's gate (``fused_qconv_supported``) keeps the JAX package's shape
rules and drops the Mosaic ones (W <= 256, the VMEM tile planner); it adds
one of its own: each piece's channels a multiple of 8 (the chain reads
16-byte vectors of eight channels). The weight prep (``_fold_pack``) runs in
plain torch at every call, as the JAX package runs it in XLA at every
apply.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.ops.cuda import library as _lib
from infodiffusion_tpu_torch.ops.quant import (
    act_scale,
    int8_conv_reference,
    quantize_weight,
)

MAX_PIECES = 2
# output codes of csrc/qconv.cu
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def use_fused_qconv(x: torch.Tensor) -> bool:
    """Route the marked chains of a model on ``x``'s device through K7.
    Opt-in with ``INFODIFF_ENABLE_FUSED_QCONV=1`` on a CUDA tensor;
    ``INFODIFF_FORCE_FUSED_QCONV=1`` takes it on any device (the plain
    version on the CPU); ``INFODIFF_DISABLE_FUSED_QCONV=1`` and
    ``INFODIFF_DISABLE_PALLAS=1`` win over both."""
    if os.environ.get("INFODIFF_DISABLE_FUSED_QCONV") == "1":
        return False
    if os.environ.get("INFODIFF_DISABLE_PALLAS") == "1":
        return False
    if os.environ.get("INFODIFF_FORCE_FUSED_QCONV") == "1":
        return True
    return os.environ.get("INFODIFF_ENABLE_FUSED_QCONV") == "1" and x.is_cuda


def _use_v2() -> bool:
    """``INFODIFF_QCONV_V2=1`` selects K7's pipelined body."""
    return os.environ.get("INFODIFF_QCONV_V2") == "1"


def fused_qconv_supported(pieces_shapes, out_ch: int) -> bool:
    """Shape gate for K7: NHWC pieces (1 or 2) sharing B, H, W; Ctot and
    Cout multiples of 32; each piece's channels a multiple of 8; H, W >= 4.
    Covers every ResBlock conv site of the flagship and of the tiny test
    UNet."""
    if not pieces_shapes or len(pieces_shapes) > MAX_PIECES:
        return False
    lead = tuple(pieces_shapes[0][:-1])
    if len(lead) != 3:
        return False
    if any(tuple(s[:-1]) != lead for s in pieces_shapes):
        return False
    cs = [s[-1] for s in pieces_shapes]
    if sum(cs) % 32 or out_ch % 32 or any(c % 8 for c in cs):
        return False
    _, H, W = lead
    return H >= 4 and W >= 4


def _fold_pack(kernel: torch.Tensor, s_act: torch.Tensor, piece_channels):
    """Fold the per-piece act scales into the HWIO kernel's input-channel
    slices, quantize per output channel and pack as the JAX package does:
    ``(kmat, sw)`` with ``kmat[dw*Ctot + c, dh*Cout + o] = kq[dh, dw, c, o]``
    int8 [3 Ctot, 3 Cout] and sw f32 [Cout]."""
    kf = kernel.to(torch.float32)
    slices, o = [], 0
    for i, c in enumerate(piece_channels):
        slices.append(kf[:, :, o:o + c, :] * s_act[i])
        o += c
    keff = torch.cat(slices, dim=2)
    kq, sw = quantize_weight(keff, (0, 1, 2))
    ctot, cout = keff.shape[2], keff.shape[3]
    return kq.permute(1, 2, 0, 3).reshape(3 * ctot, 3 * cout), sw


def chain_q(pieces: Sequence[torch.Tensor], A: torch.Tensor,
            B: torch.Tensor, s_act: torch.Tensor) -> torch.Tensor:
    """K7's prologue in plain torch: the int8 values
    ``clip(round(silu(concat(pieces) * A + B) / s_piece), +-127)`` (NHWC,
    f32 chain)."""
    qs, o = [], 0
    for i, p in enumerate(pieces):
        c = p.shape[-1]
        h = (p.to(torch.float32) * A[:, None, None, o:o + c]
             + B[:, None, None, o:o + c])
        h = h * torch.sigmoid(h)
        qs.append(torch.clamp(torch.round(h / s_act[i]), -127.0, 127.0))
        o += c
    return torch.cat(qs, dim=-1).to(torch.int8)


def qconv_reference(pieces: Sequence[torch.Tensor], A: torch.Tensor,
                    B: torch.Tensor, absmax: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain K7: f32 chain, folded scales, exact s32 conv over the concat,
    one dequant. pieces NHWC; A, B [B, Ctot]; absmax [n]; kernel HWIO f32;
    bias [Cout]."""
    pieces = list(pieces)
    cs = [int(p.shape[-1]) for p in pieces]
    s_act = act_scale(absmax.reshape(len(pieces)))
    kf = kernel.to(torch.float32)
    slices, o = [], 0
    for i, c in enumerate(cs):
        slices.append(kf[:, :, o:o + c, :] * s_act[i])
        o += c
    kq, sw = quantize_weight(torch.cat(slices, dim=2), (0, 1, 2))
    y = int8_conv_reference(chain_q(pieces, A, B, s_act), kq, 1)
    out = y.to(torch.float32) * sw + bias.to(torch.float32)
    return out.to(out_dtype)


def int8_conv_epilogue(y: torch.Tensor, scale: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       partial: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None):
    """The kernel's epilogue in plain torch, on an int32 conv ``y``: ``y``
    itself when nothing is given, else ``f32(y)``, plus the bf16
    ``partial`` when given, times ``scale`` plus ``bias`` when given, cast
    to ``out_dtype`` (f32 by default)."""
    if scale is None and partial is None and out_dtype is None:
        return y
    v = y.to(torch.float32)
    if partial is not None:
        v = partial.to(torch.float32) + v
    if scale is not None:
        v = v * scale + bias
    return v.to(out_dtype or torch.float32)


# the int8 conv's launch arithmetic (csrc/int8_conv_wgmma.cuh make_plan)
_BM = 128              # output pixels a tile
_SMS = 132             # H100 SXM
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use
_MAX_STAGES = 36       # weight stages the kernel's barriers allow
_BAR_BYTES = 640
_ALIGN = 128
_ROW_PAD = 16          # bytes of padding per window row


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def int8_conv_cin(c: int) -> int:
    """The input channels the int8 conv kernel runs at: ``c`` zero-padded
    to 32, 64 or a multiple of 128 (one weight stage covers up to 128)."""
    for k in (32, 64):
        if c <= k:
            return k
    return _cdiv(c, 128) * 128


@functools.lru_cache(maxsize=None)
def int8_conv_launch_plan(B: int, H: int, W: int, cin: int, cout: int,
                          stride: int) -> dict:
    """What the int8 conv kernel launches for x [B, H, W, cin] (cin as
    :func:`int8_conv_cin` pads it) and ``cout`` output channels at
    ``stride``: the tile (``ipt`` whole images, or ``th`` output rows of
    ``tw`` columns of one image; at most 128 pixels), the N tile ``n``
    (Cout padded to 64 / 128 / 256) and its ``nsplit``, the weight stage's
    input channels ``kp``, the window's ``win_rows`` x ``win_cols``
    positions an image and ``win_bytes`` (two buffers), the ``w_stage``
    bytes, ``n_stages`` stages a tile (9 taps x cin / kp), the ring's
    ``stages`` (all of them where the weights stay ``resident``), ``smem``
    bytes, ``tiles`` and ``blocks`` (persistent, at most one per SM) of
    ``threads``. Raises where no plan fits the shared memory. Cached: the
    dict is shared, so callers read it only."""
    if stride not in (1, 2) or min(B, H, W, cout) < 1 or \
            cin != int8_conv_cin(cin):
        raise ValueError(f"int8 conv takes no plan for B={B} {H}x{W} "
                         f"Cin={cin} Cout={cout} stride {stride}")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    rs = cin + _ROW_PAD
    kp = min(cin, 128)
    n = 64 if cout <= 64 else 128 if cout <= 128 else 256
    nsplit = _cdiv(cout, n)
    if Ho * Wo <= _BM:
        th, tw, ipt = Ho, Wo, min(B, _BM // (Ho * Wo))
    else:
        tw = min(Wo, _BM)
        th, ipt = _BM // tw, 1
    w_stage, n_stages = n * kp, 9 * (cin // kp)
    while True:
        win_rows, win_cols = (th - 1) * stride + 3, (tw - 1) * stride + 3
        win_bytes = _cdiv(ipt * win_rows * win_cols * rs, 128) * 128
        fixed = _ALIGN + 2 * win_bytes + _BAR_BYTES
        resident = (nsplit == 1 and n_stages <= _MAX_STAGES
                    and fixed + n_stages * w_stage <= _SMEM_LIMIT)
        stages = n_stages if resident else next(
            (s for s in (4, 3, 2) if fixed + s * w_stage <= _SMEM_LIMIT), 0)
        if stages:
            break
        if ipt > 1:
            ipt = _cdiv(ipt, 2)
        elif th > 1:
            th = _cdiv(th, 2)
        elif tw > 8:
            tw = _cdiv(tw, 2)
        else:
            raise ValueError(f"int8 conv: no tile fits the shared memory at "
                             f"{H}x{W} Cin={cin} Cout={cout}")
    groups, row_tiles, col_tiles = _cdiv(B, ipt), _cdiv(Ho, th), _cdiv(Wo, tw)
    tiles = nsplit * groups * row_tiles * col_tiles
    return dict(kp=kp, n=n, nsplit=nsplit, ipt=ipt, th=th, tw=tw,
                win_rows=win_rows, win_cols=win_cols, win_bytes=win_bytes,
                w_stage=w_stage, n_stages=n_stages, stages=stages,
                resident=resident, smem=fixed + stages * w_stage,
                groups=groups, row_tiles=row_tiles, col_tiles=col_tiles,
                tiles=tiles, blocks=min(tiles, _SMS), threads=384)


def int8_conv_weights(kq_hwio: torch.Tensor, cin: int, plan: dict):
    """HWIO int8 [3, 3, C, Cout] -> the kernel's weight stages: input
    channels zero-padded to ``cin``, output channels to ``nsplit * n``,
    laid out [nsplit][9 taps (dh*3 + dw)][cin / kp panels][n / 8][kp / 16]
    [8][16] (the no-swizzle K-major core matrices wgmma reads, one stage
    a (tap, panel))."""
    c, cout = kq_hwio.shape[2], kq_hwio.shape[3]
    n, kp, nsplit = plan["n"], plan["kp"], plan["nsplit"]
    w = kq_hwio
    if cin != c or nsplit * n != cout:
        w = F.pad(w, (0, nsplit * n - cout, 0, cin - c))
    w = w.reshape(9, cin // kp, kp // 16, 16, nsplit, n // 8, 8)
    return w.permute(4, 0, 1, 5, 2, 6, 3).contiguous()


def int8_conv_cuda(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1, *,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   partial: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the chainless int8 conv (padding 1) on NHWC int8 ``xq`` and
    HWIO int8 ``kq``, with the epilogue of :func:`int8_conv_epilogue`, as
    :func:`int8_conv_launch_plan` says. Input channels are zero-padded to
    :func:`int8_conv_cin` (exact). Raises on what the kernel does not
    take."""
    _lib.check_tensor(xq, "xq", dtypes=(torch.int8,))
    dev = xq.device
    if xq.ndim != 4 or kq.shape[:3] != (3, 3, xq.shape[3]):
        raise ValueError(f"int8 conv takes NHWC x and HWIO 3x3 k, got "
                         f"{tuple(xq.shape)} and {tuple(kq.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"int8 conv takes stride 1 or 2, got {stride}")
    B, H, W, C = xq.shape
    cout = kq.shape[3]
    cin = int8_conv_cin(C)
    plan = int8_conv_launch_plan(B, H, W, cin, cout, stride)
    if cin != C:
        xq = F.pad(xq, (0, cin - C))
    w = int8_conv_weights(kq, cin, plan)
    _lib.check_tensor(w, "kq", dtypes=(torch.int8,), device=dev)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if scale is None and partial is None and out_dtype is None:
        out_dtype = torch.int32
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"int8 conv writes f32, bf16 or int32, got "
                         f"{out_dtype}")
    f32 = (torch.float32,)
    if scale is not None:
        _lib.check_tensor(scale, "scale", shape=(cout,), dtypes=f32,
                          device=dev)
        _lib.check_tensor(bias, "bias", shape=(cout,), dtypes=f32, device=dev)
    if partial is not None:
        _lib.check_tensor(partial, "partial", shape=(B, Ho, Wo, cout),
                          dtypes=(torch.bfloat16,), device=dev)
    out = torch.empty((B, Ho, Wo, cout), dtype=out_dtype, device=dev)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_int8_conv(
            xq.data_ptr(), w.data_ptr(),
            scale.data_ptr() if scale is not None else None,
            bias.data_ptr() if scale is not None else None,
            partial.data_ptr() if partial is not None else None,
            out.data_ptr(), _OUT_CODES[out_dtype], B, H, W, cin, cout,
            stride, plan["ipt"], plan["th"], plan["tw"], plan["stages"],
            plan["smem"], plan["blocks"], _lib.stream_handle(),
        )
    _lib.check_launch(err, "int8_conv")
    int8_conv_cuda.launches += 1
    return out


int8_conv_cuda.launches = 0


_QBAR_BYTES = 1792      # K7's mbarriers (csrc/qconv_wgmma.cuh)
_QMAX_STAGES = 72       # K7's weight stages the barriers allow
_MAX_RAW = 64           # K7 v2's raw-row ring slots the barriers allow
_QRING = 8              # K7's streamed weight stages at most
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


def _round128(b: int) -> int:
    return _cdiv(b, 128) * 128


def qconv_cin(ctot: int) -> int:
    """The input channels K7 runs at: ``ctot`` zero-padded to a multiple
    of 64, the least weight stage's panel."""
    return _cdiv(ctot, 64) * 64


@functools.lru_cache(maxsize=None)
def qconv_launch_plan(B: int, H: int, W: int, ctot: int, cout: int,
                      dtype: torch.dtype, pipelined: bool) -> dict:
    """What K7 launches for pieces of ``ctot`` channels [B, H, W] in
    ``dtype`` to ``cout`` channels, body v1 or (``pipelined``) v2
    (``csrc/qconv_wgmma.cuh`` make_qconv_plan, whose entry refuses any
    other plan). The int8 conv's tile (``ipt`` whole images where H x W <=
    128, else ``th`` rows of ``tw`` columns); Cout in one N tile of ``n``
    = 64 or 128 up to 128, beyond that ``npass`` tiles of 128 run one
    after another from the tile's window (``nsplit``, the weight layout's,
    is the same); weight stages of ``kp`` channels (a 64-wide tile's all of
    ``cin`` = :func:`qconv_cin` up to 192, else 128 where they divide it,
    else 64), ``n_stages`` a pass; the window
    ring's ``ring`` row slots of ``win_cols`` positions (two windows, or one
    window and a tile's new rows); v2's ``raw_rows`` staged raw rows of
    ``raw_row_bytes`` (two fills' or one fill's); the weights ``resident``
    or in a ring of 8 .. 2 ``stages``; ``smem`` bytes. The walks: each (image
    group, column strip) cuts its ``row_tiles`` into ``segs`` segments of
    ``rps`` tiles, ``walks`` in all on ``blocks`` persistent blocks of
    ``threads``, a walk quantizing each of its rows once for all of Cout
    (``carry`` = 2 rows a tile passes on). Raises where nothing fits.
    Cached: the dict is shared, so callers read it only."""
    if min(B, H, W, cout) < 1 or ctot < 8 or ctot % 8 or dtype not in _ELEM:
        raise ValueError(f"K7 takes no plan for B={B} {H}x{W} Ctot={ctot} "
                         f"Cout={cout} {dtype}")
    elem = _ELEM[dtype]
    cin = qconv_cin(ctot)
    rs = cin + _ROW_PAD
    n = 64 if cout <= 64 else 128
    kp = cin if n == 64 and cin <= 192 else 128 if cin % 128 == 0 else 64
    npass = _cdiv(cout, n)
    if H * W <= _BM:
        th, tw, ipt = H, W, min(B, _BM // (H * W))
    else:
        tw = min(W, _BM)
        th, ipt = _BM // tw, 1
    w_stage, n_stages = n * kp, 9 * (cin // kp)
    while True:
        win_rows, win_cols = th + 2, tw + 2
        row_tiles, col_tiles = _cdiv(H, th), _cdiv(W, tw)
        row_bytes = win_cols * rs
        wr = ipt * win_rows
        rows = row_tiles > 1
        raw_row_bytes = (_round128(min(win_cols, W) * ctot * elem)
                         if pipelined else 0)
        ab = _round128(8 * ctot * ipt)
        rings = [2 * wr] + ([wr + th] if rows else [])
        raws = ([max(2 * th, th + 2), th + 2] if rows
                else [2 * ipt * H, ipt * H]) if pipelined else [0, 0]
        found = None
        for ring in rings:
            for raw_rows in raws:
                if raw_rows > _MAX_RAW:
                    continue
                fixed = (_ALIGN + _round128(ring * row_bytes)
                         + raw_rows * raw_row_bytes + ab + _QBAR_BYTES)
                every = npass * n_stages
                resident = (every <= _QMAX_STAGES
                            and fixed + every * w_stage <= _SMEM_LIMIT)
                stages = every if resident else next(
                    (s for s in range(_QRING, 1, -1)
                     if fixed + s * w_stage <= _SMEM_LIMIT), 0)
                if stages:
                    found = (ring, raw_rows, resident, stages,
                             fixed + stages * w_stage)
                    break
            if found:
                break
        if found:
            break
        if ipt > 1:
            ipt = _cdiv(ipt, 2)
        elif th > 1:
            th = _cdiv(th, 2)
        elif tw > 8:
            tw = _cdiv(tw, 2)
        else:
            raise ValueError(f"K7: no tile fits the shared memory at "
                             f"{H}x{W} Ctot={ctot} Cout={cout} {dtype}")
    ring, raw_rows, resident, stages, smem = found
    groups = _cdiv(B, ipt)
    strips = groups * col_tiles
    segs = min(row_tiles, max(1, _SMS // strips))
    rps = _cdiv(row_tiles, segs)
    segs = _cdiv(row_tiles, rps)
    walks = strips * segs
    return dict(cin=cin, kp=kp, n=n, npass=npass, nsplit=npass, ipt=ipt,
                th=th, tw=tw,
                win_rows=win_rows, win_cols=win_cols, row_bytes=row_bytes,
                ring=ring, raw_rows=raw_rows, raw_row_bytes=raw_row_bytes,
                ab_bytes=ab, w_stage=w_stage, n_stages=n_stages,
                stages=stages, resident=resident, smem=smem, groups=groups,
                row_tiles=row_tiles, col_tiles=col_tiles, segs=segs, rps=rps,
                walks=walks, tiles=strips * row_tiles,
                blocks=min(walks, _SMS), threads=512, carry=2 if rows else 0)


def _launch_qconv(pieces, A, B, s_act, kmat, sw, bias, out_dtype,
                  pipelined: bool) -> torch.Tensor:
    pieces = list(pieces)
    if not 1 <= len(pieces) <= MAX_PIECES:
        raise ValueError(f"K7 takes 1 or 2 pieces, got {len(pieces)}")
    dtype = pieces[0].dtype
    for i, p in enumerate(pieces):
        _lib.check_tensor(p, f"piece {i}", dtypes=(dtype,),
                          device=pieces[0].device)
    if dtype not in _lib.DTYPE_CODES or out_dtype not in _lib.DTYPE_CODES:
        raise ValueError(f"K7 takes f32/bf16 pieces and output, got {dtype} "
                         f"and {out_dtype}")
    dev = pieces[0].device
    if not fused_qconv_supported([tuple(p.shape) for p in pieces],
                                 int(sw.shape[0])):
        raise ValueError(f"K7 does not take pieces "
                         f"{[tuple(p.shape) for p in pieces]} -> {sw.shape[0]}")
    Bt, H, W, _ = pieces[0].shape
    cs = [int(p.shape[3]) for p in pieces]
    ctot, cout = sum(cs), int(sw.shape[0])
    plan = qconv_launch_plan(Bt, H, W, ctot, cout, dtype, pipelined)
    _lib.check_tensor(kmat, "kmat", shape=(3 * ctot, 3 * cout),
                      dtypes=(torch.int8,), device=dev)
    # kmat[dw*Ctot + c, dh*Cout + o] = kq[dh, dw, c, o]: the int8 conv's
    # weight stages from the HWIO view
    w = int8_conv_weights(kmat.view(3, ctot, 3, cout).permute(2, 0, 1, 3),
                          plan["cin"], plan)
    f32 = (torch.float32,)
    for name, t in (("A", A), ("B", B)):
        _lib.check_tensor(t, name, shape=(Bt, ctot), dtypes=f32, device=dev)
    _lib.check_tensor(s_act, "s_act", shape=(len(pieces),), dtypes=f32,
                      device=dev)
    _lib.check_tensor(sw, "sw", dtypes=f32, device=dev)
    _lib.check_tensor(bias, "bias", shape=(cout,), dtypes=f32, device=dev)
    out = torch.empty((Bt, H, W, cout), dtype=out_dtype, device=dev)
    lib = _lib.library().lib
    entry = lib.infodiff_qconv_v2 if pipelined else lib.infodiff_qconv
    with torch.cuda.device(dev):
        err = entry(
            pieces[0].data_ptr(),
            pieces[1].data_ptr() if len(pieces) > 1 else None,
            cs[0], cs[1] if len(pieces) > 1 else 0, _lib.DTYPE_CODES[dtype],
            A.data_ptr(), B.data_ptr(), s_act.data_ptr(), w.data_ptr(),
            sw.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _lib.DTYPE_CODES[out_dtype], Bt, H, W, cout, plan["ipt"],
            plan["th"], plan["tw"], plan["ring"], plan["raw_rows"],
            plan["stages"], plan["smem"], plan["blocks"],
            _lib.stream_handle(),
        )
    _lib.check_launch(err, "qconv_v2" if pipelined else "qconv")
    return out


def qconv_chain_check(mode: int, s: float, x: Optional[torch.Tensor] = None,
                      ab: Optional[torch.Tensor] = None) -> int:
    """K7's chain against its exact form on the card
    (``csrc/qconv.cu`` ``infodiff_qconv_chain_check``): the mismatching
    values of mode 0, the branch-free 1 / d against ``__fdiv_rn`` for every
    float d in [1, 2^60); mode 1, the branch-free a / s for every float
    |a| in [2^-60, 2^60) of both signs; mode 2, the chain of eight channels
    (fast divides, exact fallback) against ``quant_chain`` on the f32 CUDA
    values ``x`` (a multiple of 8), with A and B the 16 floats ``ab``."""
    dev = x.device if x is not None else torch.device("cuda")
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    if mode == 2:
        _lib.check_tensor(x, "x", dtypes=(torch.float32,))
        _lib.check_tensor(ab, "ab", shape=(16,), dtypes=(torch.float32,),
                          device=dev)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_qconv_chain_check(
            mode, float(s), x.data_ptr() if x is not None else None,
            ab.data_ptr() if ab is not None else None,
            x.numel() if x is not None else 0, bad.data_ptr(),
            _lib.stream_handle())
    _lib.check_launch(err, "qconv_chain_check")
    return int(bad.item())


def qconv_cuda(pieces, A, B, s_act, kmat, sw, bias,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K7 (``_kernel``): CUDA pieces NHWC, A/B f32 [B, Ctot], the
    act scales s_act [n], the packed ``(kmat, sw)`` of :func:`_fold_pack`,
    f32 bias. Raises on what the kernel does not take."""
    out = _launch_qconv(pieces, A, B, s_act, kmat, sw, bias, out_dtype,
                        pipelined=False)
    qconv_cuda.launches += 1
    return out


qconv_cuda.launches = 0


def qconv_v2_cuda(pieces, A, B, s_act, kmat, sw, bias,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch K7's pipelined body (``_kernel_v2``); arguments and result
    as :func:`qconv_cuda`, bitwise."""
    out = _launch_qconv(pieces, A, B, s_act, kmat, sw, bias, out_dtype,
                        pipelined=True)
    qconv_v2_cuda.launches += 1
    return out


qconv_v2_cuda.launches = 0


def qconv_fused(pieces: Sequence[torch.Tensor], A: torch.Tensor,
                B: torch.Tensor, absmax: torch.Tensor, kernel: torch.Tensor,
                bias: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv3x3(q8(silu(concat(pieces)*A + B)), q8(kernel)) * sw + bias``
    in ``out_dtype``: K7 on CUDA pieces (the pipelined body under
    ``INFODIFF_QCONV_V2=1``), :func:`qconv_reference` on CPU ones.
    pieces NHWC [B, H, W, C_i]; A, B f32 [B, Ctot]; absmax [n]; kernel HWIO
    f32 (folded, quantized and packed here); bias [Cout]."""
    pieces = list(pieces)
    if not pieces[0].is_cuda:
        return qconv_reference(pieces, A, B, absmax, kernel, bias, out_dtype)
    cs = [int(p.shape[-1]) for p in pieces]
    s_act = act_scale(absmax.reshape(len(pieces))).contiguous()
    kmat, sw = _fold_pack(kernel, s_act, cs)
    run = qconv_v2_cuda if _use_v2() else qconv_cuda
    return run([p.contiguous() for p in pieces],
               A.to(torch.float32).contiguous(),
               B.to(torch.float32).contiguous(), s_act, kmat,
               sw.contiguous(), bias.to(torch.float32).contiguous(),
               out_dtype)
