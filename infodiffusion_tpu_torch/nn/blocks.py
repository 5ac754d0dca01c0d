"""ResBlocks, resampling (2-D, and the 1-D latent blocks) and the latent
MLP block (JAX counterpart: ``infodiffusion_tpu/nn/blocks.py``).

Image blocks take and return NCHW tensors in ``channels_last`` memory
format, so cuDNN's convs run NHWC-native and the NHWC view the norm and
attention kernels read is free. The AdaGN chain (GroupNorm, then one or
two FiLMs) is ``ops.norm.adagn``, kernel K1 on the card.

The three ResBlocks: ``ResBlock`` (time FiLM; the vanilla UNet),
``AuxResBlock`` (time and aux FiLMs; the InfoDiff backbone) and
``EncoderResBlock`` (unconditioned; the Encoder and Decoder). Dropout
follows Flax ``nn.Dropout`` and is off unless a block is called with
``deterministic=False`` and an explicit ``torch.Generator``. An up block
takes its input as the pieces ``(h, skip)`` of the skip concat and
concatenates them itself (a plain ``torch.cat``): the model-dtype path
runs on the concat, the int8 tier's first conv quantizes each piece with
its own scale, and the fused shortcut (K6, ``ops/cuda/shortcut_fused.py``,
opt-in with ``INFODIFF_ENABLE_FUSED_SHORTCUT=1``) reads the pieces.

The int8 turbo tier (``ops/quant.py``): a quantized conv with quant state
runs W8A8 (``int8_conv``); during calibration it observes its input. A
norm marked ``fused_qconv`` by calibration hands its conv an
``_AffineChain`` when the fused kernel is on (``use_fused_qconv``) and the
call is deterministic: the conv then runs K7 (``ops/cuda/qconv.py``) on
the unnormalized pieces.

``INFODIFF_REMAT=1`` (read at call time, as the JAX UNet reads it) runs
each ResBlock of a UNet skeleton under ``torch.utils.checkpoint``
(:func:`remat_block`): the backward recomputes the block's activations
instead of keeping them, and the recompute draws the same dropout masks.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from infodiffusion_tpu_torch.nn.attention import AttnBlock
from infodiffusion_tpu_torch.nn.initializers import (
    kaiming_normal_relu_,
    lecun_normal_,
)
from infodiffusion_tpu_torch.nn.layers import Dense, xavier_
from infodiffusion_tpu_torch.ops import quant as q8
from infodiffusion_tpu_torch.ops.cuda.qconv import (
    fused_qconv_supported,
    qconv_fused,
    use_fused_qconv,
)
from infodiffusion_tpu_torch.ops.cuda.shortcut_fused import (
    fused_shortcut_add,
    fused_shortcut_supported,
    use_fused_shortcut,
)
from infodiffusion_tpu_torch.ops.norm import adagn, group_norm_affine
from infodiffusion_tpu_torch.parallel.batch import draw_rows

_GROUPS = 32
DROPOUT = 0.1  # the rate of every ResBlock's dropout


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: keep with p = 1 - rate, kept values scaled by
    1/p, the mask drawn from ``generator`` (never the global RNG)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs an explicit "
                         "torch.Generator")
    # the uniforms fill x's memory order (channels_last kept); under data
    # parallelism they are drawn for the global batch and sliced
    # (parallel/batch.py)
    return apply_dropout(x, rate, draw_rows(
        lambda n: _uniforms_like(x, n, generator), x.shape[0]))


def _uniforms_like(x: torch.Tensor, n: int,
                   generator: torch.Generator) -> torch.Tensor:
    """f32 uniforms shaped like ``x`` with ``n`` rows, in x's memory
    format."""
    if n == x.shape[0]:
        u = torch.empty_like(x, dtype=torch.float32)
    else:
        fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        u = torch.empty((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                        device=x.device, memory_format=fmt)
    return u.uniform_(generator=generator)


def apply_dropout(x: torch.Tensor, rate: float,
                  u: torch.Tensor) -> torch.Tensor:
    """Keep where ``u < 1 - rate``, kept values scaled by 1/(1 - rate)."""
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def remat_enabled() -> bool:
    """``INFODIFF_REMAT=1``: the UNet skeletons recompute each ResBlock in
    the backward (:func:`remat_block`)."""
    return os.environ.get("INFODIFF_REMAT") == "1"


def remat_block(block: nn.Module, *args,
                generator: Optional[torch.Generator] = None):
    """``block(*args, generator)`` under non-reentrant
    ``torch.utils.checkpoint``, JAX's ``nn.remat`` of the block: only its
    inputs are kept, and the backward runs its forward again.

    ``checkpoint`` restores the global generators for the recompute, not
    dropout's explicit ``generator``, which the rest of the forward has
    moved on: the recompute would draw other masks and the gradient would
    be silently wrong. So the generator's state before the block is kept,
    the recompute draws from it, and the generator goes back afterwards
    to where the backward found it (also when the recompute stops early,
    as ``checkpoint`` does once it has what the backward needs)."""
    if generator is None:
        return checkpoint(block, *args, None, use_reentrant=False)
    before = generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if calls[0] == 1:  # the forward itself
            return block(*a, generator)
        now = generator.get_state()
        generator.set_state(before)
        try:
            return block(*a, generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """The contiguous NHWC view of an NCHW tensor (free when the tensor is
    ``channels_last``)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class _AffineChain(NamedTuple):
    """A norm's output handed to its conv unmaterialized: the conv input is
    ``silu(concat(pieces) * A + B)`` with NHWC ``pieces`` and f32 rows A, B
    [batch, C_total] (``ops.norm.group_norm_affine``). A conv given one
    runs K7 or materializes it (:func:`_materialize_chain`)."""

    pieces: Tuple[torch.Tensor, ...]
    A: torch.Tensor
    B: torch.Tensor


def _materialize_chain(chain: _AffineChain, dtype) -> torch.Tensor:
    """The chain as the default route computes it (affine in f32, cast to
    ``dtype``, SiLU), concatenated: NCHW."""
    out, o = [], 0
    for p in chain.pieces:
        c = p.shape[-1]
        h = (p.to(torch.float32) * chain.A[:, None, None, o:o + c]
             + chain.B[:, None, None, o:o + c])
        out.append(F.silu(h.to(dtype)))
        o += c
    return _nchw(torch.cat(out, dim=-1))


class Conv3(nn.Module):
    """torch ``Conv2d(k=3, stride, padding=1)``: symmetric padding, not
    'SAME' (asymmetric at stride 2), computed in ``dtype`` with f32
    parameters. ``repeat=2`` puts a nearest-x2 upsample before the conv
    (``UpSample``).

    int8 tier: with ``quantize`` the conv observes its input during
    calibration and, given quant state, runs W8A8: weights quantized per
    output channel at every call, the input at its calibrated scale (before
    the repeat: |x| is repeat-invariant), ``int8_conv``, then
    ``f32(y) * (sx * sw) + bias`` in ``dtype``. ``quantize=False`` pins a
    conv (the image head and tail) to ``dtype``. Under tensor parallelism
    ``tp`` (``parallel/tp.py``) computes the model-dtype conv on this
    rank's output channels."""

    tp = None

    def __init__(self, in_ch: int, out_ch: int,
                 dtype: torch.dtype = torch.float32, stride: int = 1,
                 repeat: int = 1, gain: float = 1.0, quantize: bool = True):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.repeat = repeat
        self.quantize = quantize
        self.weight = nn.Parameter(
            xavier_(torch.empty(out_ch, in_ch, 3, 3), gain)
        )
        self.bias = nn.Parameter(torch.zeros(out_ch))
        if quantize:
            self.register_buffer("act_absmax", None, persistent=False)

    def _hwio(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0)

    def _turbo(self) -> bool:
        return (self.quantize and self.act_absmax is not None
                and not q8.calib_mode())

    def _fused(self, chain: _AffineChain) -> torch.Tensor:
        return _nchw(qconv_fused(list(chain.pieces), chain.A, chain.B,
                                 self.act_absmax.reshape(-1), self._hwio(),
                                 self.bias, self.dtype))

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, _AffineChain):
            if self._turbo() and self.stride == 1 and self.repeat == 1:
                return self._fused(x)
            x = _materialize_chain(x, self.dtype)
        if self.quantize and q8.calib_mode():
            q8.observe_absmax(self, x)
        elif self._turbo():
            return self._int8(x)
        return self._conv(x)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        """The model-dtype conv."""
        if self.tp is not None:
            return self.tp.conv(self, x)
        x = x.to(self.dtype)
        if self.repeat > 1:
            x = F.interpolate(x, scale_factor=self.repeat, mode="nearest")
        return F.conv2d(
            x, self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.stride, padding=1,
        )

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        kq, sw = q8.quantize_weight(self.weight, (1, 2, 3))
        xq, sx = q8.quantize_act(_nhwc(x), self.act_absmax)
        if self.repeat > 1:
            xq = xq.repeat_interleave(self.repeat, dim=1).repeat_interleave(
                self.repeat, dim=2)
        y = q8.int8_conv(xq, kq.permute(2, 3, 1, 0), self.stride,
                         scale=sx * sw, bias=self.bias.to(torch.float32),
                         out_dtype=self.dtype)
        return _nchw(y)


class PieceConv3(Conv3):
    """The first conv of an up block, over the skip concat: the same
    parameters as :class:`Conv3`, and ``forward(x, splits)`` takes the
    concatenated NCHW input with the pieces' channel counts (or an
    ``_AffineChain``). In the model dtype it is one conv over the concat.
    In the int8 tier each piece quantizes at its own calibrated scale
    (``act_absmax`` of shape (n_pieces,)), the scales folded into the
    kernel's input-channel slices (``quantize_pieces_folded``); the piece
    convs' partial sum is rounded to bf16 between pieces, then dequantized
    once: ``acc * sw + bias``."""

    def forward(self, x, splits: Optional[Sequence[int]] = None):
        if isinstance(x, _AffineChain):
            if self._turbo():
                return self._fused(x)
            splits = [p.shape[-1] for p in x.pieces]
            x = _materialize_chain(x, self.dtype)
        if splits is None or not (q8.calib_mode() or self._turbo()):
            return super().forward(x)
        pieces = [_nhwc(p) for p in x.split(list(splits), dim=1)]
        if q8.calib_mode():
            q8.observe_absmax(self, pieces)
            return self._conv(x)
        xqs, kq, sw = q8.quantize_pieces_folded(pieces, self.act_absmax,
                                                self._hwio())
        acc, o = None, 0
        for i, xq in enumerate(xqs):
            c = xq.shape[-1]
            k = kq[:, :, o:o + c, :]
            if i < len(xqs) - 1:
                acc = q8.int8_conv(xq, k, 1, partial=acc,
                                   out_dtype=torch.bfloat16)
            else:
                y = q8.int8_conv(xq, k, 1, partial=acc, scale=sw,
                                 bias=self.bias.to(torch.float32),
                                 out_dtype=self.dtype)
            o += c
        return _nchw(y)


class ShortcutDense(Dense):
    """The ResBlock 1x1 shortcut as a Dense over the channel axis;
    ``forward(x, residual, pieces)`` returns ``residual + dense(x)``
    (NCHW), ``x`` being the block input and ``pieces`` its skip-concat
    pieces (None for one piece). It stays in the model dtype in the int8
    tier. On the K6 route (``use_fused_shortcut``) it is one fused pass
    over the pieces, rounded once."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                pieces=None) -> torch.Tensor:
        plist = list(pieces) if pieces is not None else [x]
        if (self.tp is None and use_fused_shortcut(residual)
                and fused_shortcut_supported(
                [p.shape[1] for p in plist], residual.shape[1])):
            return _nchw(fused_shortcut_add(
                _nhwc(residual), [_nhwc(p) for p in plist], self.weight,
                self.bias))
        return residual + _nchw(super().forward(_nhwc(x)))


class _GNParams(nn.Module):
    """GroupNorm scale/bias (as ``weight``/``bias``) with the math in
    ``ops.norm.adagn``, so the FiLM-fused form uses the same parameters.
    ``x`` is one NCHW tensor.

    ``pieces``, when given, are the NCHW skip-concat pieces of ``x``, which
    a chain keeps apart. ``fused_out_ch`` marks a norm that feeds a
    quantized ResBlock conv of that many output channels. During int8 calibration it records the
    ``fused_qconv`` marker where ``fused_qconv_supported`` passes; when the
    marker is set, the call deterministic and ``use_fused_qconv`` on, it
    returns an :class:`_AffineChain` instead of normalized activations."""

    def __init__(self, channels: int, fused_out_ch: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.fused_out_ch = fused_out_ch
        if fused_out_ch is not None:
            self.register_buffer("fused_qconv", None, persistent=False)

    def forward(self, x, films=(), deterministic: bool = True, pieces=None):
        plist = list(pieces) if pieces is not None else [x]
        if self.fused_out_ch is not None:
            shapes = [(p.shape[0], p.shape[2], p.shape[3], p.shape[1])
                      for p in plist]
            if q8.calib_mode() == "int8":
                if fused_qconv_supported(shapes, self.fused_out_ch):
                    self.fused_qconv = torch.ones((), device=plist[0].device)
            elif (self.fused_qconv is not None and deterministic
                  and use_fused_qconv(plist[0])
                  and fused_qconv_supported(shapes, self.fused_out_ch)):
                nhwc = tuple(_nhwc(p) for p in plist)
                A, B = group_norm_affine(nhwc, _GROUPS, self.weight,
                                         self.bias, films)
                return _AffineChain(nhwc, A, B)
        return _nchw(adagn(_nhwc(x), _GROUPS, self.weight, self.bias, films))


def _as_pieces(x):
    """(pieces or None, the concatenated input)."""
    if isinstance(x, (tuple, list)):
        return list(x), torch.cat(list(x), dim=1)
    return None, x


class _ResBlockBase(nn.Module):
    """What the three ResBlocks share: norm1-SiLU-conv1 over the input or
    the skip-concat pieces, the SiLU-dropout-conv stages after it and the
    shortcut epilogue."""

    def _stage1(self, x, pieces, deterministic):
        h = self.norm1(x, deterministic=deterministic, pieces=pieces)
        if isinstance(h, _AffineChain):
            return self.conv1(h)
        h = F.silu(h)
        if pieces is not None:
            return self.conv1(h, [p.shape[1] for p in pieces])
        return self.conv1(h)

    @staticmethod
    def _stage_n(norm, conv, h, films, deterministic, generator):
        h = norm(h, films=films, deterministic=deterministic)
        if isinstance(h, _AffineChain):
            return conv(h)
        return conv(dropout(F.silu(h), DROPOUT, deterministic, generator))

    def _epilogue(self, x, h, pieces):
        h = (self.shortcut(x, h, pieces) if self.shortcut is not None
             else h + x)
        return self.attn(h) if self.attn is not None else h


class ResBlock(_ResBlockBase):
    """Time-conditioned ResBlock: norm1-SiLU-conv1,
    [norm2 + FiLM(t)]-SiLU-dropout-conv2, norm3-SiLU-dropout-conv3,
    + shortcut, then optional attention. ``skip_concat`` builds an up
    block, which takes ``(h, skip)``."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 attn: bool = False, dtype: torch.dtype = torch.float32,
                 skip_concat: bool = False):
        super().__init__()
        self.norm1 = _GNParams(in_ch, out_ch)
        self.conv1 = (PieceConv3 if skip_concat else Conv3)(in_ch, out_ch,
                                                            dtype)
        self.temb_proj = Dense(emb_dim, 2 * out_ch, dtype)
        self.norm2 = _GNParams(out_ch, out_ch)
        self.conv2 = Conv3(out_ch, out_ch, dtype)
        self.norm3 = _GNParams(out_ch, out_ch)
        self.conv3 = Conv3(out_ch, out_ch, dtype)
        self.shortcut = (
            ShortcutDense(in_ch, out_ch, dtype) if in_ch != out_ch else None
        )
        self.attn = AttnBlock(out_ch, dtype) if attn else None

    def forward(self, x, temb: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pieces, x = _as_pieces(x)
        h = self._stage1(x, pieces, deterministic)
        t_scale, t_shift = self.temb_proj(F.silu(temb)).chunk(2, dim=-1)
        h = self._stage_n(self.norm2, self.conv2, h, ((t_scale, t_shift),),
                          deterministic, generator)
        h = self._stage_n(self.norm3, self.conv3, h, (), deterministic,
                          generator)
        return self._epilogue(x, h, pieces)


class AuxResBlock(_ResBlockBase):
    """ResBlock with dual FiLM, time then aux latent: norm1-SiLU-conv1,
    [norm2 + FiLM(t) + FiLM(a)]-SiLU-dropout-conv2,
    norm3-SiLU-dropout-conv3, + shortcut, then optional attention.
    ``skip_concat`` builds an up block, which takes ``(h, skip)``."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 attn: bool = False, dtype: torch.dtype = torch.float32,
                 skip_concat: bool = False):
        super().__init__()
        self.norm1 = _GNParams(in_ch, out_ch)
        self.conv1 = (PieceConv3 if skip_concat else Conv3)(in_ch, out_ch,
                                                            dtype)
        self.temb_proj = Dense(emb_dim, 2 * out_ch, dtype)
        self.aemb_proj = Dense(emb_dim, 2 * out_ch, dtype)
        self.norm2 = _GNParams(out_ch, out_ch)
        self.conv2 = Conv3(out_ch, out_ch, dtype)
        self.norm3 = _GNParams(out_ch, out_ch)
        self.conv3 = Conv3(out_ch, out_ch, dtype)
        self.shortcut = (
            ShortcutDense(in_ch, out_ch, dtype) if in_ch != out_ch else None
        )
        self.attn = AttnBlock(out_ch, dtype) if attn else None

    def forward(self, x, temb: torch.Tensor, aemb: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pieces, x = _as_pieces(x)
        h = self._stage1(x, pieces, deterministic)
        t_scale, t_shift = self.temb_proj(F.silu(temb)).chunk(2, dim=-1)
        a_scale, a_shift = self.aemb_proj(F.silu(aemb)).chunk(2, dim=-1)
        h = self._stage_n(self.norm2, self.conv2, h,
                          ((t_scale, t_shift), (a_scale, a_shift)),
                          deterministic, generator)
        h = self._stage_n(self.norm3, self.conv3, h, (), deterministic,
                          generator)
        return self._epilogue(x, h, pieces)


class EncoderResBlock(_ResBlockBase):
    """The unconditioned ResBlock of the Encoder: norm1-SiLU-conv1,
    norm2-SiLU-dropout-conv2, + shortcut, then optional attention."""

    def __init__(self, in_ch: int, out_ch: int, attn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 skip_concat: bool = False):
        super().__init__()
        self.norm1 = _GNParams(in_ch, out_ch)
        self.conv1 = (PieceConv3 if skip_concat else Conv3)(in_ch, out_ch,
                                                            dtype)
        self.norm2 = _GNParams(out_ch, out_ch)
        self.conv2 = Conv3(out_ch, out_ch, dtype)
        self.shortcut = (
            ShortcutDense(in_ch, out_ch, dtype) if in_ch != out_ch else None
        )
        self.attn = AttnBlock(out_ch, dtype) if attn else None

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pieces, x = _as_pieces(x)
        h = self._stage1(x, pieces, deterministic)
        h = self._stage_n(self.norm2, self.conv2, h, (), deterministic,
                          generator)
        return self._epilogue(x, h, pieces)


class DownSample(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3(channels, channels, dtype, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UpSample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3(channels, channels, dtype, repeat=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class LatentConv(nn.Module):
    """Flax ``nn.Conv`` with a kernel of 3 over ``[B, L, C]``: ``weight``
    [O, I, 3], padding (1, 1), computed in ``dtype`` with f32
    parameters."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 stride: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.weight = nn.Parameter(
            xavier_(torch.empty(channels, channels, 3)))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(x.to(self.dtype).transpose(1, 2),
                     self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.stride, padding=1)
        return y.transpose(1, 2)


class LatentDownSample(nn.Module):
    """A stride-2 1-D conv over ``[B, L, C]`` -> ``[B, ceil(L / 2), C]``
    (reference: modules.py:96-108; defined there, used by no model)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = LatentConv(channels, dtype, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class LatentUpSample(nn.Module):
    """Each position repeated twice, then a 1-D conv: ``[B, L, C]`` ->
    ``[B, 2 L, C]`` (reference: modules.py:111-126; used by no model)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = LatentConv(channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.repeat_interleave(2, dim=1))


class MLPLNAct(nn.Module):
    """Linear -> [x * (condition_bias + Linear(act(cond)))] -> LayerNorm
    (f32, eps 1e-5) -> act. ``activation`` is None or 'silu'."""

    def __init__(self, in_ch: int, out_ch: int, norm: bool, use_cond: bool,
                 cond_ch: int = 0, activation: Optional[str] = None,
                 condition_bias: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if activation not in (None, "silu"):
            raise ValueError(f"activation must be None or 'silu', got "
                             f"{activation!r}")
        self.activation = activation
        self.condition_bias = condition_bias
        self.dtype = dtype
        self.linear = Dense(in_ch, out_ch, dtype)
        self.linear_emb = Dense(cond_ch, out_ch, dtype) if use_cond else None
        self.norm = nn.LayerNorm(out_ch, eps=1e-5) if norm else None
        # the reference's init: Kaiming-normal (relu) under an activation,
        # else lecun-normal
        init_ = kaiming_normal_relu_ if activation else lecun_normal_
        for layer in (self.linear, self.linear_emb):
            if layer is not None:
                init_(layer.weight.data)

    def forward(self, x: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.linear(x)
        if self.linear_emb is not None:
            c = F.silu(cond) if self.activation is not None else cond
            x = x * (self.condition_bias + self.linear_emb(c))
        if self.norm is not None:
            x = self.norm(x.to(torch.float32)).to(self.dtype)
        if self.activation is not None:
            x = F.silu(x)
        return x
