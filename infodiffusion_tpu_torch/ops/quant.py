"""The int8 "turbo" inference tier: W8A8 UNet conv bodies
(JAX counterpart: ``infodiffusion_tpu/ops/quant.py``).

Scheme, as in the JAX package (standard post-training W8A8, symmetric):

- weights: per-output-channel int8, quantized from the f32 parameters at
  every forward (no packed copy, so checkpoints are untouched);
- activations: per-tensor int8 with static scales, calibrated once per
  sampler construction by one forward over a batch spanning the timestep
  grid (:func:`calibrate`);
- int8 x int8 -> int32 convolution (:func:`int8_conv`, the hand-written
  kernel ``csrc/qconv.cu`` on a CUDA tensor), dequantize and bias in f32.
  Schedule math, GroupNorm statistics and softmax stay f32, the 1x1
  shortcuts and the image head and tail convs stay in the model dtype.

Two tiers, as in the JAX package (:data:`MODES`):

- ``'int8'``: the conv bodies W8A8, the residual stream and the shortcuts
  in the model dtype;
- ``'int8x'``: ``'int8'``, and each ResBlock reads its input through one
  per-piece s8 view (:func:`quantize_x_pieces`): norm1 normalizes the
  view dequantized in f32, and the 1x1 shortcut is an s8 x s8 -> s32
  product from it (:func:`int8_shortcut`, ``torch._int_mm`` on a CUDA
  tensor, as JAX leaves ``int8_dot`` to XLA). The residual carry itself
  (the identity ``h + x``) keeps the raw input. Sampling and encoding
  only; the latent prior has no int8x form and takes ``'int8'``.

The quant state is the JAX ``'quant'`` collection: ``act_absmax`` at each
quantized conv (shape () or (n_pieces,)), ``x_absmax`` at each ResBlock's
``xq`` under ``'int8x'`` (shape (n_pieces,)) and the ``fused_qconv``
markers of the norms whose chain the fused quantize-conv kernel may take
(``'int8'`` only). The port keeps each entry as a non-persistent buffer on
its module, named as in the Flax collection
(``unet.upblock_9.conv1.act_absmax``, ``unet.upblock_9.xq.x_absmax``), so
``state_dict``, ``from_jax_params``, training and checkpoints never see
it. A module without quant state runs the model-dtype path; a block
without ``x_absmax`` runs the ``'int8'`` path.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-30

#: the turbo tiers
MODES = ("int8", "int8x")
#: the names of the quant state's entries (the Flax collection's leaves)
STATE_NAMES = ("act_absmax", "fused_qconv", "x_absmax")

_calib_mode = ""


def _per_127(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, eps) / 127`` as an IEEE f32 division on every device.
    (On a CUDA tensor, dividing by a Python number or a CPU scalar tensor
    multiplies by its rounded reciprocal instead, which moves a scale by
    an ulp and can flip int8 values against the CPU.)"""
    a = torch.clamp(absmax.to(torch.float32), min=_EPS)
    return a / torch.full((), 127.0, device=a.device)


def calib_mode() -> str:
    """The tier being calibrated ('' outside :func:`calibrate`): quantized
    convs observe their input range while it is set, the norms record their
    ``fused_qconv`` markers under ``'int8'`` and the blocks' ``xq`` their
    input range under ``'int8x'``."""
    return _calib_mode


@contextlib.contextmanager
def _calibrating(mode: str):
    global _calib_mode
    _calib_mode = mode
    try:
        yield
    finally:
        _calib_mode = ""


def turbo_mode() -> str:
    """'' (off) or a tier: the ``INFODIFF_TURBO`` default of the samplers
    when neither the argument nor the config names one."""
    return os.environ.get("INFODIFF_TURBO", "")


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown turbo mode {mode!r} (expected {MODES})")


def quantize_weight(kernel: torch.Tensor,
                    reduce_dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per output channel: ``(q int8, scale f32)``.
    ``reduce_dims`` are the non-output dims ((0, 1, 2) for an HWIO conv
    kernel, (1, 2, 3) for torch's OIHW); ``scale`` has the output dim's
    size. f32 divide, round half to even, clip to +-127."""
    k = kernel.to(torch.float32)
    scale = _per_127(torch.amax(k.abs(), dim=reduce_dims, keepdim=True))
    q = torch.clamp(torch.round(k / scale), -127.0, 127.0).to(torch.int8)
    return q, scale.reshape(-1)


def act_scale(absmax: torch.Tensor) -> torch.Tensor:
    """The activation scale(s) of calibrated ``absmax``."""
    return _per_127(absmax)


def quantize_act(x: torch.Tensor,
                 absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 at a static calibrated ``absmax`` scalar:
    ``(q int8, scale f32)``; values beyond the range saturate."""
    scale = act_scale(absmax)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_x_pieces(pieces: Sequence[torch.Tensor], absmax: torch.Tensor
                      ) -> Tuple[list, torch.Tensor]:
    """Symmetric per-piece int8 at the calibrated ``absmax`` (n_pieces,):
    ``(q_list, s)`` with ``pieces[i] ~= q_list[i] * s[i]``; elementwise, so
    each piece keeps its layout. The int8x tier's s8 view of a block's
    input, and the first step of :func:`quantize_pieces_folded`."""
    s = act_scale(absmax)
    qs = [torch.clamp(torch.round(p.to(torch.float32) / s[i]), -127.0,
                      127.0).to(torch.int8) for i, p in enumerate(pieces)]
    return qs, s


def quantize_pieces_folded(pieces: Sequence[torch.Tensor],
                           absmax: torch.Tensor, kernel: torch.Tensor):
    """Per-piece int8 for a skip-concat conv, the per-piece activation
    scales folded into the HWIO ``kernel``'s input-channel slices before
    the joint per-output-channel weight quantization. Returns
    ``(xq_list, kq, sw)``: the pieces' s32 partials over their slices of
    ``kq`` sum directly and dequantize once by ``sw``."""
    xqs, s = quantize_x_pieces(pieces, absmax)
    keff, o = [], 0
    for i, p in enumerate(pieces):
        c = p.shape[-1]
        keff.append(kernel[:, :, o:o + c, :].to(torch.float32) * s[i])
        o += c
    kq, sw = quantize_weight(torch.cat(keff, dim=2), (0, 1, 2))
    return xqs, kq, sw


def int8_conv_reference(xq: torch.Tensor, kq: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Plain int8 x int8 -> int32 3x3 conv, padding 1: NHWC ``xq`` and
    HWIO ``kq`` (int8) -> NHWC int32. Computed in float64, which is exact:
    |sum| <= 127^2 * 9 * C < 2^53."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    k = kq.permute(3, 2, 0, 1).to(torch.float64)
    y = F.conv2d(x, k, stride=stride, padding=1)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def int8_conv(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
              **epilogue) -> torch.Tensor:
    """int8 x int8 -> int32 3x3 conv with padding 1 (NHWC, HWIO): the
    hand-written kernel on a CUDA tensor (``ops/cuda/qconv.py``
    ``int8_conv_cuda``), its plain version on a CPU one. ``epilogue``
    (``scale``, ``bias``, ``partial``, ``out_dtype``) fuses the dequant
    into the same pass; see ``int8_conv_epilogue``."""
    from infodiffusion_tpu_torch.ops.cuda.qconv import (
        int8_conv_cuda,
        int8_conv_epilogue,
    )

    if xq.is_cuda:
        return int8_conv_cuda(xq, kq, stride, **epilogue)
    return int8_conv_epilogue(int8_conv_reference(xq, kq, stride),
                              **epilogue)


def int8_dot_reference(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Plain int8 x int8 -> int32 product of ``xq`` [..., K] and ``kq``
    [K, N], in float64, which is exact: |sum| <= 127^2 * K < 2^53."""
    return (xq.to(torch.float64) @ kq.to(torch.float64)).to(torch.int32)


def int8_dot(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 product over the last axis of ``xq`` [..., K]
    and the first of ``kq`` [K, N] (the 1x1 projection). On a CUDA tensor
    ``torch._int_mm``, cuBLASLt's s8 GEMM (JAX leaves this product to
    XLA), which takes K, N multiples of 8 and, on the H100 (PERF.md),
    only row counts that are multiples of 32: the rows are padded with
    zero rows to the next multiple of 32 (a batch-1 4x4 level has 16) and
    sliced back, which is exact; K or N not a multiple of 8 raises. Its
    plain version on a CPU tensor. ``int8_dot.launches`` counts the card's
    products."""
    if not xq.is_cuda:
        return int8_dot_reference(xq, kq)
    a = xq.reshape(-1, xq.shape[-1])
    (m, k), n = a.shape, kq.shape[1]
    if k % 8 or n % 8 or kq.shape[0] != k:
        raise ValueError(f"int8_dot on the card (torch._int_mm) takes K, N "
                         f"multiples of 8; got [{m}, {k}] x "
                         f"{list(kq.shape)}")
    if m % 32:
        a = F.pad(a, (0, 0, 0, -m % 32))
    int8_dot.launches += 1
    y = torch._int_mm(a.contiguous(), kq.contiguous())
    return y[:m].reshape(xq.shape[:-1] + (n,))


int8_dot.launches = 0


def int8_shortcut(qx, kernel: torch.Tensor, bias: torch.Tensor, dtype,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8x tier's 1x1 shortcut, ``residual + concat(pieces) @ kernel
    + bias``, from a block's s8 view ``qx = (q_list, s)`` (NHWC pieces,
    :func:`quantize_x_pieces`) and the [Cin, Cout] ``kernel``: the
    per-piece scales folded into the kernel's row slices before one joint
    per-output-channel quantization, one :func:`int8_dot` a piece, the f32
    running sum rounded to bf16 between pieces, then ``acc * sw + bias``
    cast to ``dtype`` before the residual is added."""
    qs, s = qx
    keff, o = [], 0
    for i, q in enumerate(qs):
        c = q.shape[-1]
        keff.append(kernel[o:o + c, :].to(torch.float32) * s[i])
        o += c
    kq, sw = quantize_weight(torch.cat(keff, dim=0), (0,))
    acc, o = None, 0
    for i, q in enumerate(qs):
        c = q.shape[-1]
        y = int8_dot(q, kq[o:o + c, :]).to(torch.float32)
        acc = y if acc is None else acc + y
        if i < len(qs) - 1:
            acc = acc.to(torch.bfloat16).to(torch.float32)
        o += c
    out = (acc * sw + bias.to(torch.float32)).to(dtype)
    return out if residual is None else residual + out


def observe_absmax(module: torch.nn.Module, x_or_pieces,
                   name: str = "act_absmax") -> None:
    """Calibration hook: the running max(|x|) of a conv site's input, kept
    as the module's buffer ``name`` (shape () for one tensor, (n,) for a
    list of n skip-concat pieces)."""
    if isinstance(x_or_pieces, (tuple, list)):
        cur = torch.stack([p.to(torch.float32).abs().amax()
                           for p in x_or_pieces])
    else:
        cur = x_or_pieces.to(torch.float32).abs().amax()
    prev = getattr(module, name)
    setattr(module, name, cur if prev is None else torch.maximum(prev, cur))


def quant_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's quant state, by the Flax collection's dotted names."""
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in STATE_NAMES}


def clear_quant_state(model: torch.nn.Module) -> None:
    for mod in model.modules():
        for name in STATE_NAMES:
            if name in mod._buffers:
                mod._buffers[name] = None


def quant_sites(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """Every entry the model's quant state can hold, with its shape: each
    quantized conv's ``act_absmax`` (() or (n_pieces,)), each block's
    ``xq.x_absmax`` ((n_pieces,)) and each marked norm's ``fused_qconv``
    (()). A conv whose ``quantized`` is false now (the upsample conv
    under ``INFODIFF_SUBPIXEL_UPSAMPLE=1``) holds no ``act_absmax``."""
    from infodiffusion_tpu_torch.nn.blocks import PieceConv3

    sites = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if "act_absmax" in mod._buffers and mod.quantized:
            sites[prefix + "act_absmax"] = (
                (2,) if isinstance(mod, PieceConv3) else ())
        if "x_absmax" in mod._buffers:
            sites[prefix + "x_absmax"] = (mod.n_pieces,)
        if "fused_qconv" in mod._buffers:
            sites[prefix + "fused_qconv"] = ()
    return sites


def load_quant_state(model: torch.nn.Module,
                     state: Dict[str, torch.Tensor]) -> None:
    """Replace the model's quant state with ``state`` (dotted names, as
    :func:`quant_state` gives them), on the model's device."""
    clear_quant_state(model)
    dev = _device(model)
    for name, value in state.items():
        path, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(path), leaf,
                value.to(device=dev, dtype=torch.float32))


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def calibrate(model: torch.nn.Module, data_shape, a_dim: Optional[int] = None,
              T: int = 1000, batch: int = 32, seed: int = 0,
              mode: str = "int8", x: Optional[torch.Tensor] = None,
              a: Optional[torch.Tensor] = None) -> torch.nn.Module:
    """One no-grad forward of ``model(x, t[, a])`` in observe mode, with
    x ~ N(0, 1) of shape ``(batch,) + data_shape`` (NHWC), t =
    ``linspace(0, T-1, batch)`` truncated to int and a ~ N(0, 1) when
    ``a_dim`` is given. ``x`` and ``a`` can be injected; otherwise they are
    drawn from a generator seeded with ``seed``. The model's earlier quant
    state is dropped first; its parameters are not touched. Returns
    ``model``, which now runs the tier ``mode`` (``'int8x'`` also observes
    each ResBlock's input, its ``xq.x_absmax``)."""
    check_mode(mode)
    dev = _device(model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if x is None:
        x = torch.randn((batch,) + tuple(data_shape), generator=gen,
                        device=dev)
    t = torch.linspace(0.0, T - 1, x.shape[0]).to(torch.int64).to(dev)
    args = (x.to(dev), t)
    if a_dim is not None:
        if a is None:
            a = torch.randn((x.shape[0], a_dim), generator=gen, device=dev)
        args += (a.to(dev),)
    clear_quant_state(model)
    with torch.no_grad(), _calibrating(mode):
        model(*args)
    return model


def calibrate_encoder(model: torch.nn.Module, x: Optional[torch.Tensor] = None,
                      data_shape=None, batch: int = 32, seed: int = 0,
                      mode: str = "int8") -> torch.nn.Module:
    """Calibration of the Encoder alone: one deterministic
    ``model.encode(x, sample=False)`` in observe mode, with a data batch
    ``x`` or x ~ N(0, 1) over ``(batch,) + data_shape`` (NHWC)."""
    check_mode(mode)
    dev = _device(model)
    if x is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((batch,) + tuple(data_shape), generator=gen,
                        device=dev)
    clear_quant_state(model.encoder)
    with torch.no_grad(), _calibrating(mode):
        model.encode(x.to(dev), sample=False)
    return model
