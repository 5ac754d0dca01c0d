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

The quant state is the JAX ``'quant'`` collection: ``act_absmax`` at each
quantized conv (shape () or (n_pieces,)) and the ``fused_qconv`` markers
of the norms whose chain the fused quantize-conv kernel may take. The port
keeps each entry as a non-persistent buffer on its module, named as in the
Flax collection (``unet.upblock_9.conv1.act_absmax``), so ``state_dict``,
``from_jax_params``, training and checkpoints never see it. A module
without quant state runs the model-dtype path.

Only the ``'int8'`` tier is ported. The JAX ``'int8x'`` tier (residual
reads through s8 copies) is not: ROADMAP.md lists it under "do not port".
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_EPS = 1e-30

#: the ported turbo tiers
MODES = ("int8",)
#: the names of the quant state's entries (the Flax collection's leaves)
STATE_NAMES = ("act_absmax", "fused_qconv")

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
    convs observe their input range and the norms record their
    ``fused_qconv`` markers while it is set."""
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
    if mode == "int8x":
        raise ValueError(
            "the 'int8x' turbo tier is not ported (ROADMAP.md, 'do not "
            "port'); use 'int8'")
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


def quantize_pieces_folded(pieces: Sequence[torch.Tensor],
                           absmax: torch.Tensor, kernel: torch.Tensor):
    """Per-piece int8 for a skip-concat conv, the per-piece activation
    scales folded into the HWIO ``kernel``'s input-channel slices before
    the joint per-output-channel weight quantization. Returns
    ``(xq_list, kq, sw)``: the pieces' s32 partials over their slices of
    ``kq`` sum directly and dequantize once by ``sw``."""
    s = act_scale(absmax)
    xqs = [torch.clamp(torch.round(p.to(torch.float32) / s[i]), -127.0,
                       127.0).to(torch.int8) for i, p in enumerate(pieces)]
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
    quantized conv's ``act_absmax`` (() or (n_pieces,)) and each marked
    norm's ``fused_qconv`` (())."""
    from infodiffusion_tpu_torch.nn.blocks import PieceConv3

    sites = {}
    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if "act_absmax" in mod._buffers:
            sites[prefix + "act_absmax"] = (
                (2,) if isinstance(mod, PieceConv3) else ())
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
    ``model``, which now runs the int8 tier."""
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
