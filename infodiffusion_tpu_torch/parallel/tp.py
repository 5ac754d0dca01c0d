"""Tensor parallelism over the mesh's ``model`` axis
(JAX counterpart: ``infodiffusion_tpu/parallel/tp.py``).

The JAX rule: every parameter of at least ``min_size`` (2**12) elements
whose output-feature axis (the last Flax axis: O of a conv kernel
[kh, kw, I, O] and of a Dense kernel [I, O]) the model width divides is
split on that axis over ``model``; with ``fsdp`` its largest remaining
axis of at least ``fsdp_min_size`` elements also splits over ``data``.
Small tensors stay whole. In torch's layouts the output features are axis
0 of a ``weight``.

JAX only places the arrays and XLA inserts the collectives. Here each rank
of a model group holds its output-channel slice of such a Conv3 or Dense
and computes those channels (``TPShard``): its input passes through an
identity whose backward sums the input gradient over the group, and an
all-gather over the group restores the whole channel axis before the next
consumer (its backward hands each rank its channels' cotangent). The
GroupNorm kernel (K1) and the attention kernels therefore see whole
tensors, and the math is the one-process math.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.parallel.batch import gather, sum_grad
from infodiffusion_tpu_torch.parallel.fsdp import (
    FSDP_MIN_SIZE,
    flax_perm,
    flax_shape,
    largest_dividing_axis,
)

TP_MIN_SIZE = 2 ** 12


def tp_dims(name: str, shape: Sequence[int], ntp: int, ndp: int = 1,
            min_size: int = TP_MIN_SIZE, fsdp: bool = False,
            fsdp_min_size: int = FSDP_MIN_SIZE
            ) -> Tuple[Optional[int], Optional[int]]:
    """(data axis, model axis) of parameter ``name`` in torch's layout,
    each None when it does not split."""
    nd = len(shape)
    fshape = flax_shape(name, shape)
    perm = flax_perm(name, nd)
    size = math.prod(shape)
    model = data = None
    if ntp > 1 and nd >= 1 and size >= min_size and fshape[-1] % ntp == 0:
        model = nd - 1
    if fsdp and ndp > 1 and size >= fsdp_min_size:
        data = largest_dividing_axis(
            fshape, ndp, taken=() if model is None else (model,))
    return (None if data is None else perm.index(data),
            None if model is None else perm.index(model))


def tp_param_sharding(params: Dict[str, torch.Tensor], ntp: int,
                      ndp: int = 1, min_size: int = TP_MIN_SIZE,
                      fsdp: bool = False,
                      fsdp_min_size: int = FSDP_MIN_SIZE):
    """``{name: (data axis, model axis)}`` for every parameter."""
    return {k: tp_dims(k, tuple(v.shape), ntp, ndp, min_size, fsdp,
                       fsdp_min_size) for k, v in params.items()}


class TPShard:
    """The channel-split compute of one Conv3 or Dense whose weight holds
    this rank's output channels (``bias_split``: its bias too)."""

    def __init__(self, group, bias_split: bool):
        self.group = group
        self.bias_split = bias_split

    def dense(self, m, x: torch.Tensor) -> torch.Tensor:
        x = sum_grad(x.to(m.dtype), self.group)
        b = m.bias.to(m.dtype)
        y = F.linear(x, m.weight.to(m.dtype), b if self.bias_split else None)
        y = gather(y, self.group, y.dim() - 1)
        return y if self.bias_split else y + b

    def conv(self, m, x: torch.Tensor) -> torch.Tensor:
        x = x.to(m.dtype)
        if m.repeat > 1:
            x = F.interpolate(x, scale_factor=m.repeat, mode="nearest")
        x = sum_grad(x, self.group)
        b = m.bias.to(m.dtype)
        y = F.conv2d(x, m.weight.to(m.dtype), b if self.bias_split else None,
                     stride=m.stride, padding=1)
        y = gather(y, self.group, 1)
        return y if self.bias_split else y + b[None, :, None, None]


def install(model: torch.nn.Module, split: Dict[str, bool], group) -> int:
    """Give each module whose ``weight`` splits over ``model`` (``split``:
    name -> whether it splits) its ``TPShard``; returns how many. A split
    parameter on any other module raises."""
    from infodiffusion_tpu_torch.nn.blocks import Conv3
    from infodiffusion_tpu_torch.nn.layers import Dense

    done, n = set(), 0
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        names = [prefix + p for p, _ in module.named_parameters(recurse=False)]
        if not any(split.get(k) for k in names):
            continue
        if not isinstance(module, (Dense, Conv3)) or not split.get(
                prefix + "weight"):
            raise NotImplementedError(
                f"--tp splits {[k for k in names if split.get(k)]}, which "
                f"the port's tensor parallelism does not compute split "
                f"({type(module).__name__})")
        module.tp = TPShard(group, bool(split.get(prefix + "bias")))
        done.update(names)
        n += 1
    return n
