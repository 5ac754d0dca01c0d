"""FSDP/ZeRO placement (JAX counterpart: ``infodiffusion_tpu/parallel/fsdp.py``).

The JAX rule, parameter by parameter: an array of at least ``min_size``
(2**14) elements is split over the ``data`` axis on its largest dimension
that the data width divides (the first such in the Flax layout's axis
order on a tie); smaller ones stay whole on every rank. The Adam moments
and the EMA follow their parameter.

The rule is applied to the **Flax** shape, then mapped to the torch axis
through ``interop``'s layout rules (a conv ``kernel`` [kh, kw, I, O] is a
``weight`` [O, I, kh, kw], a Dense ``kernel`` [I, O] a ``weight`` [O, I]),
so each parameter splits on the axis JAX splits. The step that runs on
these shards is ``parallel/layout.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

FSDP_MIN_SIZE = 2 ** 14


def flax_perm(name: str, ndim: int) -> Tuple[int, ...]:
    """``perm[i]``: the Flax axis of torch axis ``i`` of parameter
    ``name`` (``interop._convert``'s transposes)."""
    if name.endswith("weight") and ndim == 4:
        return (3, 2, 0, 1)
    if name.endswith("weight") and ndim == 3:
        return (2, 1, 0)
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def flax_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    perm = flax_perm(name, len(shape))
    out = [0] * len(shape)
    for i, d in enumerate(shape):
        out[perm[i]] = d
    return tuple(out)


def largest_dividing_axis(shape: Sequence[int], n: int,
                          taken=()) -> Optional[int]:
    """JAX's choice: the largest axis ``n`` divides, the first on a tie."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if d not in taken and shape[d] % n == 0:
            return d
    return None


def fsdp_dim(name: str, shape: Sequence[int], n: int,
             min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The torch axis parameter ``name`` splits on over ``n`` data ranks
    (None: whole on every rank)."""
    if n <= 1 or len(shape) == 0 or math.prod(shape) < min_size:
        return None
    d = largest_dividing_axis(flax_shape(name, shape), n)
    return None if d is None else flax_perm(name, len(shape)).index(d)


def fsdp_param_sharding(params: Dict[str, torch.Tensor], n: int,
                        min_size: int = FSDP_MIN_SIZE
                        ) -> Dict[str, Optional[int]]:
    """``{name: torch axis or None}`` for every parameter."""
    return {k: fsdp_dim(k, tuple(v.shape), n, min_size)
            for k, v in params.items()}
