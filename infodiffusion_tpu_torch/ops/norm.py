"""GroupNorm and fused GroupNorm+FiLM (AdaGN)
(JAX counterpart: ``infodiffusion_tpu/ops/norm.py``).

``x`` is NHWC ``[B, H, W, C]`` or ``[B, N, C]``; ``num_groups`` groups over
the channel (last) axis; statistics in f32. A CUDA tensor runs kernel K1
(``ops/cuda/adagn.py``), a CPU tensor its plain version. Every GroupNorm
site of the generation path goes through here, FiLM-free sites with K=0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from infodiffusion_tpu_torch.ops.cuda.adagn import adagn_cuda, adagn_reference


def adagn(
    x: torch.Tensor,
    num_groups: int,
    scale: torch.Tensor,
    bias: torch.Tensor,
    films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """GroupNorm, then the FiLMs ``h = h * (1 + s) + b`` in order: one for
    time, a second for the aux latent in AuxResBlock. Each (s, b): [B, C]."""
    if x.is_cuda:
        return adagn_cuda(x, num_groups, scale, bias, films)
    return adagn_reference(x, num_groups, scale, bias, films)


def group_norm(x: torch.Tensor, num_groups: int, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Plain GroupNorm over the last axis (AdaGN with no FiLM)."""
    return adagn(x, num_groups, scale, bias)
