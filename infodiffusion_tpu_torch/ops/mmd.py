"""MMD with the reference's RBF-like kernel
(JAX counterpart: ``infodiffusion_tpu/ops/mmd.py``).

The kernel is ``exp(-|x_i - y_j|^2 / dim^2)``: the reference takes the
mean over dim and then divides by dim again, an effective bandwidth of
dim^2, kept for loss parity. Pairwise distances use the polarization form
``|x|^2 + |y|^2 - 2 x.y``, clamped at 0, in f32. Plain PyTorch: the JAX
side is XLA, not a kernel.
"""

from __future__ import annotations

import torch


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xx = (x * x).sum(dim=1)[:, None]
    yy = (y * y).sum(dim=1)[None, :]
    return torch.clamp(xx + yy - 2.0 * (x @ y.T), min=0.0)


def compute_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """k(x_i, y_j) = exp(-|x_i - y_j|^2 / dim^2)."""
    dim = x.shape[1]
    return torch.exp(-_pairwise_sqdist(x, y) / (dim * dim))


def compute_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MMD^2 estimate with the diagonal terms, like the reference."""
    return (compute_kernel(x, x).mean() + compute_kernel(y, y).mean()
            - 2.0 * compute_kernel(x, y).mean())
