"""Prior draws (JAX counterpart: ``infodiffusion_tpu/utils.py``).

``--prior 10mix`` and ``--prior roll`` as the JAX package draws them, from
an explicit ``torch.Generator`` (never the global RNG). The quirks are
kept: the mixture's ``x_var``/``y_var`` are standard deviations (the
reference passes them to ``np.random.normal`` as its scale), and the
mixture's 2-d pairs are interleaved ``[x0, y0, x1, y1, ...]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def gaussian_mixture(
    generator: Optional[torch.Generator],
    batch_size: int,
    n_dim: int = 2,
    n_labels: int = 10,
    x_var: float = 0.5,
    y_var: float = 0.1,
    shift: float = 1.4,
    label_indices=None,
    device=None,
) -> torch.Tensor:
    """10 Gaussians on a ring, drawn per 2-d pair: [batch_size, n_dim] f32."""
    if n_dim % 2 != 0:
        raise ValueError("n_dim must be a multiple of 2.")
    pairs = n_dim // 2
    kw = dict(generator=generator, device=device)
    x = torch.randn(batch_size, pairs, **kw) * x_var
    y = torch.randn(batch_size, pairs, **kw) * y_var
    if label_indices is not None:
        label = torch.as_tensor(label_indices, device=device)[:, None].expand(
            batch_size, pairs)
    else:
        label = torch.randint(0, n_labels, (batch_size, pairs), **kw)
    r = 2.0 * math.pi / n_labels * label.to(torch.float32)
    c, s = torch.cos(r), torch.sin(r)
    new_x = x * c - y * s + shift * c
    new_y = x * s + y * c + shift * s
    return torch.stack([new_x, new_y], dim=-1).reshape(batch_size, n_dim)


def swiss_roll(generator: Optional[torch.Generator], batch_size: int,
               noise: float = 0.5, device=None) -> torch.Tensor:
    """sklearn's ``make_swiss_roll`` dims [0, 2] / 5: [batch_size, 2] f32."""
    kw = dict(generator=generator, device=device)
    t = 1.5 * math.pi * (1.0 + 2.0 * torch.rand(batch_size, **kw))
    n = torch.randn(batch_size, 2, **kw) * noise
    return (torch.stack([t * torch.cos(t), t * torch.sin(t)], dim=-1) + n) / 5.0
