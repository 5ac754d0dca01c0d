"""Prior draws, the slerp helpers, seeding and the console meters
(JAX counterpart: ``infodiffusion_tpu/utils.py``).

``--prior 10mix`` and ``--prior roll`` as the JAX package draws them, from
an explicit ``torch.Generator`` (never the global RNG). The quirks are
kept: the mixture's ``x_var``/``y_var`` are standard deviations (the
reference passes them to ``np.random.normal`` as its scale), and the
mixture's 2-d pairs are interleaved ``[x0, y0, x1, y1, ...]``.
"""

from __future__ import annotations

import math
import random as _pyrandom
from typing import Optional

import numpy as np
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


def cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of two flattened tensors; feeds the slerp of
    interpolate mode."""
    a, b = a.reshape(-1), b.reshape(-1)
    return torch.dot(a / a.norm(), b / b.norm())


def slerp(x0: torch.Tensor, x1: torch.Tensor, e: float, theta) -> torch.Tensor:
    """(sin((1-e)θ) x0 + sin(eθ) x1) / sin(θ)."""
    return (torch.sin((1.0 - e) * theta) * x0
            + torch.sin(e * theta) * x1) / torch.sin(theta)


def seed_everything(r_seed: int) -> int:
    """Seed Python's, numpy's and torch's global generators and return the
    seed of the run's own ``torch.Generator`` draws (every draw of the port
    comes from an explicit generator; the global ones are seeded for any
    library code that reads them)."""
    _pyrandom.seed(r_seed)
    np.random.seed(r_seed)
    torch.manual_seed(r_seed)
    return r_seed


class AverageMeter:
    """Console meter: the last value and the running average."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """Console progress line: ``prefix[i/n]`` and each meter."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        self.batch_fmtstr = self._get_batch_fmtstr(num_batches)
        self.meters = meters
        self.prefix = prefix

    def display(self, batch: int):
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        print("\r" + "\t".join(entries), end="")

    @staticmethod
    def _get_batch_fmtstr(num_batches: int):
        num_digits = len(str(num_batches // 1))
        fmt = "{:" + str(num_digits) + "d}"
        return "[" + fmt + "/" + fmt.format(num_batches) + "]"
