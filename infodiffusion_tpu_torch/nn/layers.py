"""The Dense layer under the JAX package's dtype policy.

Flax's ``nn.Dense`` keeps f32 parameters and computes in the module dtype
(``promote_dtype``). ``Dense`` does the same: parameters stay f32 and are
cast to ``dtype`` with the input at each call. Parameter names and layouts
are torch's (``weight`` [O, I], ``bias``); ``interop.from_jax_params`` maps
the Flax tree onto them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def xavier_(w: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    return nn.init.xavier_uniform_(w, gain=gain)


class Dense(nn.Module):
    """``nn.Dense``: ``x @ W + b`` over the last axis, computed in ``dtype``.
    Under tensor parallelism ``tp`` (``parallel/tp.py``) computes this
    rank's output features and gathers the rest."""

    tp = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            xavier_(torch.empty(out_features, in_features))
        )
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.dense(self, x)
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype),
            self.bias.to(self.dtype),
        )
