"""Timestep embeddings (JAX counterpart: ``infodiffusion_tpu/nn/embeddings.py``).

Two layouts, both kept:

- ``TimeEmbedding``: a [T, d_model] table of *interleaved* (sin, cos) pairs,
  then Linear -> SiLU -> Linear to ``dim``.
- ``timestep_embedding``: ``[cos | sin]`` concatenated halves, fractional
  timesteps allowed; used by ``LatentUNet``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from infodiffusion_tpu_torch.nn.layers import Dense


def sinusoidal_table(T: int, d_model: int) -> torch.Tensor:
    """[T, d_model] f32 table with interleaved (sin, cos) pairs."""
    if d_model % 2:
        raise ValueError(f"d_model must be even, got {d_model}")
    freqs = torch.exp(
        -torch.arange(0, d_model, 2, dtype=torch.float32) / d_model
        * math.log(10000.0)
    )
    args = torch.arange(T, dtype=torch.float32)[:, None] * freqs[None, :]
    return torch.stack([torch.sin(args), torch.cos(args)], dim=-1).reshape(
        T, d_model
    )


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """``[cos | sin]`` embedding of (possibly fractional) timesteps ``t`` [B]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimeEmbedding(nn.Module):
    """Sinusoidal-table embedding + 2-layer MLP; ``t`` holds int indices [B]."""

    def __init__(self, T: int, d_model: int, dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # a constant, not a parameter: the Flax tree has no entry for it
        self.register_buffer(
            "table", sinusoidal_table(T, d_model), persistent=False
        )
        self.dense0 = Dense(d_model, dim, dtype)
        self.dense1 = Dense(dim, dim, dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = self.table[t].to(self.dtype)
        return self.dense1(torch.nn.functional.silu(self.dense0(emb)))
