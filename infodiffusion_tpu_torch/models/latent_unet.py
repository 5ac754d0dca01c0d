"""MLP skip-net denoiser for vector latents
(JAX counterpart: ``infodiffusion_tpu/models/latent_unet.py``).

``NUM_LAYERS`` layers over [B, a_dim]: layer 0 maps a_dim -> 4 a_dim,
layers >= 1 read ``[h, x]`` (hidden first, then the input), the last maps
back to a_dim with no norm, activation or conditioning. The conditioning is
the ``[cos | sin]`` timestep embedding (``TIME_EMB_CHANNELS``) through a
2-layer MLP. Layers 0 .. ``NUM_LAYERS - 2`` end in dropout (``DROPOUT``)
when ``deterministic=False``, as the JAX LatentUNet's do in training.
Depth and widths are the reference's, which the trajectory kernel's
packing (``ops/cuda/latent_mlp.py``) assumes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infodiffusion_tpu_torch.nn.blocks import MLPLNAct, apply_dropout, dropout
from infodiffusion_tpu_torch.nn.embeddings import timestep_embedding
from infodiffusion_tpu_torch.nn.layers import Dense

NUM_LAYERS = 10
TIME_EMB_CHANNELS = 64
DROPOUT = 0.1


class LatentUNet(nn.Module):
    """``shape`` is the latent pseudo-shape (1, a_dim, a_dim); only
    ``shape[-1]`` matters."""

    def __init__(self, T: int, shape: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = shape[-1]
        self.dtype = dtype
        self.time_embed_0 = Dense(TIME_EMB_CHANNELS, d, dtype)
        self.time_embed_1 = Dense(d, d, dtype)
        for i in range(NUM_LAYERS):
            last = i == NUM_LAYERS - 1
            self.add_module(f"layer_{i}", MLPLNAct(
                in_ch=d if i == 0 else 5 * d,
                out_ch=d if last else 4 * d,
                norm=not last, use_cond=not last, cond_ch=d,
                activation=None if last else "silu",
                condition_bias=1.0, dtype=dtype,
            ))

    def time_embed(self, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, TIME_EMB_CHANNELS).to(self.dtype)
        return self.time_embed_1(F.silu(self.time_embed_0(temb)))

    def layer(self, i: int, h: Optional[torch.Tensor], x: torch.Tensor,
              temb: torch.Tensor, deterministic: bool = True,
              generator: Optional[torch.Generator] = None,
              uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Layer ``i`` on the previous layer's ``h`` (layer 0: on ``x``).
        ``uniforms`` are the dropout draws made beforehand (the pipeline
        draws every layer's for the whole batch, ``parallel/pp.py``)."""
        h = x if i == 0 else torch.cat([h.to(x.dtype), x], dim=-1)
        h = getattr(self, f"layer_{i}")(h, temb)
        if i < NUM_LAYERS - 1:
            if uniforms is not None:
                return apply_dropout(h, DROPOUT, uniforms)
            h = dropout(h, DROPOUT, deterministic, generator)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        temb = self.time_embed(t)
        h = None
        for i in range(NUM_LAYERS):
            h = self.layer(i, h, x, temb, deterministic, generator)
        return h
