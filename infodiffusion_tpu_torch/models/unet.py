"""The aux-conditioned UNet (JAX counterpart: ``infodiffusion_tpu/models/unet.py``).

``_UNetSkeleton`` reproduces the JAX skeleton's channel bookkeeping and
module names: ``num_res_blocks`` down blocks per level with a skip pushed
after each, a skip after each DownSample, two middle blocks (attention on
the first), ``num_res_blocks + 1`` up blocks each popping a skip,
attention at the levels in ``attn``; one running counter names
``downblock_N`` / ``middleblock_N`` / ``upblock_N``. Only ``aux_mode='all'``
(``AuxiliaryUNet``) is ported.

Public layout is NHWC; inside, activations are NCHW in ``channels_last``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infodiffusion_tpu_torch.nn.blocks import (
    AuxResBlock,
    Conv3,
    DownSample,
    UpSample,
    _GNParams,
)
from infodiffusion_tpu_torch.nn.embeddings import TimeEmbedding
from infodiffusion_tpu_torch.nn.layers import Dense

TAIL_GAIN = 1e-5  # the tail conv's xavier gain


class _UNetSkeleton(nn.Module):
    """Down/middle/up skeleton of AuxResBlocks, conditioned everywhere."""

    def __init__(self, ch: int, ch_mult: Tuple[int, ...], out_ch: int,
                 emb_dim: int, attn: Tuple[int, ...] = (2,),
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        if not all(i < len(ch_mult) for i in attn):
            raise ValueError(f"attn levels {attn} out of range for {ch_mult}")
        self._plan = []  # (kind, module name) in execution order
        n = 0

        def block(kind, in_c, out_c, use_attn):
            nonlocal n
            name = f"{kind}block_{n}"
            n += 1
            self.add_module(
                name, AuxResBlock(in_c, out_c, emb_dim, use_attn, dtype)
            )
            self._plan.append((kind, name))

        self.head = Conv3(out_ch, ch, dtype)
        skips = [ch]
        now = ch
        for i, mult in enumerate(ch_mult):
            for _ in range(num_res_blocks):
                block("down", now, ch * mult, i in attn)
                now = ch * mult
                skips.append(now)
            if i != len(ch_mult) - 1:
                self.add_module(f"down_{i}", DownSample(now, dtype))
                self._plan.append(("resample", f"down_{i}"))
                skips.append(now)
        block("middle", now, now, True)
        block("middle", now, now, False)
        for i, mult in reversed(list(enumerate(ch_mult))):
            for _ in range(num_res_blocks + 1):
                block("up", now + skips.pop(), ch * mult, i in attn)
                now = ch * mult
            if i != 0:
                self.add_module(f"up_{i}", UpSample(now, dtype))
                self._plan.append(("resample", f"up_{i}"))
        self.tail_norm = _GNParams(now)
        self.tail_conv = Conv3(now, out_ch, dtype, gain=TAIL_GAIN)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                aemb: torch.Tensor) -> torch.Tensor:
        """x: NCHW (``channels_last``) -> NCHW."""
        h = self.head(x)
        hs = [h]
        for kind, name in self._plan:
            mod = getattr(self, name)
            if kind == "resample":
                h = mod(h)
                if name.startswith("down"):
                    hs.append(h)
            elif kind == "up":
                h = mod(torch.cat([h, hs.pop()], dim=1), temb, aemb)
            else:
                h = mod(h, temb, aemb)
                if kind == "down":
                    hs.append(h)
        return self.tail_conv(F.silu(self.tail_norm(h)))


class AuxiliaryUNet(nn.Module):
    """UNet fully conditioned on the aux latent ``a``."""

    def __init__(self, T: int, a_dim: int, ch: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 attn: Tuple[int, ...] = (2,), num_res_blocks: int = 2,
                 out_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        tdim = ch * 4
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.fc_a = Dense(a_dim, tdim, dtype)
        self.unet = _UNetSkeleton(ch, ch_mult, out_ch, tdim, attn,
                                  num_res_blocks, dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
        """x: NHWC [B, H, W, C]; t: int [B]; a: [B, a_dim] -> NHWC eps."""
        temb = self.time_embedding(t)
        aemb = self.fc_a(a)
        # an NHWC tensor permuted to NCHW is channels_last: no copy
        h = self.unet(x.permute(0, 3, 1, 2), temb, aemb)
        return h.permute(0, 2, 3, 1)
