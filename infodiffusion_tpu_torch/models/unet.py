"""The aux-conditioned UNet and the Encoder
(JAX counterpart: ``infodiffusion_tpu/models/unet.py``).

``_UNetSkeleton`` reproduces the JAX skeleton's channel bookkeeping and
module names: ``num_res_blocks`` down blocks per level with a skip pushed
after each, a skip after each DownSample, two middle blocks (attention on
the first), ``num_res_blocks + 1`` up blocks each popping a skip,
attention at the levels in ``attn``; one running counter names
``downblock_N`` / ``middleblock_N`` / ``upblock_N``. Two ``aux_mode``s
are ported: ``'all'`` (AuxResBlocks, ``AuxiliaryUNet``) and ``'encoder'``
(EncoderResBlocks, ``Encoder``).

Public layout is NHWC; inside, activations are NCHW in ``channels_last``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from infodiffusion_tpu_torch.nn.blocks import (
    AuxResBlock,
    Conv3,
    DownSample,
    EncoderResBlock,
    UpSample,
    _GNParams,
)
from infodiffusion_tpu_torch.nn.embeddings import TimeEmbedding
from infodiffusion_tpu_torch.nn.layers import Dense

TAIL_GAIN = 1e-5  # the tail conv's xavier gain


class _UNetSkeleton(nn.Module):
    """Down/middle/up skeleton: AuxResBlocks conditioned everywhere
    (``aux_mode='all'``) or unconditioned EncoderResBlocks
    (``aux_mode='encoder'``)."""

    def __init__(self, ch: int, ch_mult: Tuple[int, ...], out_ch: int,
                 emb_dim: int = 0, attn: Tuple[int, ...] = (2,),
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32,
                 aux_mode: str = "all", in_ch: Optional[int] = None):
        super().__init__()
        if not all(i < len(ch_mult) for i in attn):
            raise ValueError(f"attn levels {attn} out of range for {ch_mult}")
        if aux_mode not in ("all", "encoder"):
            raise ValueError(f"aux_mode {aux_mode!r} is not ported")
        self.aux_mode = aux_mode
        self._plan = []  # (kind, module name) in execution order
        n = 0

        def block(kind, in_c, out_c, use_attn):
            nonlocal n
            name = f"{kind}block_{n}"
            n += 1
            self.add_module(name, (
                AuxResBlock(in_c, out_c, emb_dim, use_attn, dtype)
                if aux_mode == "all"
                else EncoderResBlock(in_c, out_c, use_attn, dtype)))
            self._plan.append((kind, name))

        self.head = Conv3(in_ch or out_ch, ch, dtype)
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

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                aemb: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NCHW (``channels_last``) -> NCHW. ``temb``/``aemb`` condition
        the AuxResBlocks (unused by the Encoder's blocks)."""
        cond = (temb, aemb) if self.aux_mode == "all" else ()
        h = self.head(x)
        hs = [h]
        for kind, name in self._plan:
            mod = getattr(self, name)
            if kind == "resample":
                h = mod(h)
                if name.startswith("down"):
                    hs.append(h)
                continue
            if kind == "up":
                h = torch.cat([h, hs.pop()], dim=1)
            h = mod(h, *cond, deterministic, generator)
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

    def forward(self, x: torch.Tensor, t: torch.Tensor, a: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NHWC [B, H, W, C]; t: int [B]; a: [B, a_dim] -> NHWC eps."""
        temb = self.time_embedding(t)
        aemb = self.fc_a(a)
        # an NHWC tensor permuted to NCHW is channels_last: no copy
        h = self.unet(x.permute(0, 3, 1, 2), temb, aemb,
                      deterministic=deterministic, generator=generator)
        return h.permute(0, 2, 3, 1)


class Encoder(nn.Module):
    """Full-UNet encoder -> 1-channel tail -> flatten -> ``fc_a`` ->
    (``fc_mu``, ``fc_var``), with the reparametrised draw inside forward
    like the reference. Returns (a, a_q, mu, log_var); the deterministic
    ``a`` is the pre-mu projection. ``reparam_eps`` injects the standard
    normal draw; otherwise ``generator`` makes it."""

    def __init__(self, a_dim: int, shape: Tuple[int, int, int], ch: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 8, 8),
                 attn: Tuple[int, ...] = (2,), num_res_blocks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, w = shape
        self.unet = _UNetSkeleton(ch, ch_mult, 1, attn=attn,
                                  num_res_blocks=num_res_blocks, dtype=dtype,
                                  aux_mode="encoder", in_ch=c)
        # the 1-channel tail flattened: [B, H * W]
        self.fc_a = Dense(h * w, a_dim, dtype)
        self.fc_mu = Dense(a_dim, a_dim, dtype)
        self.fc_var = Dense(a_dim, a_dim, dtype)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                sample: bool = True, reparam_eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC [B, H, W, C]."""
        h = self.unet(x.permute(0, 3, 1, 2), deterministic=deterministic,
                      generator=generator)
        a = self.fc_a(h.reshape(h.shape[0], -1))
        mu = self.fc_mu(a)
        log_var = self.fc_var(a)
        if not sample:
            return a, mu, mu, log_var
        if reparam_eps is None:
            reparam_eps = torch.randn(mu.shape, generator=generator,
                                      device=mu.device, dtype=mu.dtype)
        a_q = mu + reparam_eps.to(mu.dtype) * torch.exp(0.5 * log_var)
        return a, a_q, mu, log_var
