"""UNet backbones, the Encoder and the Decoder
(JAX counterpart: ``infodiffusion_tpu/models/unet.py``).

``_UNetSkeleton`` reproduces the JAX skeleton's channel bookkeeping and
module names: ``num_res_blocks`` down blocks per level with a skip pushed
after each, a skip after each DownSample, two middle blocks (attention on
the first), ``num_res_blocks + 1`` up blocks each popping a skip,
attention at the levels in ``attn``; one running counter names
``downblock_N`` / ``middleblock_N`` / ``upblock_N``; an up block gets
the skip concat as the pieces ``(h, skip)``. ``aux_mode`` picks the block
at each position:

- ``'none'``: ResBlocks (time FiLM), ``UNet``, the vanilla Diff's backbone;
- ``'all'``: AuxResBlocks (time and aux FiLMs), ``AuxiliaryUNet``;
- ``'bottleneck'``: AuxResBlocks in the two middle blocks, ResBlocks
  elsewhere, ``BottleneckAuxUNet``;
- ``'encoder'``: unconditioned EncoderResBlocks, ``Encoder`` and
  ``Decoder``.

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
    ResBlock,
    UpSample,
    _GNParams,
)
from infodiffusion_tpu_torch.nn.embeddings import TimeEmbedding
from infodiffusion_tpu_torch.nn.initializers import (
    kaiming_normal_relu_,
    lecun_normal_,
)
from infodiffusion_tpu_torch.nn.layers import Dense

TAIL_GAIN = 1e-5  # the tail conv's xavier gain


AUX_MODES = ("none", "all", "bottleneck", "encoder")


class _UNetSkeleton(nn.Module):
    """Down/middle/up skeleton; ``aux_mode`` picks each position's block
    (see the module docstring)."""

    def __init__(self, ch: int, ch_mult: Tuple[int, ...], out_ch: int,
                 emb_dim: int = 0, attn: Tuple[int, ...] = (2,),
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32,
                 aux_mode: str = "all", in_ch: Optional[int] = None):
        super().__init__()
        if not all(i < len(ch_mult) for i in attn):
            raise ValueError(f"attn levels {attn} out of range for {ch_mult}")
        if aux_mode not in AUX_MODES:
            raise ValueError(f"aux_mode must be one of {AUX_MODES}, got "
                             f"{aux_mode!r}")
        self._plan = []  # (kind, module name, conditioning) in order
        n = 0

        def block(kind, in_c, out_c, use_attn):
            nonlocal n
            name = f"{kind}block_{n}"
            n += 1
            up = kind == "up"
            if aux_mode == "encoder":
                mod, cond = EncoderResBlock(in_c, out_c, use_attn, dtype,
                                            up), "none"
            elif aux_mode == "all" or (aux_mode == "bottleneck"
                                       and kind == "middle"):
                mod, cond = AuxResBlock(in_c, out_c, emb_dim, use_attn, dtype,
                                        up), "aux"
            else:
                mod, cond = ResBlock(in_c, out_c, emb_dim, use_attn, dtype,
                                     up), "time"
            self.add_module(name, mod)
            self._plan.append((kind, name, cond))

        # the image head and tail stay in the model dtype in the int8 tier
        self.head = Conv3(in_ch or out_ch, ch, dtype, quantize=False)
        skips = [ch]
        now = ch
        for i, mult in enumerate(ch_mult):
            for _ in range(num_res_blocks):
                block("down", now, ch * mult, i in attn)
                now = ch * mult
                skips.append(now)
            if i != len(ch_mult) - 1:
                self.add_module(f"down_{i}", DownSample(now, dtype))
                self._plan.append(("resample", f"down_{i}", None))
                skips.append(now)
        block("middle", now, now, True)
        block("middle", now, now, False)
        for i, mult in reversed(list(enumerate(ch_mult))):
            for _ in range(num_res_blocks + 1):
                block("up", now + skips.pop(), ch * mult, i in attn)
                now = ch * mult
            if i != 0:
                self.add_module(f"up_{i}", UpSample(now, dtype))
                self._plan.append(("resample", f"up_{i}", None))
        self.tail_norm = _GNParams(now)
        self.tail_conv = Conv3(now, out_ch, dtype, gain=TAIL_GAIN,
                               quantize=False)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                aemb: Optional[torch.Tensor] = None, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NCHW (``channels_last``) -> NCHW. ``temb`` conditions the
        ResBlocks and AuxResBlocks, ``aemb`` the AuxResBlocks."""
        conds = {"none": (), "time": (temb,), "aux": (temb, aemb)}
        h = self.head(x)
        hs = [h]
        for kind, name, cond in self._plan:
            mod = getattr(self, name)
            if kind == "resample":
                h = mod(h)
                if name.startswith("down"):
                    hs.append(h)
                continue
            if kind == "up":  # the block concatenates the pieces
                h = (h, hs.pop())
            h = mod(h, *conds[cond], deterministic, generator)
            if kind == "down":
                hs.append(h)
        return self.tail_conv(F.silu(self.tail_norm(h)))


class UNet(nn.Module):
    """The vanilla DDPM UNet: time conditioning only."""

    def __init__(self, T: int, ch: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 attn: Tuple[int, ...] = (2,), num_res_blocks: int = 2,
                 out_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        tdim = ch * 4
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.unet = _UNetSkeleton(ch, ch_mult, out_ch, tdim, attn,
                                  num_res_blocks, dtype, aux_mode="none")

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NHWC [B, H, W, C]; t: int [B] -> NHWC eps."""
        h = self.unet(x.permute(0, 3, 1, 2), self.time_embedding(t),
                      deterministic=deterministic, generator=generator)
        return h.permute(0, 2, 3, 1)


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


class BottleneckAuxUNet(nn.Module):
    """Aux conditioning in the two middle blocks only; ``fc_a`` is a Dense
    over ``silu(a)`` with Kaiming-normal init."""

    def __init__(self, T: int, a_dim: int, ch: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 attn: Tuple[int, ...] = (2,), num_res_blocks: int = 2,
                 out_ch: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        tdim = ch * 4
        self.time_embedding = TimeEmbedding(T, ch, tdim, dtype)
        self.fc_a = Dense(a_dim, tdim, dtype)
        kaiming_normal_relu_(self.fc_a.weight.data)
        self.unet = _UNetSkeleton(ch, ch_mult, out_ch, tdim, attn,
                                  num_res_blocks, dtype, aux_mode="bottleneck")

    def forward(self, x: torch.Tensor, t: torch.Tensor, a: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NHWC [B, H, W, C]; t: int [B]; a: [B, a_dim] -> NHWC eps."""
        h = self.unet(x.permute(0, 3, 1, 2), self.time_embedding(t),
                      self.fc_a(F.silu(a)), deterministic=deterministic,
                      generator=generator)
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


class Decoder(nn.Module):
    """``fc_a`` a_dim -> C*H*W, reshaped NHWC [B, H, W, C] as the JAX
    package does (then viewed NCHW), decoded by an unconditioned UNet
    skeleton to an NHWC image."""

    def __init__(self, a_dim: int, shape: Tuple[int, int, int], ch: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 4, 8),
                 attn: Tuple[int, ...] = (2,), num_res_blocks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shape = shape
        c, h, w = shape
        self.fc_a = Dense(a_dim, c * h * w, dtype)
        lecun_normal_(self.fc_a.weight.data)
        self.unet = _UNetSkeleton(ch, ch_mult, c, attn=attn,
                                  num_res_blocks=num_res_blocks, dtype=dtype,
                                  aux_mode="encoder", in_ch=c)

    def forward(self, a: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        c, h, w = self.shape
        z = self.fc_a(a).reshape(a.shape[0], h, w, c)
        out = self.unet(z.permute(0, 3, 1, 2), deterministic=deterministic,
                        generator=generator)
        return out.permute(0, 2, 3, 1)
