"""Model wrappers (JAX counterpart: ``infodiffusion_tpu/models/wrappers.py``).

Only eps prediction, the samplers' entry point, is ported: ``InfoDiff``
holds the aux-conditioned backbone and ``Diff(is_latent=True)`` the latent
prior. The Encoder, the losses and the non-latent ``Diff`` (a plain UNet)
come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from infodiffusion_tpu_torch.models.latent_unet import LatentUNet
from infodiffusion_tpu_torch.models.unet import AuxiliaryUNet


def pick_ch_mult(model: str, input_size: int) -> Tuple[int, ...]:
    """The reference's ch_mult table: InfoDiff uses (1, 2, 2, 2), 28px
    (1, 2, 4); Diff/VAE use (1, 2, 4, 8)."""
    if input_size == 28:
        return (1, 2, 4)
    return (1, 2, 2, 2) if model == "diff" else (1, 2, 4, 8)


class InfoDiff(nn.Module):
    """Auxiliary-variable diffusion model: eps prediction through an
    ``AuxiliaryUNet`` named ``backbone``, as in the Flax tree."""

    def __init__(self, T: int, a_dim: int, shape: Tuple[int, int, int],
                 unets_channels: int = 64, attn: Tuple[int, ...] = (2,),
                 ch_mult: Optional[Tuple[int, ...]] = None,
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = AuxiliaryUNet(
            T=T, a_dim=a_dim, ch=unets_channels,
            ch_mult=ch_mult or pick_ch_mult("diff", shape[1]), attn=attn,
            num_res_blocks=num_res_blocks, out_ch=shape[0], dtype=dtype,
        )

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                a: torch.Tensor) -> torch.Tensor:
        """eps prediction on (already noised) NHWC x at timesteps t."""
        return self.backbone(x, t, a)


class Diff(nn.Module):
    """The JAX ``Diff(is_latent=True)``, the latent DDPM: eps prediction
    through a ``LatentUNet`` named ``backbone``. The image form (a plain
    UNet) is not ported."""

    def __init__(self, T: int, shape: Tuple[int, int, int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = LatentUNet(T=T, shape=shape, dtype=dtype)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.backbone(x, t)
