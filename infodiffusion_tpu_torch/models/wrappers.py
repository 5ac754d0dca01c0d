"""Model wrappers (JAX counterpart: ``infodiffusion_tpu/models/wrappers.py``).

``InfoDiff`` holds the aux-conditioned backbone (eps prediction, the
samplers' entry point) and the ``Encoder``, with the training loss:
``train_forward`` re-noises x at random t, encodes the clean x and routes
``a`` or the reparametrised ``a_q`` to the backbone by the
regularizer-weight table; ``loss_fn`` adds the recon, MMD and KLD terms
with every quirk of the JAX package. ``Diff(is_latent=True)`` is the
latent prior. The non-latent ``Diff``, ``VAE`` and the bottleneck backbone
are not ported yet.

Random draws: ``t``, ``eps``, ``reparam_eps`` and ``prior_samples`` can be
injected (keyword-only, as in the JAX package); what is not injected is
drawn from the explicit generators in ``Rngs`` (the Flax rng streams
'noise', 'reparam' and 'dropout'), never from the global RNG.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from infodiffusion_tpu_torch.diffusion.schedule import make_schedule, q_sample
from infodiffusion_tpu_torch.models.latent_unet import LatentUNet
from infodiffusion_tpu_torch.models.unet import AuxiliaryUNet, Encoder
from infodiffusion_tpu_torch.ops.mmd import compute_mmd
from infodiffusion_tpu_torch.utils import gaussian_mixture, swiss_roll


class Rngs(NamedTuple):
    """The generators of one step's draws (Flax's rng streams)."""

    noise: Optional[torch.Generator] = None    # t, eps, prior samples
    reparam: Optional[torch.Generator] = None  # the encoder's posterior draw
    dropout: Optional[torch.Generator] = None  # dropout masks


def _stream(rngs: Optional[Rngs], name: str) -> torch.Generator:
    gen = getattr(rngs, name) if rngs is not None else None
    if gen is None:
        raise ValueError(f"a draw was neither injected nor given a "
                         f"'{name}' generator")
    return gen


def pick_ch_mult(model: str, input_size: int) -> Tuple[int, ...]:
    """The reference's ch_mult table: InfoDiff uses (1, 2, 2, 2), 28px
    (1, 2, 4); Diff/VAE use (1, 2, 4, 8)."""
    if input_size == 28:
        return (1, 2, 4)
    return (1, 2, 2, 2) if model == "diff" else (1, 2, 4, 8)


def _draw_prior(generator, prior: str, like: torch.Tensor) -> torch.Tensor:
    """Prior draws shaped and typed like ``like`` [B, d]."""
    B, d = like.shape
    if prior == "regular":
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=like.dtype)
    if prior == "10mix":
        return gaussian_mixture(generator, B, d,
                                device=like.device).to(like.dtype)
    if prior == "roll":
        return swiss_roll(generator, B, device=like.device).to(like.dtype)
    raise ValueError(prior)


def _kld_sum(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KLD summed over the batch (the InfoDiff convention)."""
    return (-0.5 * (1.0 + log_var - mu.square() - log_var.exp()).sum(1)).sum()


def _capacity(C_max: float, epochs: int, curr_epoch) -> torch.Tensor:
    """C = clamp(C_max * epoch / epochs, 0, C_max)."""
    c = torch.as_tensor(C_max, dtype=torch.float32) * curr_epoch / epochs
    return torch.clamp(c, 0.0, C_max)


class InfoDiff(nn.Module):
    """Auxiliary-variable diffusion model: an ``AuxiliaryUNet`` named
    ``backbone`` and an ``Encoder`` named ``encoder``, as in the Flax
    tree."""

    def __init__(self, T: int, a_dim: int, shape: Tuple[int, int, int],
                 unets_channels: int = 64, encoder_channels: int = 64,
                 beta1: float = 1e-5, betaT: float = 1e-2,
                 mmd_weight: float = 0.1, kld_weight: float = 0.0,
                 prior: str = "regular", use_C: bool = False,
                 C_max: float = 25.0, epochs: int = 20,
                 attn: Tuple[int, ...] = (2,),
                 ch_mult: Optional[Tuple[int, ...]] = None,
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.T, self.beta1, self.betaT = T, beta1, betaT
        self.mmd_weight, self.kld_weight = mmd_weight, kld_weight
        self.prior, self.use_C, self.C_max, self.epochs = (
            prior, use_C, C_max, epochs)
        ch_mult = ch_mult or pick_ch_mult("diff", shape[1])
        self.backbone = AuxiliaryUNet(
            T=T, a_dim=a_dim, ch=unets_channels, ch_mult=ch_mult, attn=attn,
            num_res_blocks=num_res_blocks, out_ch=shape[0], dtype=dtype,
        )
        self.encoder = Encoder(
            a_dim=a_dim, shape=shape, ch=encoder_channels, ch_mult=ch_mult,
            attn=attn, num_res_blocks=num_res_blocks, dtype=dtype,
        )
        self._scheds = {}

    def sched(self, device):
        """The f32 schedule on ``device`` (made once per device)."""
        key = torch.device(device)
        if key not in self._scheds:
            self._scheds[key] = make_schedule(self.beta1, self.betaT, self.T,
                                              device)
        return self._scheds[key]

    def forward(self, x: torch.Tensor, t: torch.Tensor, a: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """eps prediction on (already noised) NHWC x at timesteps t."""
        return self.backbone(x, t, a, deterministic=deterministic,
                             generator=generator)

    def encode(self, x, *, deterministic: bool = True, sample: bool = True,
               reparam_eps=None, generator=None):
        return self.encoder(x, deterministic=deterministic, sample=sample,
                            reparam_eps=reparam_eps, generator=generator)

    def _route_latent(self, a, a_q):
        """a vs a_q: a_q when both regularizers are on, a when both are
        off, else a under MMD and a_q under KLD."""
        if self.mmd_weight != 0 and self.kld_weight != 0:
            return a_q
        if self.mmd_weight == 0 and self.kld_weight == 0:
            return a
        return a if self.mmd_weight != 0 else a_q

    def train_forward(self, x, *, deterministic: bool = False, t=None,
                      eps=None, reparam_eps=None, rngs: Optional[Rngs] = None):
        """Random-t re-noising + encoding of the clean x. Returns
        (out, eps, a, mu, log_var)."""
        B = x.shape[0]
        if t is None:
            t = torch.randint(0, self.T, (B,), generator=_stream(rngs, "noise"),
                              device=x.device)
        if eps is None:
            eps = torch.randn(x.shape, generator=_stream(rngs, "noise"),
                              device=x.device, dtype=x.dtype)
        if reparam_eps is None:
            reparam_eps = torch.randn(
                (B, self.encoder.fc_mu.weight.shape[0]),
                generator=_stream(rngs, "reparam"), device=x.device,
                dtype=self.encoder.fc_mu.dtype)
        drop_gen = None if deterministic else _stream(rngs, "dropout")
        x_tilde = q_sample(self.sched(x.device), x, t, eps)
        a, a_q, mu, log_var = self.encoder(
            x, deterministic=deterministic, sample=True,
            reparam_eps=reparam_eps, generator=drop_gen)
        cond = self._route_latent(a, a_q)
        out = self.backbone(x_tilde, t, cond, deterministic=deterministic,
                            generator=drop_gen)
        return out, eps, a, mu, log_var

    def loss_fn(self, x, curr_epoch=0, *, deterministic: bool = False,
                t=None, eps=None, reparam_eps=None, prior_samples=None,
                rngs: Optional[Rngs] = None):
        """The training loss; returns (loss, aux) with the per-term values
        ``denoise``, ``recon`` and, when their weights are on, ``mmd`` and
        ``kld`` (f32 scalars)."""
        out, eps, a, mu, log_var = self.train_forward(
            x, deterministic=deterministic, t=t, eps=eps,
            reparam_eps=reparam_eps, rngs=rngs)
        f32 = torch.float32
        out32, eps32, x32 = out.to(f32), eps.to(f32), x.to(f32)
        loss_denoise = (out32 - eps32).square().mean()
        # the recon term re-estimates x0 from the *clean* x with the t=0
        # schedule entries, a reference quirk kept as written
        s = self.sched(x.device)
        x0_est = torch.sqrt(1.0 / s.alphas[0]) * (
            x32 - s.betas[0] / torch.sqrt(1.0 - s.alpha_bars[0]) * out32)
        loss_rec = (x0_est - x32).square().mean() / self.T
        loss = loss_denoise + loss_rec
        aux = {"denoise": loss_denoise, "recon": loss_rec}
        if self.mmd_weight != 0:
            # the MMD target is mu when KLD is on too, else the
            # deterministic a
            target = mu if self.kld_weight != 0 else a
            if prior_samples is None:
                prior_samples = _draw_prior(_stream(rngs, "noise"),
                                            self.prior, target)
            loss_mmd = compute_mmd(prior_samples.to(f32), target.to(f32))
            loss = loss + self.mmd_weight * loss_mmd
            aux["mmd"] = loss_mmd
        if self.kld_weight != 0:
            kld = _kld_sum(mu.to(f32), log_var.to(f32))
            if self.use_C:
                C = _capacity(self.C_max, self.epochs, curr_epoch).to(kld)
                loss = loss + self.kld_weight * (kld - C).abs()
            else:
                loss = loss + self.kld_weight * kld
            aux["kld"] = kld
        return loss, aux


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
