"""Model wrappers (JAX counterpart: ``infodiffusion_tpu/models/wrappers.py``).

``InfoDiff`` holds the aux-conditioned backbone (eps prediction, the
samplers' entry point; ``AuxiliaryUNet``, or ``BottleneckAuxUNet`` with
``is_bottleneck``) and the ``Encoder``, with the training loss:
``train_forward`` re-noises x at random t, encodes the clean x and routes
``a`` or the reparametrised ``a_q`` to the backbone by the
regularizer-weight table; ``loss_fn`` adds the recon, MMD and KLD terms
with every quirk of the JAX package. ``Diff`` is the unconditional DDPM:
the vanilla image model (a ``UNet``) or, with ``is_latent``, the latent
prior (a ``LatentUNet``). ``VAE`` is the Encoder/Decoder baseline.
``build_model`` picks one from a ``Config`` and puts it on the card.

Random draws: ``t``, ``eps``, ``reparam_eps`` and ``prior_samples`` can be
injected (keyword-only, as in the JAX package); what is not injected is
drawn from the explicit generators in ``Rngs`` (the Flax rng streams
'noise', 'reparam' and 'dropout'), never from the global RNG.

Under data parallelism (``parallel/batch.py``'s ``batch_scope``) each rank
holds its rows of the global batch: the draws are made for the global
batch and the rank keeps its rows, the batch means and sums are global,
and the MMD gathers its target latents, so every rank computes the
one-process loss.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from infodiffusion_tpu_torch.diffusion.schedule import make_schedule, q_sample
from infodiffusion_tpu_torch.models.latent_unet import LatentUNet
from infodiffusion_tpu_torch.models.unet import (
    AuxiliaryUNet,
    BottleneckAuxUNet,
    Decoder,
    Encoder,
    UNet,
)
from infodiffusion_tpu_torch.nn.blocks import dropout
from infodiffusion_tpu_torch.nn.initializers import lecun_normal_
from infodiffusion_tpu_torch.nn.layers import Dense
from infodiffusion_tpu_torch.ops.mmd import compute_mmd
from infodiffusion_tpu_torch.parallel.batch import (
    batch_mean,
    batch_sum,
    draw_rows,
    gather_batch,
)
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


def _draw_t(T: int, x: torch.Tensor, rngs) -> torch.Tensor:
    gen = _stream(rngs, "noise")
    return draw_rows(lambda n: torch.randint(0, T, (n,), generator=gen,
                                             device=x.device), x.shape[0])


def _draw_eps(x: torch.Tensor, rngs) -> torch.Tensor:
    gen = _stream(rngs, "noise")
    return draw_rows(lambda n: torch.randn(
        (n,) + tuple(x.shape[1:]), generator=gen, device=x.device,
        dtype=x.dtype), x.shape[0])


def _draw_reparam(encoder, x: torch.Tensor, rngs) -> torch.Tensor:
    gen = _stream(rngs, "reparam")
    return draw_rows(lambda n: torch.randn(
        (n, encoder.fc_mu.weight.shape[0]), generator=gen, device=x.device,
        dtype=encoder.fc_mu.dtype), x.shape[0])


def _kld_sum(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KLD summed over the batch (the InfoDiff convention)."""
    return (-0.5 * (1.0 + log_var - mu.square() - log_var.exp()).sum(1)).sum()


def _kld_mean(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KLD meaned over the batch (the VAE convention)."""
    return batch_mean(-0.5 * (1.0 + log_var - mu.square() - log_var.exp())
                      .sum(1))


def _capacity(C_max: float, epochs: int, curr_epoch) -> torch.Tensor:
    """C = clamp(C_max * epoch / epochs, 0, C_max)."""
    c = torch.as_tensor(C_max, dtype=torch.float32) * curr_epoch / epochs
    return torch.clamp(c, 0.0, C_max)


class _Scheduled(nn.Module):
    """A wrapper that owns a diffusion schedule (``T``, ``beta1``,
    ``betaT``, set by the subclass)."""

    def sched(self, device):
        """The f32 schedule on ``device`` (made once per device)."""
        key = torch.device(device)
        if key not in self._scheds:
            self._scheds[key] = make_schedule(self.beta1, self.betaT, self.T,
                                              device)
        return self._scheds[key]


class InfoDiff(_Scheduled):
    """Auxiliary-variable diffusion model: an ``AuxiliaryUNet`` (or, with
    ``is_bottleneck``, a ``BottleneckAuxUNet``) named ``backbone`` and an
    ``Encoder`` named ``encoder``, as in the Flax tree."""

    def __init__(self, T: int, a_dim: int, shape: Tuple[int, int, int],
                 unets_channels: int = 64, encoder_channels: int = 64,
                 beta1: float = 1e-5, betaT: float = 1e-2,
                 mmd_weight: float = 0.1, kld_weight: float = 0.0,
                 is_bottleneck: bool = False,
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
        backbone = BottleneckAuxUNet if is_bottleneck else AuxiliaryUNet
        self.backbone = backbone(
            T=T, a_dim=a_dim, ch=unets_channels, ch_mult=ch_mult, attn=attn,
            num_res_blocks=num_res_blocks, out_ch=shape[0], dtype=dtype,
        )
        self.encoder = Encoder(
            a_dim=a_dim, shape=shape, ch=encoder_channels, ch_mult=ch_mult,
            attn=attn, num_res_blocks=num_res_blocks, dtype=dtype,
        )
        self._scheds = {}

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
        if t is None:
            t = _draw_t(self.T, x, rngs)
        if eps is None:
            eps = _draw_eps(x, rngs)
        if reparam_eps is None:
            reparam_eps = _draw_reparam(self.encoder, x, rngs)
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
        loss_denoise = batch_mean((out32 - eps32).square())
        # the recon term re-estimates x0 from the *clean* x with the t=0
        # schedule entries, a reference quirk kept as written
        s = self.sched(x.device)
        x0_est = torch.sqrt(1.0 / s.alphas[0]) * (
            x32 - s.betas[0] / torch.sqrt(1.0 - s.alpha_bars[0]) * out32)
        loss_rec = batch_mean((x0_est - x32).square()) / self.T
        loss = loss_denoise + loss_rec
        aux = {"denoise": loss_denoise, "recon": loss_rec}
        if self.mmd_weight != 0:
            # the MMD target is mu when KLD is on too, else the
            # deterministic a
            target = gather_batch(mu if self.kld_weight != 0 else a)
            if prior_samples is None:
                prior_samples = _draw_prior(_stream(rngs, "noise"),
                                            self.prior, target)
            loss_mmd = compute_mmd(prior_samples.to(f32), target.to(f32))
            loss = loss + self.mmd_weight * loss_mmd
            aux["mmd"] = loss_mmd
        if self.kld_weight != 0:
            kld = batch_sum(_kld_sum(mu.to(f32), log_var.to(f32)))
            if self.use_C:
                C = _capacity(self.C_max, self.epochs, curr_epoch).to(kld)
                loss = loss + self.kld_weight * (kld - C).abs()
            else:
                loss = loss + self.kld_weight * kld
            aux["kld"] = kld
        return loss, aux


class Diff(_Scheduled):
    """The unconditional DDPM, eps prediction through a backbone named
    ``backbone``: a ``UNet`` over images (the vanilla model, ch_mult from
    the reference's table for 'vanilla'), or with ``is_latent`` a
    ``LatentUNet`` over [B, a_dim] latents (the latent prior)."""

    def __init__(self, T: int, shape: Tuple[int, int, int],
                 unets_channels: int = 64, beta1: float = 1e-5,
                 betaT: float = 1e-2, is_latent: bool = False,
                 attn: Tuple[int, ...] = (2,),
                 ch_mult: Optional[Tuple[int, ...]] = None,
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.T, self.beta1, self.betaT = T, beta1, betaT
        self.dtype = dtype
        self.is_latent = is_latent
        if is_latent:
            self.backbone = LatentUNet(T=T, shape=shape, dtype=dtype)
        else:
            self.backbone = UNet(
                T=T, ch=unets_channels,
                ch_mult=ch_mult or pick_ch_mult("vanilla", shape[1]),
                attn=attn, num_res_blocks=num_res_blocks, out_ch=shape[0],
                dtype=dtype)
        self._scheds = {}

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.backbone(x, t, deterministic=deterministic,
                             generator=generator)

    def train_forward(self, x, *, deterministic: bool = False, t=None,
                      eps=None, rngs: Optional[Rngs] = None):
        """Random-t re-noising of x (image [B, H, W, C] or latent [B, d]);
        returns (out, eps)."""
        if t is None:
            t = _draw_t(self.T, x, rngs)
        if eps is None:
            eps = _draw_eps(x, rngs)
        x_tilde = q_sample(self.sched(x.device), x, t, eps)
        drop_gen = None if deterministic else _stream(rngs, "dropout")
        return self(x_tilde, t, deterministic=deterministic,
                    generator=drop_gen), eps

    def loss_fn(self, x, curr_epoch=0, *, deterministic: bool = False,
                t=None, eps=None, rngs: Optional[Rngs] = None):
        """eps-MSE only; returns (loss, {"denoise": loss})."""
        out, eps = self.train_forward(x, deterministic=deterministic, t=t,
                                      eps=eps, rngs=rngs)
        f32 = torch.float32
        loss = batch_mean((out.to(f32) - eps.to(f32)).square())
        return loss, {"denoise": loss}


class VAE(nn.Module):
    """VAE / beta-VAE / InfoVAE, switched by the regularizer weights: an
    ``Encoder`` named ``encoder`` and a ``Decoder`` named ``decoder``."""

    def __init__(self, a_dim: int, shape: Tuple[int, int, int],
                 encoder_channels: int = 64, mmd_weight: float = 0.1,
                 kld_weight: float = 0.0, use_C: bool = False,
                 C_max: float = 25.0, epochs: int = 20,
                 attn: Tuple[int, ...] = (2,),
                 ch_mult: Optional[Tuple[int, ...]] = None,
                 num_res_blocks: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mmd_weight, self.kld_weight = mmd_weight, kld_weight
        self.use_C, self.C_max, self.epochs = use_C, C_max, epochs
        kw = dict(a_dim=a_dim, shape=shape, ch=encoder_channels,
                  ch_mult=ch_mult or pick_ch_mult("vae", shape[1]), attn=attn,
                  num_res_blocks=num_res_blocks, dtype=dtype)
        self.encoder = Encoder(**kw)
        self.decoder = Decoder(**kw)

    def encode(self, x, *, deterministic: bool = True, sample: bool = True,
               reparam_eps=None, generator=None):
        return self.encoder(x, deterministic=deterministic, sample=sample,
                            reparam_eps=reparam_eps, generator=generator)

    def decode(self, a, *, deterministic: bool = True, generator=None):
        """[B, a_dim] -> NHWC images."""
        return self.decoder(a, deterministic=deterministic,
                            generator=generator)

    def forward(self, x, *, deterministic: bool = True, reparam_eps=None,
                rngs: Optional[Rngs] = None):
        """Returns (reconstruction, a_q, mu, log_var); decodes ``a`` when no
        regularizer is on, else ``a_q``."""
        if reparam_eps is None:
            reparam_eps = _draw_reparam(self.encoder, x, rngs)
        drop_gen = None if deterministic else _stream(rngs, "dropout")
        a, a_q, mu, log_var = self.encoder(
            x, deterministic=deterministic, reparam_eps=reparam_eps,
            generator=drop_gen)
        z = a if (self.mmd_weight == 0 and self.kld_weight == 0) else a_q
        rec = self.decoder(z, deterministic=deterministic, generator=drop_gen)
        return rec, a_q, mu, log_var

    def loss_fn(self, x, curr_epoch=0, *, deterministic: bool = False,
                reparam_eps=None, prior_samples=None,
                rngs: Optional[Rngs] = None):
        """Recon MSE + MMD(N(0, I), a_q) or the batch-mean KLD (the VAE's
        MMD always draws a regular Gaussian prior and targets a_q)."""
        rec, a_q, mu, log_var = self(x, deterministic=deterministic,
                                     reparam_eps=reparam_eps, rngs=rngs)
        f32 = torch.float32
        loss = batch_mean((rec.to(f32) - x.to(f32)).square())
        aux = {"recon": loss}
        if self.mmd_weight != 0:
            target = gather_batch(a_q)
            if prior_samples is None:
                prior_samples = torch.randn(
                    target.shape, generator=_stream(rngs, "noise"),
                    device=a_q.device, dtype=f32)
            loss_mmd = compute_mmd(prior_samples.to(f32), target.to(f32))
            loss = loss + self.mmd_weight * loss_mmd
            aux["mmd"] = loss_mmd
        elif self.kld_weight != 0:
            kld = _kld_mean(mu.to(f32), log_var.to(f32))
            if self.use_C:
                C = _capacity(self.C_max, self.epochs, curr_epoch).to(kld)
                loss = loss + self.kld_weight * (kld - C).abs()
            else:
                loss = loss + self.kld_weight * kld
            aux["kld"] = kld
        return loss, aux


class FeatureClassifier(nn.Module):
    """The attribute probe of ``--mode attr_classification``: Dense 512,
    ReLU, Dropout 0.5, Dense 128, ReLU, Dropout 0.5, Dense ``output_dim``,
    sigmoid. The layers carry the Flax names (``Dense_0`` .. ``Dense_2``)
    and Flax's ``nn.Dense`` initializers (lecun normal, zero bias), drawn
    from ``generator``; the dropout masks come from the generator passed to
    ``forward``."""

    def __init__(self, in_features: int, output_dim: int = 40,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = (in_features, 512, 128, output_dim)
        for i in range(3):
            layer = Dense(widths[i], widths[i + 1])
            with torch.no_grad():
                lecun_normal_(layer.weight, generator)
            setattr(self, f"Dense_{i}", layer)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = dropout(torch.relu(self.Dense_0(x)), 0.5, deterministic, generator)
        x = dropout(torch.relu(self.Dense_1(x)), 0.5, deterministic, generator)
        return torch.sigmoid(self.Dense_2(x))


def _parse_ints(v) -> Optional[Tuple[int, ...]]:
    if v is None or v == "":
        return None
    if isinstance(v, (tuple, list)):
        return tuple(int(i) for i in v)
    return tuple(int(i) for i in str(v).split(","))


def build_model(cfg, *, latent: bool = False,
                dtype: Optional[torch.dtype] = None, device=None):
    """The wrapper ``cfg.model`` selects (the latent prior with
    ``latent``), in ``dtype`` (default: bf16 when ``cfg.bf16``, else f32),
    on ``device``. The default device is the card; with no card and no
    ``device`` it raises (pass ``device='cpu'`` for the plain versions).
    ``cfg.ch_mult``/``cfg.attn`` override the reference's table."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model puts the model on the card and "
                               "no CUDA device is visible; pass device='cpu' "
                               "to build it on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    if dtype is None:
        dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    shape = cfg.latent_shape if latent else cfg.shape
    ch_mult = _parse_ints(cfg.ch_mult)
    attn = _parse_ints(cfg.attn) or (2,)
    if latent or cfg.model == "vanilla":
        model = Diff(
            T=cfg.diffusion_steps, shape=shape,
            unets_channels=cfg.unets_channels, beta1=cfg.beta1,
            betaT=cfg.betaT, is_latent=latent or cfg.is_latent, attn=attn,
            ch_mult=ch_mult, dtype=dtype)
    elif cfg.model == "diff":
        model = InfoDiff(
            T=cfg.diffusion_steps, a_dim=cfg.a_dim, shape=shape,
            unets_channels=cfg.unets_channels,
            encoder_channels=cfg.encoder_channels, beta1=cfg.beta1,
            betaT=cfg.betaT, mmd_weight=cfg.mmd_weight,
            kld_weight=cfg.kld_weight, is_bottleneck=cfg.is_bottleneck,
            prior=cfg.prior, use_C=cfg.use_C, C_max=cfg.C_max,
            epochs=cfg.epochs, attn=attn, ch_mult=ch_mult, dtype=dtype)
    elif cfg.model == "vae":
        model = VAE(
            a_dim=cfg.a_dim, shape=shape,
            encoder_channels=cfg.encoder_channels,
            mmd_weight=cfg.mmd_weight, kld_weight=cfg.kld_weight,
            use_C=cfg.use_C, C_max=cfg.C_max, epochs=cfg.epochs, attn=attn,
            ch_mult=ch_mult, dtype=dtype)
    else:
        raise ValueError(cfg.model)
    return model.to(device)
