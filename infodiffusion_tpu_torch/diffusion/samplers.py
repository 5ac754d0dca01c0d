"""Samplers (JAX counterpart: ``infodiffusion_tpu/diffusion/samplers.py``).

The JAX package compiles a whole trajectory into one ``lax.scan``; here a
trajectory is a Python loop of eager steps, except the latent one, which
runs as one kernel launch (K4, ``ops/cuda/latent_traj.py``).

- ``sample_loop``: DDPM ancestral / stochastic DDIM (eta 0.01) over the
  full T grid.
- ``strided_ddim_loop``: DDIM-N on the evenly spaced subgrid, walked down
  to t_prev = -1.
- ``DiffusionProcess``: the image sampler's ``sampling`` path (no mesh),
  with the int8 turbo tier (``turbo='int8'``: W8A8 UNet conv bodies).
- ``LatentDiffusionProcess``: sampling and reverse sampling of the latent
  prior through the trajectory kernel; ``turbo='int8'`` streams int8
  weights.

``eps_fn(x, t, a)`` takes an int64 ``t`` [B]; random draws come from an
explicit ``torch.Generator`` on the device, or are injected with
``noises=`` (tests hand both implementations the same numbers).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from infodiffusion_tpu_torch.diffusion.schedule import (
    Schedule,
    ddim_step,
    ddpm_step,
    make_schedule,
    strided_ddim_step,
)
from infodiffusion_tpu_torch.ops import quant as q8
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.latent_traj import (
    latent_trajectory,
    quantize_packed_weights,
)


def _full_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return idx.expand(x.shape[0])


def sample_loop(
    eps_fn: Callable,
    sched: Schedule,
    xT: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    a: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = False,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-grid reverse diffusion; ``deterministic`` selects stochastic
    DDIM (eta 0.01), else DDPM. ``noises`` [T, *xT.shape] injects the
    per-step draws, ``noises[i]`` at timestep T-1-i."""
    x = xT
    idxs = torch.arange(sched.T - 1, -1, -1, device=xT.device)
    for i in range(sched.T):
        idx = idxs[i]
        eps = eps_fn(x, _full_t(x, idx), a)
        noise = (noises[i] if noises is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype))
        if deterministic:
            x = ddim_step(sched, x, idx, eps, noise)
        else:
            noise = torch.where(idx == 0, torch.zeros_like(noise), noise)
            x = ddpm_step(sched, x, idx, eps, noise)
    return x


def strided_timesteps(T: int, num_steps: int, device=None):
    """The DDIM-N grid: ``num_steps`` evenly spaced points of 0..T-1 walked
    from high noise, and the step targets, ending at -1 (x0)."""
    ts = torch.linspace(0, T - 1, num_steps, dtype=torch.float32)
    ts = ts.round().to(torch.int64).flip(0)
    ts_prev = torch.cat([ts[1:], torch.tensor([-1])])
    return ts.to(device), ts_prev.to(device)


def strided_ddim_loop(
    eps_fn: Callable,
    sched: Schedule,
    xT: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    a: Optional[torch.Tensor] = None,
    *,
    num_steps: int = 100,
    eta: float = 0.0,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fast DDIM-N over the subsampled grid. With eta 0 (the default) the
    trajectory draws nothing; otherwise ``noises`` [num_steps, *xT.shape]
    injects the draws, or ``generator`` makes them."""
    x = xT
    ts, ts_prev = strided_timesteps(sched.T, num_steps, xT.device)
    for i in range(num_steps):
        t, t_prev = ts[i], ts_prev[i]
        eps = eps_fn(x, _full_t(x, t), a)
        if eta == 0.0:
            noise = torch.zeros_like(x)
        else:
            noise = (noises[i] if noises is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype))
            noise = torch.where(t_prev < 0, torch.zeros_like(noise), noise)
        x = strided_ddim_step(sched, x, t, t_prev, eps, noise, eta=eta)
    return x


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _resolve_turbo(cfg, turbo: Optional[str]) -> str:
    """The turbo tier: the argument, else ``cfg.turbo``, else
    ``INFODIFF_TURBO``. '' falls through; 'off' stops the fall-through.
    Returns '' or a ported tier; 'int8x' and unknown names raise."""
    mode = turbo if turbo is not None else (
        getattr(cfg, "turbo", "") or q8.turbo_mode())
    if mode in ("", "off"):
        return ""
    q8.check_mode(mode)
    return mode


class DiffusionProcess:
    """The image sampler. ``model`` is a port ``InfoDiff``, conditioned on
    ``a`` (the unconditional image Diff is not ported); ``sampling`` draws
    xT ~ N(0, I), and a ~ N(0, I) when not given, from ``generator``. The
    carry stays f32 whatever the model's dtype.

    ``turbo='int8'`` (or ``cfg.turbo``, or ``INFODIFF_TURBO``) calibrates
    the activation scales once, here (``ops.quant.calibrate``), and the
    UNet's conv bodies then run W8A8. The process keeps the quant state
    and installs it on the model's modules for the length of each
    ``sampling`` call only, so the model is left without it (training and
    other processes over the same model never see it)."""

    def __init__(self, cfg, model: torch.nn.Module,
                 turbo: Optional[str] = None):
        self.cfg = cfg
        self.model = model.eval()
        c, h, w = cfg.shape
        self.data_shape = (h, w, c)
        self.device = _device_of(model)
        self.sched = make_schedule(cfg.beta1, cfg.betaT, cfg.diffusion_steps,
                                   self.device)
        self.turbo = _resolve_turbo(cfg, turbo)
        self.quant = {}
        if self.turbo:
            q8.calibrate(model, self.data_shape, a_dim=cfg.a_dim,
                         T=cfg.diffusion_steps, mode=self.turbo)
            self.quant = q8.quant_state(model)
            q8.clear_quant_state(model)

    @torch.no_grad()
    def sampling(self, generator: Optional[torch.Generator] = None,
                 sampling_number: int = 16, xT=None, a=None,
                 num_steps: Optional[int] = None):
        """``num_steps`` selects DDIM-N (None: ``cfg.sampling_steps``, and
        when that is None too, the full-grid sampler)."""
        if num_steps is None:
            num_steps = self.cfg.sampling_steps
        if xT is None:
            xT = torch.randn((sampling_number,) + self.data_shape,
                             generator=generator, device=self.device)
        if a is None:
            a = torch.randn((xT.shape[0], self.cfg.a_dim),
                            generator=generator, device=self.device)
        q8.load_quant_state(self.model, self.quant)
        try:
            if num_steps is not None:
                return strided_ddim_loop(self.model, self.sched, xT,
                                         generator, a, num_steps=num_steps)
            return sample_loop(self.model, self.sched, xT, generator, a,
                               deterministic=self.cfg.deterministic)
        finally:
            q8.clear_quant_state(self.model)


class LatentDiffusionProcess:
    """The latent prior's sampler: the whole trajectory runs as one K4
    launch on the card (its plain version on the CPU). ``model`` is a port
    ``Diff(is_latent=True)``; its weights are packed once, here, in the
    model's dtype, and with ``turbo='int8'`` quantized to the int8 weight
    stream (``quantize_packed_weights``)."""

    def __init__(self, cfg, model: torch.nn.Module,
                 turbo: Optional[str] = None):
        self.cfg = cfg
        self.model = model.eval()
        self.device = _device_of(model)
        self.sched = make_schedule(cfg.beta1, cfg.betaT, cfg.diffusion_steps,
                                   self.device)
        self.turbo = _resolve_turbo(cfg, turbo)
        self.params = pack_latent_unet_params(model.backbone, cfg.a_dim,
                                              dtype=model.dtype)
        if self.turbo:
            self.params = quantize_packed_weights(self.params)

    @torch.no_grad()
    def sampling(self, generator: Optional[torch.Generator] = None,
                 sampling_number: int = 16, xT=None, noises=None):
        if xT is None:
            xT = torch.randn((sampling_number, self.cfg.a_dim),
                             generator=generator, device=self.device)
        return latent_trajectory(
            self.params, self.sched, xT, generator,
            deterministic=self.cfg.deterministic, noises=noises,
        )

    @torch.no_grad()
    def reverse_sampling(self, x0: torch.Tensor) -> torch.Tensor:
        return latent_trajectory(self.params, self.sched, x0,
                                 deterministic=True, reverse=True)
