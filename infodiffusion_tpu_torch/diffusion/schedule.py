"""Noise schedule and single-step algebra
(JAX counterpart: ``infodiffusion_tpu/diffusion/schedule.py``).

The same algebra with the same quirks: a linear beta grid,
``alpha_prev_bars`` = alpha_bars shifted right with a leading 1, the DDIM
x0 estimate from ``alpha_prev_bars[idx]`` with fixed eta = 0.01, and the
strided DDIM step on plain ᾱ. All constants are f32 on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_ETA = 0.01


class Schedule(NamedTuple):
    """Schedule constants, each shape [T] f32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor
    alpha_prev_bars: torch.Tensor

    @property
    def T(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "Schedule":
        return Schedule(*(a.to(device) for a in self))


def make_schedule(beta1: float, betaT: float, T: int,
                  device=None) -> Schedule:
    """Linear beta schedule, f32 like the JAX one (not f64)."""
    betas = torch.linspace(beta1, betaT, T, dtype=torch.float32)
    alphas = 1.0 - betas
    alpha_bars = torch.cumprod(alphas, dim=0)
    alpha_prev_bars = torch.cat([torch.ones(1), alpha_bars[:-1]])
    return Schedule(betas, alphas, alpha_bars, alpha_prev_bars).to(device)


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def q_sample(sched: Schedule, x0, t, eps):
    """Forward noising ``sqrt(ab_t) x0 + sqrt(1 - ab_t) eps``, broadcast
    over image [B, H, W, C] and latent [B, d] alike."""
    ab = _bcast(sched.alpha_bars[t], x0)
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps


def predict_x0_from_eps(sched: Schedule, x, idx, eps):
    """The reference's x0 estimate, from ``alpha_prev_bars[idx]``."""
    apb = _bcast(sched.alpha_prev_bars[idx], x)
    return (x - torch.sqrt(1.0 - apb) * eps) / torch.sqrt(apb)


def ddpm_step(sched: Schedule, x, idx, eps_pred, noise):
    """One DDPM ancestral update; the caller zeroes ``noise`` at idx 0."""
    beta = _bcast(sched.betas[idx], x)
    alpha = _bcast(sched.alphas[idx], x)
    ab = _bcast(sched.alpha_bars[idx], x)
    apb = _bcast(sched.alpha_prev_bars[idx], x)
    sqrt_tilde_beta = torch.sqrt((1.0 - apb) / (1.0 - ab) * beta)
    mu = torch.sqrt(1.0 / alpha) * (x - beta / torch.sqrt(1.0 - ab) * eps_pred)
    return mu + sqrt_tilde_beta * noise


def ddim_step(sched: Schedule, x, idx, eps_pred, noise,
              eta: float = DEFAULT_ETA):
    """One stochastic (eta = 0.01) DDIM update; at idx 0 it returns the x0
    estimate."""
    x0 = predict_x0_from_eps(sched, x, idx, eps_pred)
    prev = torch.clamp(idx - 1, min=0)
    apb_prev = _bcast(sched.alpha_prev_bars[prev], x)
    ab_prev = _bcast(sched.alpha_bars[prev], x)
    beta_prev = _bcast(sched.betas[prev], x)
    sigma = (eta * torch.sqrt((1.0 - apb_prev) / (1.0 - ab_prev))
             * torch.sqrt(beta_prev))
    x_next = (
        torch.sqrt(apb_prev) * x0
        + torch.sqrt(1.0 - apb_prev - sigma**2) * eps_pred
        + sigma * noise
    )
    is_last = _bcast((idx == 0).to(x.dtype), x)
    return is_last * x0 + (1.0 - is_last) * x_next


def strided_ddim_step(sched: Schedule, x, t, t_prev, eps_pred, noise,
                      eta: float = 0.0):
    """Textbook DDIM from ``t`` to ``t_prev`` on plain ᾱ; ``t_prev == -1``
    lands on x0."""
    ab_t = _bcast(sched.alpha_bars[t], x)
    ab_prev = _bcast(
        torch.where(
            t_prev >= 0,
            sched.alpha_bars[torch.clamp(t_prev, min=0)],
            torch.ones((), device=x.device),
        ),
        x,
    )
    x0 = (x - torch.sqrt(1.0 - ab_t) * eps_pred) / torch.sqrt(ab_t)
    sigma = (
        eta
        * torch.sqrt((1.0 - ab_prev) / (1.0 - ab_t))
        * torch.sqrt(1.0 - ab_t / ab_prev)
    )
    dir_xt = torch.sqrt(torch.clamp(1.0 - ab_prev - sigma**2, min=0.0)) * eps_pred
    return torch.sqrt(ab_prev) * x0 + dir_xt + sigma * noise
