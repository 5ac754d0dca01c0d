"""Plain reference of a generation cell's two legs.

The latent prior: DDPM ancestral sampling over the full grid T-1 .. 0
with the LatentUNet's noise prediction, ``x <- (x - beta / sqrt(1 - abar)
eps) / sqrt(alpha) + sqrt((1 - abar_prev) / (1 - abar) beta) noise``, no
noise at the last step. The image: DDIM with eta 0 over the 100 evenly
spaced timesteps of 0 .. T-1 (rounded), walked from T-1 down to x0,
conditioned on the prior's latent for InfoDiff. Schedules in float64,
activations in float32; the starting noise and the per-step draws are
inputs, the same ones the program was given.
"""

from __future__ import annotations

import torch

from benchmark.reference import model as M
from benchmark.reference.train import schedule


def latent_ddpm(cfg: dict, P_lat, zT: torch.Tensor, noises: torch.Tensor,
                q=M.ident) -> torch.Tensor:
    """[B, a_dim] latents from zT with the per-step draws ``noises``
    [T, B, a_dim] (``noises[i]`` at timestep T-1-i)."""
    S = schedule(cfg, zT.device)
    T = cfg["T"]
    ab = S["alpha_bars"]
    abp = torch.cat([torch.ones(1, dtype=ab.dtype, device=ab.device), ab[:-1]])
    x = zT.to(torch.float32)
    for i in range(T):
        idx = T - 1 - i
        t = torch.full((x.shape[0],), idx, device=x.device, dtype=torch.long)
        eps = M.latent_eps(P_lat, x, t, q)
        beta, alpha = float(S["betas"][idx]), float(S["alphas"][idx])
        cx = (1.0 / alpha) ** 0.5
        ce = -cx * beta / (1.0 - float(ab[idx])) ** 0.5
        cn = ((1.0 - float(abp[idx])) / (1.0 - float(ab[idx])) * beta) ** 0.5
        x = cx * x + ce * eps + (cn * noises[i] if idx > 0 else 0.0)
    return x


def ddim_timesteps(T: int, steps: int):
    """The DDIM grid from high noise down, and each step's target (-1: x0)."""
    ts = torch.linspace(0, T - 1, steps, dtype=torch.float64).round()
    ts = [int(v) for v in ts.flip(0)]
    return ts, ts[1:] + [-1]


def ddim(cfg: dict, P, xT: torch.Tensor, a=None, q=M.ident) -> torch.Tensor:
    """Deterministic DDIM (eta 0) over ``cfg['sampling_steps']`` steps."""
    S = schedule(cfg, xT.device)
    ab = S["alpha_bars"]
    x = xT.to(torch.float32)
    ts, prev = ddim_timesteps(cfg["T"], cfg["sampling_steps"])
    for t, tp in zip(ts, prev):
        tt = torch.full((x.shape[0],), t, device=x.device, dtype=torch.long)
        eps = M.eps_model(P, cfg["arch"], x, tt, a, q=q)
        ab_t = float(ab[t])
        ab_p = float(ab[tp]) if tp >= 0 else 1.0
        x0 = (x - (1.0 - ab_t) ** 0.5 * eps) / ab_t ** 0.5
        x = ab_p ** 0.5 * x0 + (1.0 - ab_p) ** 0.5 * eps
    return x
