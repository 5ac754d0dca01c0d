"""Plain reference of the first training steps of a cell.

What a step is, from the published method and the configuration: a batch
of CelebA-shaped uint8 images, flipped at random and scaled to [-1, 1];
a timestep and a noise draw per image; the noised image; the noise
prediction (the InfoDiff backbone conditioned on the encoder's latent of
the clean image, or the vanilla UNet); the loss (noise MSE; for InfoDiff
also the t=0 reconstruction term over T and 0.1 x MMD between a prior draw
and the latents); its gradient; the global-norm clip at 1.0 and AdamW
(0.9, 0.999, 1e-8, weight decay 1e-5, the first epoch's learning rate).

The random numbers are the step's inputs, drawn here as the program's
step draws them: three generators per step seeded from
``SeedSequence([seed, step])`` (noise: t, eps, the prior; reparam; dropout:
one mask per dropout site over the whole batch, encoder first). The flips
follow the loader's contract: ``RandomState(seed).rand(n_batches, B) <
0.5`` per epoch, rows in order (CelebA is not shuffled).

The batch runs in blocks of rows so that float32 fits: the MMD couples
the rows only through the latents, so a first pass takes every row's
latent without gradients, the MMD's gradient with respect to them is
taken once, and each block's backward then carries it as a linear term.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference import model as M


def step_generators(seed: int, step: int, device) -> List[torch.Generator]:
    """(noise, reparam, dropout) generators of one step."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(3)
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def flip_masks(seed: int, n_batches: int, batch: int) -> np.ndarray:
    """The first epoch's flips: [n_batches, batch] bool."""
    return np.random.RandomState(seed).rand(n_batches, batch) < 0.5


def batch_images(images_u8: np.ndarray, b: int, batch: int,
                 flips: np.ndarray, device) -> torch.Tensor:
    """Batch ``b`` of the unshuffled first epoch as f32 NHWC in [-1, 1]."""
    x = images_u8[b * batch:(b + 1) * batch].copy()
    m = flips[b]
    x[m] = x[m, :, ::-1, :]
    u8 = torch.from_numpy(x).to(device)
    return torch.clamp(u8.to(torch.float32) / 255.0 * 2.0 - 1.0, -1.0, 1.0)


def schedule(cfg: dict, device) -> Dict[str, torch.Tensor]:
    """The linear beta grid and its products, in float64."""
    betas = torch.linspace(cfg["beta1"], cfg["betaT"], cfg["T"],
                           dtype=torch.float64, device=device)
    alphas = 1.0 - betas
    return {"betas": betas, "alphas": alphas,
            "alpha_bars": torch.cumprod(alphas, 0)}


def dropout_sites(arch: dict, size: int, prefix_blocks: int) -> List[tuple]:
    """(channels, resolution) of each dropout site of one skeleton, in the
    order of the forward: ``prefix_blocks`` sites a block (2 for the
    conditioned ResBlocks, 1 for the encoder's)."""
    out = []
    for kind, _name, _cin, cout, _attn, lvl in M.skeleton_plan(
            arch["ch"], arch["ch_mult"], arch["num_res_blocks"],
            arch["attn"]):
        if kind in ("down", "middle", "up"):
            out += [(cout, size >> lvl)] * prefix_blocks
    return out


def draw_masks(gen: torch.Generator, sites: Sequence[tuple], batch: int,
               device) -> List[torch.Tensor]:
    """One bool keep-mask per site, [B, C, R, R], drawn as the program
    draws them (f32 uniforms in channels_last order)."""
    masks = []
    for c, r in sites:
        u = torch.empty((batch, c, r, r), dtype=torch.float32, device=device,
                        memory_format=torch.channels_last)
        u.uniform_(generator=gen)
        masks.append(u < 1.0 - M.DROPOUT)
    return masks


class Draws:
    """Every random input of one step of a cell, for the whole batch."""

    def __init__(self, cfg: dict, seed: int, step: int, x: torch.Tensor,
                 draw_dtype: torch.dtype):
        dev = x.device
        B = x.shape[0]
        noise, _reparam, drop = step_generators(seed, step, dev)
        self.t = torch.randint(0, cfg["T"], (B,), generator=noise, device=dev)
        self.eps = torch.randn(x.shape, generator=noise, device=dev,
                               dtype=x.dtype)
        size = x.shape[1]
        arch = cfg["arch"]
        self.enc_masks = []
        if cfg["model"] == "infodiff":
            self.enc_masks = draw_masks(drop, dropout_sites(arch, size, 1),
                                        B, dev)
        self.bb_masks = draw_masks(drop, dropout_sites(arch, size, 2), B, dev)
        self.prior = None
        if cfg["model"] == "infodiff":
            self.prior = torch.randn((B, cfg["a_dim"]), generator=noise,
                                     device=dev, dtype=draw_dtype
                                     ).to(torch.float32)


def mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MMD^2 with the diagonal terms and the kernel exp(-|x-y|^2 / d^2)."""
    d = x.shape[1]

    def k(a, b):
        return torch.exp(-torch.cdist(a, b).square() / (d * d))

    return k(x, x).mean() + k(y, y).mean() - 2.0 * k(x, y).mean()


def loss_and_grads(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
                   draws: Draws, block: int, q=M.ident,
                   rows: Optional[int] = None):
    """(loss, grads by name) of one step over the batch ``x`` in blocks of
    ``block`` rows; ``rows`` keeps only the first rows in the loss (a
    fault reading)."""
    B = x.shape[0] if rows is None else rows
    arch = cfg["arch"]
    S = schedule(cfg, x.device)
    ab = S["alpha_bars"][draws.t].to(torch.float32)[:, None, None, None]
    x_t = torch.sqrt(ab) * x + torch.sqrt(1.0 - ab) * draws.eps
    names = list(P)
    for p in P.values():
        p.grad = None
    info = cfg["model"] == "infodiff"
    n_el = B * x[0].numel()
    spans = [(i, min(i + block, B)) for i in range(0, B, block)]
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    g_a = None
    if info:
        with torch.no_grad():
            a_all = torch.cat([M.encode(
                P, arch, x[s:e], M.Dropout(masks=draws.enc_masks,
                                           rows=slice(s, e)), q)
                for s, e in spans])
        a_var = a_all.detach().requires_grad_(True)
        l_mmd = mmd(draws.prior[:B], a_var)
        (g_a,) = torch.autograd.grad(l_mmd, a_var)
        loss += cfg["mmd_weight"] * l_mmd.detach().double()
        c0 = 1.0 / math.sqrt(float(S["alphas"][0]))
        k0 = float(S["betas"][0]) / math.sqrt(1.0 - float(S["alpha_bars"][0]))
    for s, e in spans:
        r = slice(s, e)
        a = None
        if info:
            a = M.encode(P, arch, x[r], M.Dropout(masks=draws.enc_masks,
                                                  rows=r), q)
        out = M.eps_model(P, arch, x_t[r], draws.t[r], a,
                          M.Dropout(masks=draws.bb_masks, rows=r), q)
        part = (out - draws.eps[r]).square().sum() / n_el
        if info:
            x0 = c0 * (x[r] - k0 * out)
            part = part + (x0 - x[r]).square().sum() / n_el / cfg["T"]
        loss += part.detach().double()
        if info:
            part = part + cfg["mmd_weight"] * (g_a[r] * a).sum()
        part.backward()
    grads = {n: (P[n].grad if P[n].grad is not None
                 else torch.zeros_like(P[n])) for n in names}
    return float(loss), grads


class AdamW:
    """Global-norm clip at ``clip``, then AdamW, every leaf updated."""

    def __init__(self, P: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float = 1e-5, clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {n: torch.zeros_like(p) for n, p in P.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in P.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, P, grads) -> Dict[str, torch.Tensor]:
        """Apply one step; returns the clipped gradient by name."""
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values()))
        scale = (self.clip / norm) if norm >= self.clip else 1.0
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        clipped = {}
        for n, p in P.items():
            g = (grads[n].double() * scale).to(torch.float32)
            clipped[n] = g
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps)
            p.add_(-self.lr * (u + self.wd * p))
        return clipped


def run_steps(cfg: dict, P0: Dict[str, torch.Tensor], images_u8: np.ndarray,
              seed: int, n_steps: int, batch: int, block: int, device,
              draw_dtype: torch.dtype, q=M.ident, rows=None) -> dict:
    """The reference's own first ``n_steps`` steps from the weights ``P0``
    (float32 copies are made): each step's loss, each leaf's norm of the
    first clipped gradient, and each leaf's norm of the parameters' change
    after the last step."""
    P = {n: p.detach().to(device=device, dtype=torch.float32).clone()
         .requires_grad_(True) for n, p in P0.items()}
    start = {n: p.detach().clone() for n, p in P.items()}
    opt = AdamW(P, cfg["learning_rate"])
    n_batches = len(images_u8) // batch
    flips = flip_masks(seed, n_batches, batch)
    losses, grad_norms = [], None
    for step in range(n_steps):
        x = batch_images(images_u8, step, batch, flips, device)
        draws = Draws(cfg, seed, step, x, draw_dtype)
        loss, grads = loss_and_grads(cfg, P, x, draws, block, q, rows)
        del draws
        losses.append(loss)
        clipped = opt.update(P, grads)
        if step == 0:
            grad_norms = {n: float(g.double().norm())
                          for n, g in clipped.items()}
            first = {n: g.cpu() for n, g in clipped.items()}
        del grads, clipped
    change = {n: float((P[n].detach() - start[n]).double().norm())
              for n in P}
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "grads": first}
