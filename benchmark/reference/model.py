"""Plain PyTorch reference of the CelebA-64 models the benchmark runs.

Written from the published architecture (DDPM's UNet with the InfoDiffusion
auxiliary FiLM, its UNet encoder, and the latent MLP prior), in float32
with TF32 off, on plain ``torch`` operations: no kernel, no cache, no
batching trick. It reads weights from a flat ``{name: tensor}`` dict in the
layout of the PyTorch port's checkpoints (``weight`` [O, I(, 3, 3)],
``bias``), which is the interface both sides share; it imports nothing of
the program.

Every matrix product and convolution takes its inputs through ``q`` (the
identity here; ``precision.fp8`` for the lower-precision control).
Activations are NCHW; dropout replays masks drawn exactly as the
program's training step draws them (``train.draw_masks``), so a reference
step sees the same masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GROUPS = 32
GN_EPS = 1e-5
LN_EPS = 1e-5
DROPOUT = 0.1
LATENT_LAYERS = 10
LATENT_TEMB = 64

Params = Dict[str, torch.Tensor]


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


# ---------------------------------------------------------------------------
# the skeleton's plan: (kind, name, in_ch, out_ch, attention, level)
# ---------------------------------------------------------------------------


def skeleton_plan(ch: int, ch_mult: Sequence[int], num_res_blocks: int = 2,
                  attn: Sequence[int] = (2,)) -> List[tuple]:
    """The UNet's blocks in order, with their channel counts: down blocks
    (``num_res_blocks`` a level, a skip pushed after each and after each
    DownSample), two middle blocks (attention on the first), up blocks
    (``num_res_blocks + 1`` a level, each popping a skip), one counter
    naming ``downblock_N`` / ``middleblock_N`` / ``upblock_N``."""
    plan, skips, now, n = [], [ch], ch, 0
    levels = len(ch_mult)
    for i, mult in enumerate(ch_mult):
        for _ in range(num_res_blocks):
            plan.append(("down", f"downblock_{n}", now, ch * mult,
                         i in attn, i))
            n += 1
            now = ch * mult
            skips.append(now)
        if i != levels - 1:
            plan.append(("downsample", f"down_{i}", now, now, False, i))
            skips.append(now)
    for j, use_attn in enumerate((True, False)):
        plan.append(("middle", f"middleblock_{n}", now, now, use_attn,
                     levels - 1))
        n += 1
    for i, mult in reversed(list(enumerate(ch_mult))):
        for _ in range(num_res_blocks + 1):
            plan.append(("up", f"upblock_{n}", now + skips.pop(), ch * mult,
                         i in attn, i))
            n += 1
            now = ch * mult
        if i != 0:
            plan.append(("upsample", f"up_{i}", now, now, False, i))
    return plan


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def dense(P: Params, name: str, x: torch.Tensor, q=ident) -> torch.Tensor:
    return F.linear(q(x), q(P[name + ".weight"]), P[name + ".bias"])


def conv3(P: Params, name: str, x: torch.Tensor, stride: int = 1,
          q=ident) -> torch.Tensor:
    return F.conv2d(q(x), q(P[name + ".weight"]), P[name + ".bias"],
                    stride=stride, padding=1)


def group_norm(P: Params, name: str, x: torch.Tensor,
               films: Sequence[Tuple[torch.Tensor, torch.Tensor]] = ()):
    """GroupNorm(32), then each FiLM ``h * (1 + s) + b`` in order."""
    h = F.group_norm(x, GROUPS, P[name + ".weight"], P[name + ".bias"],
                     GN_EPS)
    for s, b in films:
        h = h * (1.0 + s[:, :, None, None]) + b[:, :, None, None]
    return h


class Dropout:
    """The dropout of one step: the keep-masks of every site, drawn
    beforehand as the program draws them (``train.draw_masks``), replayed
    in order; ``rows`` selects a block of rows of them."""

    def __init__(self, masks: List[torch.Tensor], rows=None):
        self.masks = masks
        self.rows = rows
        self.i = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.masks[self.i]
        self.i += 1
        if self.rows is not None:
            m = m[self.rows]
        keep = 1.0 - DROPOUT
        return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def res_block(P: Params, name: str, x, temb, aemb, drop, q):
    """ResBlock (time FiLM), AuxResBlock (time then aux FiLM) or
    EncoderResBlock (no FiLM, one stage less), by which projections the
    weights hold. ``x`` is the input, or ``(h, skip)`` for an up block."""
    if isinstance(x, tuple):
        x = torch.cat(x, dim=1)
    h = conv3(P, name + ".conv1", F.silu(group_norm(P, name + ".norm1", x)),
              q=q)
    films = []
    if name + ".temb_proj.weight" in P:
        films.append(dense(P, name + ".temb_proj", F.silu(temb),
                           q).chunk(2, -1))
    if name + ".aemb_proj.weight" in P:
        films.append(dense(P, name + ".aemb_proj", F.silu(aemb),
                           q).chunk(2, -1))
    h = group_norm(P, name + ".norm2", h, films)
    h = conv3(P, name + ".conv2", drop(F.silu(h)) if drop else F.silu(h), q=q)
    if name + ".conv3.weight" in P:
        h = group_norm(P, name + ".norm3", h)
        h = conv3(P, name + ".conv3", drop(F.silu(h)) if drop else F.silu(h),
                  q=q)
    if name + ".shortcut.weight" in P:
        sc = dense(P, name + ".shortcut", x.permute(0, 2, 3, 1), q)
        h = h + sc.permute(0, 3, 1, 2)
    else:
        h = h + x
    if name + ".attn.proj_q.weight" in P:
        h = attn_block(P, name + ".attn", h, q)
    return h


def attn_block(P: Params, name: str, x: torch.Tensor, q) -> torch.Tensor:
    """x + proj(softmax(q k^T / sqrt(C)) v) over the H*W tokens, q, k, v
    Dense projections of GroupNorm(x)."""
    B, C, H, W = x.shape
    h = group_norm(P, name + ".group_norm", x).permute(0, 2, 3, 1)
    h = h.reshape(B, H * W, C)
    qq = dense(P, name + ".proj_q", h, q)
    kk = dense(P, name + ".proj_k", h, q)
    vv = dense(P, name + ".proj_v", h, q)
    w = torch.softmax(q(qq) @ q(kk).transpose(1, 2) / math.sqrt(C), dim=-1)
    o = q(w) @ q(vv)
    o = dense(P, name + ".proj", o, q).reshape(B, H, W, C)
    return x + o.permute(0, 3, 1, 2)


def skeleton(P: Params, prefix: str, arch: dict, x: torch.Tensor,
             temb=None, aemb=None, drop=None, q=ident) -> torch.Tensor:
    """The UNet skeleton over NCHW ``x``: head conv, the plan's blocks,
    GroupNorm-SiLU-tail conv."""
    plan = skeleton_plan(arch["ch"], arch["ch_mult"], arch["num_res_blocks"],
                         arch["attn"])
    h = conv3(P, prefix + "head", x, q=q)
    hs = [h]
    for kind, name, _cin, _cout, _attn, _lvl in plan:
        full = prefix + name
        if kind == "downsample":
            h = conv3(P, full + ".conv", h, stride=2, q=q)
            hs.append(h)
            continue
        if kind == "upsample":
            h = conv3(P, full + ".conv",
                      F.interpolate(h, scale_factor=2, mode="nearest"), q=q)
            continue
        if kind == "up":
            h = (h, hs.pop())
        h = res_block(P, full, h, temb, aemb, drop, q)
        if kind == "down":
            hs.append(h)
    h = F.silu(group_norm(P, prefix + "tail_norm", h))
    return conv3(P, prefix + "tail_conv", h, q=q)


def sinusoidal_table(T: int, d: int, device) -> torch.Tensor:
    """[T, d]: interleaved (sin, cos) pairs of t * 10000^(-2i/d)."""
    i = torch.arange(0, d, 2, dtype=torch.float64, device=device)
    freqs = torch.exp(-i / d * math.log(10000.0))
    args = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freqs
    return torch.stack([torch.sin(args), torch.cos(args)], -1).reshape(T, d)


def time_embedding(P: Params, prefix: str, t: torch.Tensor, T: int,
                   ch: int, q=ident) -> torch.Tensor:
    emb = sinusoidal_table(T, ch, t.device)[t].to(torch.float32)
    h = F.silu(dense(P, prefix + "dense0", emb, q))
    return dense(P, prefix + "dense1", h, q)


def eps_model(P: Params, arch: dict, x_nhwc: torch.Tensor, t: torch.Tensor,
              a: Optional[torch.Tensor] = None, drop=None,
              q=ident) -> torch.Tensor:
    """The noise prediction of the image model: the InfoDiff backbone
    (``backbone.fc_a`` present, conditioned on ``a``) or the vanilla
    UNet. NHWC in, NHWC out."""
    temb = time_embedding(P, "backbone.time_embedding.", t, arch["T"],
                          arch["ch"], q)
    aemb = dense(P, "backbone.fc_a", a, q) if a is not None else None
    h = skeleton(P, "backbone.unet.", arch, x_nhwc.permute(0, 3, 1, 2),
                 temb, aemb, drop, q)
    return h.permute(0, 2, 3, 1)


def encode(P: Params, arch: dict, x_nhwc: torch.Tensor, drop=None,
           q=ident) -> torch.Tensor:
    """The Encoder's deterministic latent ``a`` (the pre-mu projection of
    the flattened one-channel tail)."""
    h = skeleton(P, "encoder.unet.", arch, x_nhwc.permute(0, 3, 1, 2),
                 drop=drop, q=q)
    return dense(P, "encoder.fc_a", h.reshape(h.shape[0], -1), q)


# ---------------------------------------------------------------------------
# the latent prior (LatentUNet)
# ---------------------------------------------------------------------------


def latent_time_embedding(t: torch.Tensor, dim: int = LATENT_TEMB):
    """[cos | sin] of t * 10000^(-i/half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=t.device) / half)
    args = t.to(torch.float64)[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], -1).to(torch.float32)


def latent_eps(P: Params, x: torch.Tensor, t: torch.Tensor,
               q=ident) -> torch.Tensor:
    """The prior's MLP skip-net: layer 0 on x, layers 1.. on [h, x]; each
    but the last: Linear, times (1 + Linear(silu(temb))), LayerNorm, SiLU."""
    pre = "backbone."
    temb = dense(P, pre + "time_embed_1",
                 F.silu(dense(P, pre + "time_embed_0",
                              latent_time_embedding(t), q)), q)
    s = F.silu(temb)
    h = None
    for i in range(LATENT_LAYERS):
        name = f"{pre}layer_{i}"
        z = dense(P, name + ".linear", x if i == 0 else torch.cat([h, x], -1),
                  q)
        if i == LATENT_LAYERS - 1:
            return z
        z = z * (1.0 + dense(P, name + ".linear_emb", s, q))
        z = F.layer_norm(z, (z.shape[-1],), P[name + ".norm.weight"],
                         P[name + ".norm.bias"], LN_EPS)
        h = F.silu(z)
    return h


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

