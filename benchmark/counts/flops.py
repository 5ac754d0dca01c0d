"""Model FLOPs of the CelebA-64 models, from the architecture alone.

The convention is the valid-tap count: a convolution counts only the
(output, tap) pairs whose input lies inside the unpadded image, 2 FLOPs a
multiply-add; Dense layers and the attention's two products count their
multiply-adds; normalisations, activations, the optimizer and the noise
schedule count nothing. It is the count the port's FLOP tool reports on its
plain path (14.753476 GFLOP a forward sample and 78.473818 a train image
at batch 128 for the InfoDiff), frozen here as arithmetic so that a change
to the program cannot move the yardstick.

A train image counts the forward of every layer, and in the backward the
input gradient of every layer whose input needs one and the weight
gradient of every layer (the head convolutions and the time embedding's
first Dense read inputs that need no gradient), and the MMD's products.
The attention's backward counts five products, its logits recomputed as
the port's fused backward computes them (the tool's count).
"""

from __future__ import annotations

from typing import Dict

from benchmark.reference.model import LATENT_LAYERS, LATENT_TEMB, skeleton_plan


def valid_pairs(n: int, k: int = 3, stride: int = 1, pad: int = 1) -> int:
    """(output, tap) pairs along one dimension whose input index lies in
    [0, n)."""
    out = (n + 2 * pad - k) // stride + 1
    return sum(1 for i in range(out) for j in range(k)
               if 0 <= i * stride - pad + j < n)


def conv_macs(cin: int, cout: int, n: int, stride: int = 1) -> int:
    return cin * cout * valid_pairs(n, stride=stride) ** 2


def skeleton_macs(arch: dict, size: int, in_ch: int, out_ch: int,
                  emb: int, films: int) -> Dict[str, int]:
    """Multiply-adds of one UNet skeleton for one sample, by kind:
    ``conv`` (3x3), ``head`` (the first conv), ``dense`` (projections),
    ``attn`` (the two attention products)."""
    ch = arch["ch"]
    m = {"conv": 0, "head": conv_macs(in_ch, ch, size), "dense": 0,
         "attn": 0}
    for kind, _name, cin, cout, use_attn, lvl in skeleton_plan(
            ch, arch["ch_mult"], arch["num_res_blocks"], arch["attn"]):
        r = size >> lvl
        if kind == "downsample":
            m["conv"] += conv_macs(cin, cout, r, stride=2)
            continue
        if kind == "upsample":
            m["conv"] += conv_macs(cin, cout, 2 * (size >> lvl))
            continue
        m["conv"] += conv_macs(cin, cout, r) + conv_macs(cout, cout, r) * (
            2 if films else 1)
        m["dense"] += films * emb * 2 * cout
        if cin != cout:
            m["dense"] += cin * cout * r * r
        if use_attn:
            n = r * r
            m["dense"] += 4 * cout * cout * n
            m["attn"] += 2 * n * n * cout
    m["conv"] += conv_macs(ch, out_ch, size)
    return m


def forward_gflop(cfg: dict) -> float:
    """GFLOP of one noise prediction of the image model, per sample."""
    arch, size = cfg["arch"], cfg["input_size"]
    ch = arch["ch"]
    emb = 4 * ch
    info = cfg["model"] == "infodiff"
    m = skeleton_macs(arch, size, 3, 3, emb, 2 if info else 1)
    macs = sum(m.values()) + ch * emb + emb * emb
    if info:
        macs += cfg["a_dim"] * emb
    return 2 * macs / 1e9


def encoder_macs(cfg: dict) -> Dict[str, int]:
    arch, size = cfg["arch"], cfg["input_size"]
    m = skeleton_macs(arch, size, 3, 1, 0, 0)
    m["dense"] += size * size * cfg["a_dim"] + 2 * cfg["a_dim"] ** 2
    return m


def train_gflop(cfg: dict, batch: int) -> float:
    """GFLOP of one train image at ``batch`` (the MMD's share depends on
    it): forward, backward and the MMD."""
    arch, size = cfg["arch"], cfg["input_size"]
    ch = arch["ch"]
    emb = 4 * ch
    info = cfg["model"] == "infodiff"
    bb = skeleton_macs(arch, size, 3, 3, emb, 2 if info else 1)
    temb0, temb1 = ch * emb, emb * emb
    fwd = sum(bb.values()) + temb0 + temb1
    # backward: the head and the first time Dense take weight gradients
    # only; everything else both
    bwd = (2 * (sum(bb.values()) - bb["head"] + temb1) + bb["head"] + temb0
           + bb["attn"] // 2)
    if info:
        a = cfg["a_dim"]
        fc_a = a * emb
        enc = encoder_macs(cfg)
        mu_var = 2 * a * a   # fc_mu, fc_var: forward only (not in the loss)
        fwd += fc_a + sum(enc.values())
        bwd += (2 * fc_a + 2 * (sum(enc.values()) - enc["head"] - mu_var)
                + enc["head"] + enc["attn"] // 2)
        # MMD: three B x B kernels forward; the latents' two backward
        fwd += 3 * batch * a
        bwd += 3 * batch * a
    return 2 * (fwd + bwd) / 1e9


def latent_forward_gflop(cfg: dict) -> float:
    """GFLOP of one LatentUNet noise prediction, per sample."""
    d = cfg["a_dim"]
    macs = LATENT_TEMB * d + d * d
    for i in range(LATENT_LAYERS):
        cin = d if i == 0 else 5 * d
        cout = d if i == LATENT_LAYERS - 1 else 4 * d
        macs += cin * cout
        if i < LATENT_LAYERS - 1:
            macs += d * cout
    return 2 * macs / 1e9


def gen_gflop(cfg: dict) -> float:
    """GFLOP of one generated image: the DDIM steps' noise predictions and,
    for InfoDiff, the latent prior's full-grid trajectory."""
    g = cfg["sampling_steps"] * forward_gflop(cfg)
    if cfg["model"] == "infodiff":
        g += cfg["T"] * latent_forward_gflop(cfg)
    return g
