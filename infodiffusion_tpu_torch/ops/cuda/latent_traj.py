"""K4: the whole latent DDIM/DDPM/reverse trajectory, a CUDA kernel and its
plain version.

Replaces ``infodiffusion_tpu/ops/pallas/latent_traj.py``
(``latent_trajectory_pallas``, ``_kernel``): the bf16/f32 weight stream and
the int8 one of the turbo tier (``quantize_packed_weights``: int8 W and a
per-(layer, column) scale table Wsc, 13.1 MB per step at a_dim 256).
Kernel: ``csrc/latent_traj.cu`` on the cluster core of
``csrc/latent_common.cuh``. The plain version runs the same packed step as
some 40 small PyTorch ops per step, 1000 steps; the kernel runs the step
loop and the layer loop inside one launch. A thread-block cluster owns a
row group for the whole trajectory and each of its ranks streams only its
columns of the packed weights (26.2 MB in bf16 at a_dim 256), so each
weight is read once per row group per step, from the L2, as the TPU kernel
reads it once per step for its batch. ``latent_launch_plan`` (in
``ops/cuda/latent_mlp.py``, shared with K5) says what it launches.

What stays outside the kernel, as plain torch, as in the JAX package: the
per-step 1 + FiLM rows ``c_all`` (they depend on the timestep only), the
[S, 3] update coefficients ``coef`` and the pre-drawn noise [S, B, d].

The TPU kernel's Mosaic artifacts (the ``a_dim % 32`` gate and the lane
padding) are not ported. The CUDA kernel's own limits: a_dim a multiple of
16 up to 1024 (f32 W up to 768), W in f32, bf16 or int8 (with Wsc).
:func:`latent_route` is the sampler's choice between K4, K5 and the plain
torch scan, made where JAX makes its own, before anything runs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.diffusion.schedule import DEFAULT_ETA, Schedule
from infodiffusion_tpu_torch.models.latent_unet import (
    NUM_LAYERS,
    TIME_EMB_CHANNELS,
)
from infodiffusion_tpu_torch.nn.embeddings import timestep_embedding
from infodiffusion_tpu_torch.ops.cuda import library as _lib
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import (
    _W_CODES,
    EPS,
    _plan_args,
    check_a_dim,
    latent_a_dim_ok,
    latent_plan_on,
)
from infodiffusion_tpu_torch.ops.quant import _per_127


def latent_route(a_dim: int, w_dtype: torch.dtype,
                 per_forward_wanted: bool) -> str:
    """How ``LatentDiffusionProcess`` samples, as the JAX process chooses:
    "k5" (one K5 forward a step) on the per-forward opt-in, "k4" (the whole
    trajectory in one launch) by default, both only where the cluster core
    takes a_dim and the W dtype (:func:`latent_a_dim_ok`); "torch" (the
    samplers over the model's own forward, JAX's XLA scan) otherwise and
    under ``INFODIFF_DISABLE_PALLAS=1``, and in place of K4 under
    ``INFODIFF_DISABLE_FUSED_LATENT_TRAJ=1``. Pure: the CPU and the card
    decide alike."""
    if (os.environ.get("INFODIFF_DISABLE_PALLAS") == "1"
            or not latent_a_dim_ok(a_dim, w_dtype)):
        return "torch"
    if per_forward_wanted:
        return "k5"
    if os.environ.get("INFODIFF_DISABLE_FUSED_LATENT_TRAJ") == "1":
        return "torch"
    return "k4"


def quantize_packed_weights(packed: Dict[str, torch.Tensor]):
    """The int8 weight stream of the turbo tier: per-(layer, output column)
    symmetric int8 of the packed ``W`` [L, 5d, 4d], f32 divide, round half
    to even, clip to +-127. Returns ``packed`` with ``W`` int8 and a new
    ``Wsc`` [L, 4d] f32 scale table; zero padding stays exact zeros."""
    W = packed["W"].to(torch.float32)
    sc = _per_127(W.abs().amax(dim=1))
    Wq = torch.clamp(torch.round(W / sc[:, None, :]), -127.0, 127.0)
    return {**packed, "W": Wq.to(torch.int8), "Wsc": sc}


def latent_int8_tiles(W: torch.Tensor) -> torch.Tensor:
    """K4's int8 weight stream as the kernel reads it: W int8 [L, 5d, 4d]
    (rows padded with zeros to 64 kt, kt = 4d / 64 + ceil(d / 64)) as
    [L, d / 16, kt, 64, 64] tiles, one per (layer, 64-column unit, 64-row K
    tile), each a contiguous 4 KB bulk copy: row m of a tile is output
    column 64 u + m, and its 64 bytes are ordered so that the consumer
    thread t of a warp loads its A fragments of the four k16 steps with one
    16-byte load: byte 16 t + 4 kk + 2 hh + e holds k = 16 kk + 8 hh + 2 t
    + e."""
    L, win, h = W.shape
    d = win - h
    kt = h // 64 + -(-d // 64)
    Wp = torch.zeros((L, kt * 64, h), dtype=torch.int8, device=W.device)
    Wp[:, :win] = W
    # k = 64 T + 16 kk + 8 hh + 2 t + e, column = 64 u + m
    t = Wp.view(L, kt, 4, 2, 4, 2, h // 64, 64)
    return t.permute(0, 6, 1, 7, 4, 2, 3, 5).contiguous().view(
        L, h // 64, kt, 64, 64)


def sampling_coefficients(sched: Schedule, idxs: torch.Tensor,
                          deterministic: bool):
    """Per-step (cx, ce, cn), each [S] f32, for
    ``x' = cx * x + ce * eps + cn * noise`` at timestep ``idxs[i]``: the
    algebra of ``ddim_step`` (deterministic, eta 0.01) or ``ddpm_step``,
    with the idx == 0 specials, in f32 as the JAX package computes it."""
    ab = sched.alpha_bars[idxs]
    apb = sched.alpha_prev_bars[idxs]
    if deterministic:
        prev = torch.clamp(idxs - 1, min=0)
        apb_prev = sched.alpha_prev_bars[prev]
        ab_prev = sched.alpha_bars[prev]
        beta_prev = sched.betas[prev]
        sigma = (DEFAULT_ETA * torch.sqrt((1.0 - apb_prev) / (1.0 - ab_prev))
                 * torch.sqrt(beta_prev))
        cx = torch.sqrt(apb_prev) / torch.sqrt(apb)
        ce = (torch.sqrt(1.0 - apb_prev - sigma**2)
              - torch.sqrt(apb_prev) * torch.sqrt(1.0 - apb) / torch.sqrt(apb))
        cn = sigma
        # idx == 0 returns the x0 estimate, which is exactly x (apb[0] == 1)
        last = idxs == 0
        cx = torch.where(last, torch.ones_like(cx), cx)
        ce = torch.where(last, torch.zeros_like(ce), ce)
        cn = torch.where(last, torch.zeros_like(cn), cn)
    else:
        beta = sched.betas[idxs]
        alpha = sched.alphas[idxs]
        inv_sqrt_a = torch.sqrt(1.0 / alpha)
        cx = inv_sqrt_a
        ce = -inv_sqrt_a * beta / torch.sqrt(1.0 - ab)
        cn = torch.sqrt((1.0 - apb) / (1.0 - ab) * beta)
        cn = torch.where(idxs == 0, torch.zeros_like(cn), cn)
    return cx, ce, cn


def reverse_coefficients(sched: Schedule, idxs: torch.Tensor):
    """Coefficients of the deterministic encoding step: cn = 0."""
    apb = sched.alpha_prev_bars[idxs]
    apb_next = sched.alpha_prev_bars[idxs + 1]
    cx = torch.sqrt(apb_next) / torch.sqrt(apb)
    ce = (torch.sqrt(1.0 - apb_next)
          - torch.sqrt(apb_next) * torch.sqrt(1.0 - apb) / torch.sqrt(apb))
    return cx, ce, torch.zeros_like(cx)


def latent_trajectory_reference(xT, coef, W, c_all, noises, bias, gamma,
                                beta, Wsc=None) -> torch.Tensor:
    """Plain PyTorch K4: S steps of the packed LatentUNet plus the affine
    update. xT [B, d]; coef [S, 3]; W [L, 5d, 4d]; c_all [S, L, 4d];
    noises [S, B, d]; bias/gamma/beta [L, 4d]; Wsc [L, 4d] with int8 W
    (the products then take bf16-rounded inputs and scale each column of
    the f32 sum before the bias). Returns [B, d] f32."""
    d = xT.shape[1]
    L = W.shape[0]
    wdtype = torch.bfloat16 if W.dtype == torch.int8 else W.dtype
    Wf = W.to(torch.float32)

    def mm(a, w):  # inputs rounded to W's dtype, f32 accumulation
        return a.to(wdtype).to(torch.float32) @ w

    x = xT.to(torch.float32)
    for i in range(coef.shape[0]):
        hcur = None
        for j in range(L):
            if j == 0:
                z = mm(x, Wf[0, :d])
            else:
                z = mm(torch.cat([hcur, x], dim=1), Wf[j])
            if Wsc is not None:
                z = z * Wsc[j]
            z = z + bias[j]
            if j < L - 1:
                z = z * c_all[i, j]
                mu = z.mean(dim=1, keepdim=True)
                var = (z - mu).square().mean(dim=1, keepdim=True)
                z = (z - mu) * torch.rsqrt(var + EPS) * gamma[j] + beta[j]
                hcur = F.silu(z)
            else:
                eps = z[:, :d]
        x = coef[i, 0] * x + coef[i, 1] * eps + coef[i, 2] * noises[i]
    return x


def latent_trajectory_cuda(xT, coef, W, c_all, noises, bias, gamma,
                           beta, Wsc=None) -> torch.Tensor:
    """Launch K4 (arguments as for the plain version). Raises on what the
    kernel does not take."""
    _lib.check_tensor(xT, "xT", dtypes=(torch.float32,))
    B, d = xT.shape
    if W.dtype not in _W_CODES:
        raise ValueError(f"latent trajectory kernel takes f32, bf16 or int8 "
                         f"W, got {W.dtype}")
    if (W.dtype == torch.int8) != (Wsc is not None):
        raise ValueError("int8 W needs its scale table Wsc, and only int8 W "
                         "takes one")
    check_a_dim(d, "latent trajectory kernel")
    L, h = NUM_LAYERS, 4 * d
    S = coef.shape[0]
    f32 = (torch.float32,)
    dev = xT.device
    _lib.check_tensor(W, "W", shape=(L, h + d, h), device=dev)
    _lib.check_tensor(coef, "coef", shape=(S, 3), dtypes=f32, device=dev)
    _lib.check_tensor(c_all, "c_all", shape=(S, L, h), dtypes=f32, device=dev)
    _lib.check_tensor(noises, "noises", shape=(S, B, d), dtypes=f32,
                      device=dev)
    for name, t in (("bias", bias), ("gamma", gamma), ("beta", beta)):
        _lib.check_tensor(t, name, shape=(L, h), dtypes=f32, device=dev)
    if Wsc is not None:
        _lib.check_tensor(Wsc, "Wsc", shape=(L, h), dtypes=f32, device=dev)
    plan = latent_plan_on(dev, B, d, W.dtype, "traj")
    stream = latent_int8_tiles(W) if W.dtype == torch.int8 else W
    out = torch.empty_like(xT)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_latent_traj(
            xT.data_ptr(), coef.data_ptr(), stream.data_ptr(),
            c_all.data_ptr(), noises.data_ptr(), bias.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(),
            Wsc.data_ptr() if Wsc is not None else None, out.data_ptr(),
            scratch.data_ptr(), B, S, L, d, _W_CODES[W.dtype],
            *_plan_args(plan),
            _lib.stream_handle(),
        )
    _lib.check_launch(err, "latent_traj")
    counter = (latent_trajectory_int8_cuda if Wsc is not None
               else latent_trajectory_cuda)
    counter.launches += 1
    return out


latent_trajectory_cuda.launches = 0


def latent_trajectory_int8_cuda(xT, coef, W, c_all, noises, bias, gamma,
                                beta, Wsc) -> torch.Tensor:
    """Launch K4's int8 weight stream (int8 W with its scale table Wsc);
    :func:`latent_trajectory_cuda` counts such launches here."""
    return latent_trajectory_cuda(xT, coef, W, c_all, noises, bias, gamma,
                                  beta, Wsc)


latent_trajectory_int8_cuda.launches = 0


def trajectory_inputs(
    packed: Dict[str, torch.Tensor], sched: Schedule, xT: torch.Tensor,
    generator: Optional[torch.Generator] = None, *, deterministic: bool,
    reverse: bool = False, noises: Optional[torch.Tensor] = None,
):
    """The kernel's operands, built as the JAX wrapper builds them:
    ``(xT, coef, W, c_all, noises, B, G, Be, Wsc)``, all on xT's device
    (Wsc is None unless ``packed`` holds the int8 weight stream).

    The steps walk the full grid T-1..0 (1..T-2 when ``reverse``).
    ``noises`` [S, B, d] injects the per-step draws; otherwise they are
    drawn with ``generator`` on the device (zeros when ``reverse``)."""
    B, d = xT.shape
    dev = xT.device
    idxs = (torch.arange(1, sched.T - 1, device=dev) if reverse
            else torch.arange(sched.T - 1, -1, -1, device=dev))
    S = idxs.shape[0]
    temb = timestep_embedding(idxs, TIME_EMB_CHANNELS)
    temb = F.silu(temb @ packed["te0_k"] + packed["te0_b"])
    temb = temb @ packed["te1_k"] + packed["te1_b"]
    s = F.silu(temb).to(torch.float32)  # [S, d]
    c_all = 1.0 + (
        torch.einsum("sd,ldh->slh", s, packed["Wc"].to(torch.float32))
        + packed["Bc"][None, :, :]
    )
    if reverse:
        cx, ce, cn = reverse_coefficients(sched, idxs)
    else:
        cx, ce, cn = sampling_coefficients(sched, idxs, deterministic)
    coef = torch.stack([cx, ce, cn], dim=1).contiguous()
    if noises is None:
        if reverse:
            noises = torch.zeros((S, B, d), dtype=torch.float32, device=dev)
        else:
            noises = torch.randn((S, B, d), generator=generator, device=dev)
    return (xT.to(torch.float32).contiguous(), coef, packed["W"],
            c_all.contiguous(), noises.to(torch.float32).contiguous(),
            packed["B"], packed["G"], packed["Be"], packed.get("Wsc"))


def latent_trajectory(packed, sched, xT, generator=None, **kw) -> torch.Tensor:
    """Run a whole latent trajectory: K4 for a CUDA ``xT``, the plain
    version for a CPU one. Keyword arguments as for
    :func:`trajectory_inputs`. Returns [B, d] in xT's dtype."""
    args = trajectory_inputs(packed, sched, xT, generator, **kw)
    run = latent_trajectory_cuda if xT.is_cuda else latent_trajectory_reference
    return run(*args).to(xT.dtype)
