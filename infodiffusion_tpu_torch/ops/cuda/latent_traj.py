"""K4: the whole latent DDIM/DDPM/reverse trajectory, a CUDA kernel and its
plain version.

Replaces ``infodiffusion_tpu/ops/pallas/latent_traj.py``
(``latent_trajectory_pallas``, ``_kernel``), the bf16/f32 weight stream.
Kernel: ``csrc/latent_traj.cu``. The plain version runs the same packed
step as some 40 small PyTorch ops per step, 1000 steps; the kernel runs the
step loop and the layer loop inside one launch. On the card the kernel is
bound by streaming the packed weights (26.2 MB in bf16 at a_dim 256) once
per step per block: from L2 in bf16, from HBM in f32. The wrapper picks the
rows per block so the grid covers the SMs.

What stays outside the kernel, as plain torch, as in the JAX package: the
per-step 1 + FiLM rows ``c_all`` (they depend on the timestep only), the
[S, 3] update coefficients ``coef`` and the pre-drawn noise [S, B, d].

The TPU kernel's Mosaic artifacts (the ``a_dim % 32`` gate and the lane
padding) are not ported. The CUDA kernel's own limits: a_dim <= 1024, W in
f32 or bf16. The int8 weight stream (``quantize_packed_weights``, the
turbo tier) is not ported and int8 W is refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.diffusion.schedule import DEFAULT_ETA, Schedule
from infodiffusion_tpu_torch.models.latent_unet import TIME_EMB_CHANNELS
from infodiffusion_tpu_torch.nn.embeddings import timestep_embedding
from infodiffusion_tpu_torch.ops.cuda import library as _lib

EPS = 1e-5
MAX_A_DIM = 1024
_ROW_TILES = (1, 2, 4, 8)


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
                                beta) -> torch.Tensor:
    """Plain PyTorch K4: S steps of the packed LatentUNet plus the affine
    update. xT [B, d]; coef [S, 3]; W [L, 5d, 4d]; c_all [S, L, 4d];
    noises [S, B, d]; bias/gamma/beta [L, 4d]. Returns [B, d] f32."""
    d = xT.shape[1]
    L = W.shape[0]
    wdtype = W.dtype
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


def _row_tile(B: int, device) -> int:
    """Rows per block: the fewest that keep the grid within one wave."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for bt in _ROW_TILES:
        if -(-B // bt) <= sms:
            return bt
    return _ROW_TILES[-1]


def latent_trajectory_cuda(xT, coef, W, c_all, noises, bias, gamma,
                           beta) -> torch.Tensor:
    """Launch K4 (arguments as for the plain version). Raises on what the
    kernel does not take, int8 W included."""
    _lib.check_tensor(xT, "xT", dtypes=(torch.float32,))
    B, d = xT.shape
    if W.dtype not in _lib.DTYPE_CODES:
        raise ValueError(
            f"latent trajectory kernel takes f32 or bf16 W, got {W.dtype} "
            "(the int8 weight stream is not ported)"
        )
    if not 1 <= d <= MAX_A_DIM:
        raise ValueError(f"latent trajectory kernel takes a_dim <= "
                         f"{MAX_A_DIM}, got {d}")
    L, h = W.shape[0], 4 * d
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
    out = torch.empty_like(xT)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_latent_traj(
            xT.data_ptr(), coef.data_ptr(), W.data_ptr(), c_all.data_ptr(),
            noises.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(), B, S, L, d, _row_tile(B, dev),
            _lib.DTYPE_CODES[W.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "latent_traj")
    latent_trajectory_cuda.launches += 1
    return out


latent_trajectory_cuda.launches = 0


def trajectory_inputs(
    packed: Dict[str, torch.Tensor], sched: Schedule, xT: torch.Tensor,
    generator: Optional[torch.Generator] = None, *, deterministic: bool,
    reverse: bool = False, noises: Optional[torch.Tensor] = None,
):
    """The kernel's operands, built as the JAX wrapper builds them:
    ``(xT, coef, W, c_all, noises, B, G, Be)``, all on xT's device.

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
            packed["B"], packed["G"], packed["Be"])


def latent_trajectory(packed, sched, xT, generator=None, **kw) -> torch.Tensor:
    """Run a whole latent trajectory: K4 for a CUDA ``xT``, the plain
    version for a CPU one. Keyword arguments as for
    :func:`trajectory_inputs`. Returns [B, d] in xT's dtype."""
    args = trajectory_inputs(packed, sched, xT, generator, **kw)
    run = latent_trajectory_cuda if xT.is_cuda else latent_trajectory_reference
    return run(*args).to(xT.dtype)
