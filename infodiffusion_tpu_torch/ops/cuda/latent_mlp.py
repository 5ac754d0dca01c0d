"""K5: one LatentUNet forward per launch, a CUDA kernel and its plain
version; and the packed weights K4 and K5 share.

Replaces ``infodiffusion_tpu/ops/pallas/latent_mlp.py``
(``latent_unet_forward_pallas``, ``_kernel``; ``pack_latent_unet_params``,
``fused_latent_supported``, ``use_fused_latent``, ``latent_eps_fn``).
Kernel: ``csrc/latent_mlp.cu``; what bounds it and what its design does
about that: see the source.

Layer uniformisation as in the JAX package: weights zero-padded to
[L, 5d, 4d] in [in, out] layout (layer 0 fills rows :d, layer 9 columns
:d), so every layer is one [rows, 5d] x [5d, 4d] product and the padding
contributes exact zeros.

K5 is the sampler's per-forward route, opt-in as in the JAX package:
``INFODIFF_ENABLE_FUSED_LATENT=1`` makes ``LatentDiffusionProcess`` on a
CUDA model run ``sample_loop`` / ``reverse_sample_loop`` over
:func:`latent_eps_fn` (one K5 launch per step) instead of K4's whole
trajectory; ``INFODIFF_FORCE_FUSED_LATENT=1`` takes that route on any
device (the plain version on the CPU); ``INFODIFF_DISABLE_PALLAS=1`` wins
over both. The time-embedding MLP stays plain torch, as the JAX package
leaves it to XLA.
"""

from __future__ import annotations

import os
from typing import Dict

import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.models.latent_unet import (
    NUM_LAYERS,
    TIME_EMB_CHANNELS,
)
from infodiffusion_tpu_torch.nn.embeddings import timestep_embedding
from infodiffusion_tpu_torch.ops.cuda import library as _lib

EPS = 1e-5
MAX_A_DIM = 1024
_ROW_TILES = (1, 2, 4, 8)


def fused_latent_supported(backbone, a_dim: int) -> bool:
    """True when ``backbone`` (a port ``LatentUNet``) has the architecture
    the packing and the kernels hard-code: 10 layers, hidden 4 a_dim,
    layers 0-8 conditioned and normalised, layer 9 plain, two time-embedding
    layers."""
    for i in range(NUM_LAYERS):
        layer = getattr(backbone, f"layer_{i}", None)
        if layer is None:
            return False
        want_in = a_dim if i == 0 else 5 * a_dim
        want_out = a_dim if i == NUM_LAYERS - 1 else 4 * a_dim
        if tuple(layer.linear.weight.shape) != (want_out, want_in):
            return False
        cond = layer.linear_emb is not None and layer.norm is not None
        if cond != (i < NUM_LAYERS - 1):
            return False
    return (hasattr(backbone, "time_embed_0")
            and hasattr(backbone, "time_embed_1")
            and not hasattr(backbone, f"layer_{NUM_LAYERS}"))


def use_fused_latent(x: torch.Tensor) -> bool:
    """Take the per-forward route (K5) for a model on ``x``'s device (see
    the module docstring for the variables)."""
    if os.environ.get("INFODIFF_DISABLE_PALLAS") == "1":
        return False
    if os.environ.get("INFODIFF_FORCE_FUSED_LATENT") == "1":
        return True
    return os.environ.get("INFODIFF_ENABLE_FUSED_LATENT") == "1" and x.is_cuda


def pack_latent_unet_params(
    backbone, a_dim: int, dtype: torch.dtype = torch.float32
) -> Dict[str, torch.Tensor]:
    """Stack + pad a port ``LatentUNet``'s weights on its device.

    ``dtype`` is the matmul-weight dtype of ``W`` and ``Wc`` (callers pass
    the model's dtype); everything else is f32.
    """
    L, d = NUM_LAYERS, a_dim
    h = 4 * d
    win = h + d
    dev = backbone.layer_0.linear.weight.device
    f32 = dict(dtype=torch.float32, device=dev)
    W = torch.zeros((L, win, h), **f32)
    B = torch.zeros((L, h), **f32)
    Wc = torch.zeros((L, d, h), **f32)
    Bc = torch.zeros((L, h), **f32)
    G = torch.ones((L, h), **f32)
    Be = torch.zeros((L, h), **f32)
    with torch.no_grad():
        for i in range(L):
            layer = getattr(backbone, f"layer_{i}")
            k = layer.linear.weight.detach().to(torch.float32).T  # [in, out]
            b = layer.linear.bias.detach().to(torch.float32)
            if i == 0:
                W[i, :d, :] = k
                B[i] = b
            elif i == L - 1:
                W[i, :, :d] = k
                B[i, :d] = b
            else:
                W[i] = k
                B[i] = b
            if layer.linear_emb is not None:
                Wc[i] = layer.linear_emb.weight.detach().T
                Bc[i] = layer.linear_emb.bias.detach()
            if layer.norm is not None:
                G[i] = layer.norm.weight.detach()
                Be[i] = layer.norm.bias.detach()
        t0, t1 = backbone.time_embed_0, backbone.time_embed_1
        return {
            "W": W.to(dtype), "B": B, "Wc": Wc.to(dtype), "Bc": Bc,
            "G": G, "Be": Be,
            "te0_k": t0.weight.detach().T.contiguous(),
            "te0_b": t0.bias.detach().clone(),
            "te1_k": t1.weight.detach().T.contiguous(),
            "te1_b": t1.bias.detach().clone(),
        }


def latent_unet_forward_reference(x: torch.Tensor, s: torch.Tensor, W, Wc,
                                  bias, bc, gamma, beta) -> torch.Tensor:
    """Plain PyTorch K5: x [B, d] f32, s = silu(time embedding) [B, d]
    f32; W [L, 5d, 4d] and Wc [L, d, 4d] (f32 or bf16); bias, bc, gamma,
    beta [L, 4d] f32. Products take inputs rounded to W's dtype, f32
    accumulation. Returns eps [B, d] f32."""
    d = x.shape[1]
    L = W.shape[0]
    f32 = torch.float32

    def mm(a, w):
        return a.to(W.dtype).to(f32) @ w.to(f32)

    x = x.to(f32)
    s = s.to(f32)
    hcur = None
    for j in range(L):
        z = mm(x, W[0, :d]) if j == 0 else mm(torch.cat([hcur, x], 1), W[j])
        z = z + bias[j]
        if j == L - 1:
            return z[:, :d]
        z = z * (1.0 + (mm(s, Wc[j]) + bc[j]))
        mu = z.mean(dim=1, keepdim=True)
        var = (z - mu).square().mean(dim=1, keepdim=True)
        z = (z - mu) * torch.rsqrt(var + EPS) * gamma[j] + beta[j]
        hcur = F.silu(z)


def _row_tile(B: int, device) -> int:
    """Rows per block: the fewest that keep the grid within one wave."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for bt in _ROW_TILES:
        if -(-B // bt) <= sms:
            return bt
    return _ROW_TILES[-1]


def latent_unet_forward_cuda(x, s, W, Wc, bias, bc, gamma,
                             beta) -> torch.Tensor:
    """Launch K5 (arguments as for the plain version, all contiguous CUDA
    tensors). Raises on what the kernel does not take."""
    f32 = (torch.float32,)
    _lib.check_tensor(x, "x", dtypes=f32)
    B, d = x.shape
    if not 1 <= d <= MAX_A_DIM:
        raise ValueError(f"latent MLP kernel takes a_dim <= {MAX_A_DIM}, "
                         f"got {d}")
    if W.dtype not in _lib.DTYPE_CODES:
        raise ValueError(f"latent MLP kernel takes f32 or bf16 W, got "
                         f"{W.dtype}")
    L, h = W.shape[0], 4 * d
    dev = x.device
    _lib.check_tensor(s, "s", shape=(B, d), dtypes=f32, device=dev)
    _lib.check_tensor(W, "W", shape=(L, h + d, h), device=dev)
    _lib.check_tensor(Wc, "Wc", shape=(L, d, h), dtypes=(W.dtype,),
                      device=dev)
    for name, t in (("bias", bias), ("bc", bc), ("gamma", gamma),
                    ("beta", beta)):
        _lib.check_tensor(t, name, shape=(L, h), dtypes=f32, device=dev)
    out = torch.empty_like(x)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_latent_mlp(
            x.data_ptr(), s.data_ptr(), W.data_ptr(), Wc.data_ptr(),
            bias.data_ptr(), bc.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), B, L, d, _row_tile(B, dev),
            _lib.DTYPE_CODES[W.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "latent_mlp")
    latent_unet_forward_cuda.launches += 1
    return out


latent_unet_forward_cuda.launches = 0


def latent_unet_forward(packed: Dict[str, torch.Tensor], x: torch.Tensor,
                        silu_temb: torch.Tensor) -> torch.Tensor:
    """eps = the packed LatentUNet on x [B, d] with ``silu_temb`` [B, d]:
    K5 for a CUDA ``x``, the plain version for a CPU one. f32 out."""
    args = (x.to(torch.float32).contiguous(),
            silu_temb.to(torch.float32).contiguous(), packed["W"],
            packed["Wc"], packed["B"], packed["Bc"], packed["G"],
            packed["Be"])
    run = (latent_unet_forward_cuda if x.is_cuda
           else latent_unet_forward_reference)
    return run(*args)


def silu_time_embedding(packed: Dict[str, torch.Tensor],
                        t: torch.Tensor) -> torch.Tensor:
    """s = silu(time-embedding MLP(t)) [B, d], K5's per-row condition
    (plain torch)."""
    temb = timestep_embedding(t, TIME_EMB_CHANNELS)
    temb = F.silu(temb @ packed["te0_k"] + packed["te0_b"])
    return F.silu(temb @ packed["te1_k"] + packed["te1_b"])


def latent_eps_fn(packed: Dict[str, torch.Tensor]):
    """``eps_fn(x, t, a=None)`` for the samplers over the packed weights:
    the time-embedding MLP in plain torch, then one K5 forward."""

    def eps(x, t, a=None):
        return latent_unet_forward(packed, x, silu_time_embedding(packed, t))

    return eps
