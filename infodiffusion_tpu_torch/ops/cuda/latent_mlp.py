"""Packed LatentUNet weights for the trajectory kernel (K4).

Counterpart of ``pack_latent_unet_params`` in
``infodiffusion_tpu/ops/pallas/latent_mlp.py``. That module's own
per-forward kernel (K5, ``latent_unet_forward_pallas``) is not ported yet.

Layer uniformisation as in the JAX package: weights zero-padded to
[L, 5d, 4d] in [in, out] layout (layer 0 fills rows :d, layer 9 columns
:d), so every layer is one [rows, 5d] x [5d, 4d] product and the padding
contributes exact zeros.
"""

from __future__ import annotations

from typing import Dict

import torch

from infodiffusion_tpu_torch.models.latent_unet import NUM_LAYERS


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
