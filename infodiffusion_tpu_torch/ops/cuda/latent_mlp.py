"""K5: one LatentUNet forward per launch, a CUDA kernel and its plain
version; and what K4 and K5 share: the packed weights and the cluster
core's launch plan.

Replaces ``infodiffusion_tpu/ops/pallas/latent_mlp.py``
(``latent_unet_forward_pallas``, ``_kernel``; ``pack_latent_unet_params``,
``fused_latent_supported``, ``use_fused_latent``, ``latent_eps_fn``).
Kernel: ``csrc/latent_mlp.cu`` on the cluster core of
``csrc/latent_common.cuh`` (K4's): a thread-block cluster owns a row group
and each of its ranks streams only its columns of W and Wc, so each weight
is read once per row group, not once per batch row; see the sources for
what bounds it and the design.

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

import ctypes
import functools
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

# W dtype codes of csrc/common.cuh
_W_CODES = {**_lib.DTYPE_CODES, torch.int8: 2}

EPS = 1e-5
MAX_A_DIM = 1024
MAX_F32_A_DIM = 768    # f32 W: beyond it no plan fits the shared memory
# the cluster core's launch arithmetic (csrc/latent_common.cuh make_plan)
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use
_ALIGN = 1024          # the 128-byte swizzle's atoms
_MAX_RANKS = 16        # blocks a cluster (non-portable size)
_MAX_STAGES = 16
_BAR_BYTES = 8 * (2 * _MAX_STAGES + 4)
_F32_PITCH = 68        # floats a row of an f32 panel chunk
_TILE_BYTES = {torch.float32: 64 * 64 * 4, torch.bfloat16: 64 * 64 * 2,
               torch.int8: 64 * 64}  # a 64 x 64 K tile of W
_ROWS = {torch.float32: (8, 16), torch.bfloat16: (8, 16, 32, 64),
         torch.int8: (8, 16, 32, 64)}
LATENT_THREADS = 160   # a consumer warpgroup and a producer warp


def fused_latent_supported(backbone, a_dim: int) -> bool:
    """True when ``backbone`` (a port ``LatentUNet``) has the architecture
    the packing and the kernels hard-code (10 layers, hidden 4 a_dim,
    layers 0-8 conditioned and normalised, layer 9 plain, two time-embedding
    layers) at an a_dim the cluster core takes (:func:`latent_a_dim_ok`)."""
    if not latent_a_dim_ok(a_dim):
        return False
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


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def latent_cluster_ranks(d: int) -> int:
    """Blocks in one cluster of the core at a_dim ``d``: the fewest units
    of 64 hidden columns a rank (at most 16 ranks), then the fewest ranks
    at that."""
    units = d // 16
    return _cdiv(units, _cdiv(units, _MAX_RANKS))


@functools.lru_cache(maxsize=None)
def latent_launch_plan(B: int, d: int, w_dtype: torch.dtype, kernel: str,
                       sms: int, max_active_clusters: int) -> dict:
    """What the cluster core launches for K4 (``kernel`` "traj") or K5
    ("mlp") at batch ``B``, a_dim ``d`` and W of ``w_dtype``, on a card of
    ``sms`` SMs that co-schedules ``max_active_clusters`` clusters of the
    plan's size (cudaOccupancyMaxActiveClusters).

    A cluster of ``ranks`` blocks owns ``rows`` batch rows (a row group);
    rank r owns the hidden column units (of 64 columns) ``[r *
    units_per_rank, ...)`` of ``units`` = 4d / 64 and, for r <
    ``eps_units`` = ceil(d / 64), the last layer's unit r. ``clusters`` (at
    most ``max_active_clusters``: all resident at once) walk the
    ``groups`` row groups in ``rounds``. Rows: among 8, 16, 32, 64 (f32:
    8, 16) that fit the shared memory with a ring of at least 2 ``stages``,
    the fewest rounds, then the fewest row groups (each reads W once a
    step), then the fewest rows. Also: K tiles of 64 (``k_tiles``,
    ``x_tiles`` of them over x; ``tiles`` a stage of ``stage_bytes``), the
    panel's ``chunk_bytes`` (64 columns of the group's rows), the
    exchanges' ``scratch_bytes``, ``smem`` bytes, ``threads``. Raises
    where no plan fits or the card holds no cluster. Cached: the dict is
    shared, so callers read it only."""
    if kernel not in ("traj", "mlp"):
        raise ValueError(f"kernel is 'traj' (K4) or 'mlp' (K5), got {kernel}")
    if w_dtype not in _ROWS or (kernel == "mlp" and w_dtype == torch.int8):
        raise ValueError(f"latent {kernel} kernel takes no {w_dtype} W")
    check_a_dim(d, f"latent {kernel} kernel")
    if B < 1:
        raise ValueError(f"latent {kernel} kernel: batch {B}")
    units = d // 16
    per = _cdiv(units, _MAX_RANKS)
    ranks = _cdiv(units, per)
    eps_units = _cdiv(d, 64)  # rank r < eps_units owns eps unit r
    kt_h, kt_x = units, eps_units
    cmax = min(max_active_clusters, sms // ranks)
    if cmax < 1:
        raise ValueError(f"the card co-schedules no cluster of {ranks} "
                         f"blocks ({max_active_clusters} active, {sms} SMs)")
    # K tiles a stage: 4 where they divide every layer's K tiles, f32 one
    tiles = (1 if w_dtype == torch.float32 else 4 if kt_x % 4 == 0
             else 2 if kt_x % 2 == 0 else 1)
    stage = tiles * _TILE_BYTES[w_dtype]
    best = None
    for G in _ROWS[w_dtype]:
        chunk = G * _F32_PITCH * 4 if w_dtype == torch.float32 else G * 128
        zpitch = 64 * per + 4
        xstate = G * 64 * 4 if kernel == "traj" else 0
        nparams = 4 if w_dtype == torch.int8 or kernel == "mlp" else 3
        rest = ((kt_h + 2 * kt_x) * chunk + G * zpitch * 4 + xstate
                + nparams * NUM_LAYERS * 64 * per * 4 + ranks * G * 8
                + _BAR_BYTES)
        stages = min(_MAX_STAGES, (_SMEM_LIMIT - _ALIGN - rest) // stage)
        if stages < 2:
            continue
        groups = _cdiv(B, G)
        clusters = min(groups, cmax)
        key = (_cdiv(groups, clusters), groups)
        if best is None or key < best[0]:
            best = (key, dict(
                ranks=ranks, units=units, units_per_rank=per,
                eps_units=eps_units, rows=G,
                groups=groups, clusters=clusters, rounds=key[0],
                k_tiles=kt_h + kt_x, x_tiles=kt_x, chunk_bytes=chunk,
                tiles=tiles, stage_bytes=stage, stages=stages,
                scratch_bytes=clusters * ranks * (per + 1) * chunk,
                smem=_ALIGN + stages * stage + rest, threads=LATENT_THREADS,
                sms=sms, max_active_clusters=cmax))
    if best is None:
        raise ValueError(f"latent {kernel} kernel: no plan fits the shared "
                         f"memory at d={d} in {w_dtype}")
    return best[1]


@functools.lru_cache(maxsize=None)
def _max_active_clusters(kernel: str, w_dtype: torch.dtype, ranks: int,
                         device_index: int) -> int:
    """cudaOccupancyMaxActiveClusters for ``ranks``-block clusters of the
    kernel at the most shared memory (one block an SM)."""
    fn = getattr(_lib.library().lib, f"infodiff_latent_{kernel}_clusters")
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(_W_CODES[w_dtype], ranks, ctypes.byref(n))
    _lib.check_launch(err, f"latent_{kernel}_clusters")
    return n.value


def latent_plan_on(device, B: int, d: int, w_dtype: torch.dtype,
                   kernel: str) -> dict:
    """:func:`latent_launch_plan` for the card ``device`` is on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    active = _max_active_clusters(kernel, w_dtype, latent_cluster_ranks(d),
                                  index)
    return latent_launch_plan(B, d, w_dtype, kernel, sms, active)


def _plan_args(plan: dict):
    """The plan as the C entries take it: what it was made from (sms,
    max_active), then ranks, rows, clusters, stages, smem."""
    return (plan["sms"], plan["max_active_clusters"], plan["ranks"],
            plan["rows"], plan["clusters"], plan["stages"], plan["smem"])


def latent_a_dim_ok(d: int, w_dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the cluster core takes a_dim ``d`` with W of ``w_dtype``: a
    multiple of 16 from 16 to 1024, to 768 with f32 W."""
    top = MAX_F32_A_DIM if w_dtype == torch.float32 else MAX_A_DIM
    return 16 <= d <= top and d % 16 == 0


def check_a_dim(d: int, what: str) -> None:
    """Raise unless the cluster core takes a_dim ``d``."""
    if not latent_a_dim_ok(d):
        raise ValueError(f"{what} takes a_dim a multiple of 16 up to "
                         f"{MAX_A_DIM}, got {d}")


def latent_unet_forward_cuda(x, s, W, Wc, bias, bc, gamma,
                             beta) -> torch.Tensor:
    """Launch K5 (arguments as for the plain version, all contiguous CUDA
    tensors). Raises on what the kernel does not take."""
    f32 = (torch.float32,)
    _lib.check_tensor(x, "x", dtypes=f32)
    B, d = x.shape
    if W.dtype not in _lib.DTYPE_CODES:
        raise ValueError(f"latent MLP kernel takes f32 or bf16 W, got "
                         f"{W.dtype}")
    check_a_dim(d, "latent MLP kernel")
    L, h = NUM_LAYERS, 4 * d
    dev = x.device
    _lib.check_tensor(s, "s", shape=(B, d), dtypes=f32, device=dev)
    _lib.check_tensor(W, "W", shape=(L, h + d, h), device=dev)
    _lib.check_tensor(Wc, "Wc", shape=(L, d, h), dtypes=(W.dtype,),
                      device=dev)
    for name, t in (("bias", bias), ("bc", bc), ("gamma", gamma),
                    ("beta", beta)):
        _lib.check_tensor(t, name, shape=(L, h), dtypes=f32, device=dev)
    plan = latent_plan_on(dev, B, d, W.dtype, "mlp")
    out = torch.empty_like(x)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8, device=dev)
    lib = _lib.library().lib
    with torch.cuda.device(dev):
        err = lib.infodiff_latent_mlp(
            x.data_ptr(), s.data_ptr(), W.data_ptr(), Wc.data_ptr(),
            bias.data_ptr(), bc.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, L, d,
            _lib.DTYPE_CODES[W.dtype],
            *_plan_args(plan),
            _lib.stream_handle(),
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
