"""K3a and K3b: flash-attention forward and backward, CUDA kernels and
their plain versions.

Replace ``infodiffusion_tpu/ops/pallas/flash_attention.py``: K3a the
forward (``_kernel`` / ``_fwd_call``), kernel ``csrc/flash_attention.cu``;
K3b the backward (``_bwd_kernel`` / ``_bwd_call``), kernel
``csrc/flash_attention_bwd.cu``. Both take C = 128 and any N; the TPU
envelopes (``_FWD_PLAN_LIMIT``, ``_ACC_BUDGET`` and the dense fallback)
were VMEM limits and are gone.

Forward contract (``_kernel``, the same as K2's): f32 logits times
C^-1/2, f32 softmax, the weights rounded to v's dtype before PV, f32
accumulation, the output in v's dtype. Its plain version is
``attention_reference``.

Backward contract (``_bwd_kernel``): w recomputed in f32,
``dp = do v^T``, ``delta = rowsum(w dp)``, ``ds = w (dp - delta) scale``,
then ``dq = ds_c k``, ``dk = ds_c^T q``, ``dv = w_c^T do`` with ds rounded
to q's dtype and w to v's, accumulated in f32. In bf16 that differs from
autograd of ``attention_reference`` (which rounds dp through the cast);
the plain version ``flash_attention_bwd_reference`` follows the kernel.

The products bound both kernels at the model's shapes: bf16 runs them on
the tensor cores (``mma.sync``, f32 accumulation, ``csrc/flash_mma.cuh``),
f32 as FMAs on f32 tiles (``csrc/flash_common.cuh``).
"""

from __future__ import annotations

import torch

from infodiffusion_tpu_torch.ops.cuda import library as _lib

CHANNELS = 128  # the only C the flash kernels are compiled for


def flash_attention_bwd_reference(q, k, v, do):
    """Plain PyTorch K3b: (dq, dk, dv) for q, k, v, do [B, N, C]."""
    f32 = torch.float32
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.to(f32) for t in (q, k, v, do))
    w = torch.softmax(torch.einsum("bnc,bmc->bnm", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bnc,bmc->bnm", dof, vf)
    delta = (w * dp).sum(dim=-1, keepdim=True)
    ds = (w * (dp - delta)) * scale
    ds_c = ds.to(q.dtype).to(f32)
    w_c = w.to(v.dtype).to(f32)
    dq = torch.einsum("bnm,bmc->bnc", ds_c, kf)
    dk = torch.einsum("bnm,bnc->bmc", ds_c, qf)
    dv = torch.einsum("bnm,bnc->bmc", w_c, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(tensors, names):
    q = tensors[0]
    _lib.check_tensor(q, names[0], dtypes=tuple(_lib.DTYPE_CODES))
    if q.ndim != 3 or q.shape[-1] != CHANNELS or q.shape[1] == 0:
        raise ValueError(f"flash attention kernels take [B, N>0, {CHANNELS}],"
                         f" got {tuple(q.shape)}")
    for name, t in zip(names[1:], tensors[1:]):
        _lib.check_tensor(t, name, shape=q.shape, dtypes=(q.dtype,),
                          device=q.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Launch K3a on contiguous CUDA q, k, v [B, N, 128] of one dtype (f32
    or bf16). Raises on anything else."""
    _check((q, k, v), ("q", "k", "v"))
    B, N, C = q.shape
    out = torch.empty_like(v)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, C,
            _lib.DTYPE_CODES[q.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, do):
    """Launch K3b on contiguous CUDA q, k, v, do [B, N, 128] of one dtype;
    returns (dq, dk, dv). Raises on anything else."""
    _check((q, k, v, do), ("q", "k", "v", "do"))
    B, N, C = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rowstats = torch.empty((B, N, 3), dtype=torch.float32, device=q.device)
    lib = _lib.library().lib
    with torch.cuda.device(q.device):
        err = lib.infodiff_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rowstats.data_ptr(),
            B, N, C, _lib.DTYPE_CODES[q.dtype], _lib.stream_handle(),
        )
    _lib.check_launch(err, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
