"""The port's attention gradient against the JAX package's: the backward
route (``bwd_route``) against what JAX's planner does at the switch points,
the bf16 gradient of ``single_head_attention`` against ``jax.vjp`` of the
dense attention below the flash backward's plan and against the Pallas
backward within it, the dense contract's plain version in f32, and the bf16
forwards' launch plan (``flash_launch_plan``). All on the CPU, small sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.ops.attention import _attention_xla
from infodiffusion_tpu.ops.pallas import flash_attention as jfa
from infodiffusion_tpu_torch.ops import attention as pattn
from infodiffusion_tpu_torch.ops.cuda import flash_attention as pfa
from torch_parity import OP_TOL, assert_close, tensor

torch.set_num_threads(2)

# max error over max |JAX| of the bf16 gradient, same contract: bf16
# roundings of single elements (dp, the cotangents' casts) that land on the
# other side of a tie; the K3b contract misses this bar below the plan
# (5-7e-3 at the shapes below)
BF16_GRAD_TOL = 3e-3
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100


def _qkvdo(B, N, C, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, C).astype(np.float32) for _ in range(4)]


def _jax_bwd_route(n, c, dtype):
    """The gradient JAX's ``single_head_attention`` takes at [1, n, c]: the
    Pallas backward where its forward is a flash kernel and ``_bwd_call``
    takes the shape, else the dense autodiff; decided by JAX's own code on
    abstract arrays (``eval_shape``), so nothing is computed. The gate is
    the token threshold alone (``flash_enabled`` also asks for a TPU)."""
    if n < jfa.flash_min_tokens():
        return "dense"
    spec = jax.ShapeDtypeStruct((1, n, c), dtype)
    try:
        jax.eval_shape(functools.partial(jfa.flash_attention, interpret=True),
                       spec, spec, spec)
        jax.eval_shape(functools.partial(jfa._bwd_call, interpret=True),
                       spec, spec, spec, spec)
    except NotImplementedError:
        return "dense"
    return "flash"


@pytest.mark.parametrize("n,c", [
    (64, 128), (256, 128), (511, 128), (512, 128), (1024, 128), (4096, 128),
    (8192, 128), (16384, 128), (2048, 256), (4096, 256), (1024, 512),
    (2048, 512), (1001, 128), (520, 128), (1024, 64), (8192, 64)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bwd_route_matches_jax_plan(monkeypatch, n, c, dtype):
    monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
    monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
    got = pfa.bwd_route(n, c, getattr(torch, dtype))
    assert got == _jax_bwd_route(n, c, jnp.dtype(dtype)), (n, c, dtype)


def test_bwd_route_switch_points(monkeypatch):
    """The switch points at C = 128 bf16: dense below 512 tokens, flash
    at N = 1024 and 4096, dense from 8192; N not divisible by 8 dense."""
    monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
    monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
    route = functools.partial(pfa.bwd_route, c=128, dtype=torch.bfloat16)
    assert [route(n) for n in (64, 256, 511, 1024, 4096, 8192, 16384)] == [
        "dense"] * 3 + ["flash"] * 2 + ["dense"] * 2
    assert route(1001) == "dense"
    monkeypatch.setenv("INFODIFF_DISABLE_FLASH_ATTENTION", "1")
    assert route(1024) == "dense"


@pytest.mark.parametrize("B,N,C", [(2, 256, 128), (4, 64, 128), (2, 256, 256)])
def test_bf16_grad_matches_jax_dense_vjp(B, N, C):
    """Below the flash gate the port's bf16 gradient is XLA's autodiff of
    the dense attention (dp rounded to bf16, ds in f32 into dq and dk)."""
    q, k, v, do = _qkvdo(B, N, C, seed=N + C)
    jq, jk, jv, jdo = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do))
    want = jax.vjp(_attention_xla, jq, jk, jv)[1](jdo)
    leaves = [tensor(t).to(torch.bfloat16).requires_grad_(True)
              for t in (q, k, v)]
    assert pattn.bwd_route(N, C, torch.bfloat16) == "dense"
    got = torch.autograd.grad(pattn.single_head_attention(*leaves), leaves,
                              tensor(do).to(torch.bfloat16))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16
        assert_close(g.float(), np.asarray(w, np.float32), BF16_GRAD_TOL,
                     what)


def test_bf16_grad_flash_route_matches_jax_flash_bwd():
    """At N = 1024 (C = 128) JAX differentiates its flash forward with the
    Pallas backward (``_flash_bwd`` -> ``_bwd_call``), and so does the
    port (K3b's contract)."""
    q, k, v, do = _qkvdo(1, 1024, 128, seed=5)
    jq, jk, jv, jdo = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, do))
    want = jax.vjp(functools.partial(jfa.flash_attention, interpret=True),
                   jq, jk, jv)[1](jdo)
    leaves = [tensor(t).to(torch.bfloat16).requires_grad_(True)
              for t in (q, k, v)]
    assert pattn.bwd_route(1024, 128, torch.bfloat16) == "flash"
    got = torch.autograd.grad(pattn.single_head_attention(*leaves), leaves,
                              tensor(do).to(torch.bfloat16))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g.float(), np.asarray(w, np.float32), BF16_GRAD_TOL,
                     what)


@pytest.mark.parametrize("C", [64, 128, 512])
def test_dense_bwd_reference_matches_f32_vjp(C):
    q, k, v, do = _qkvdo(2, 64, C, seed=C)
    want = jax.vjp(_attention_xla, q, k, v)[1](do)
    got = pfa.attention_dense_bwd_reference(*(tensor(t) for t in (q, k, v,
                                                                  do)))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        assert_close(g, w, OP_TOL, what)


def test_dense_and_flash_contracts_coincide_in_f32():
    q, k, v, do = (tensor(t) for t in _qkvdo(2, 128, 128, seed=3))
    for a, b in zip(pfa.attention_dense_bwd_reference(q, k, v, do),
                    pfa.flash_attention_bwd_reference(q, k, v, do)):
        assert_close(a, b.numpy(), 1e-5)


def test_backward_for_picks_the_contracts_plain_version():
    assert pfa.backward_for("dense", False) is (
        pfa.attention_dense_bwd_reference)
    assert pfa.backward_for("flash", False) is (
        pfa.flash_attention_bwd_reference)
    assert set(pfa.flash_attention_bwd_cuda.launches_by_contract) == {
        "flash", "dense"}
    q = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match="CUDA"):
        pfa.backward_for("dense", True)(q, q, q, q)


# the shapes chip_smoke.py times K3a and K3c at, and the 512px / vanilla
# paths' calls
PLAN_SHAPES = [(8, 16384, 128), (2, 16384, 256), (8, 4096, 512),
               (2, 4096, 64), (8, 4096, 128), (32, 1024, 256),
               (16, 1024, 512), (8, 1024, 64), (64, 1024, 128),
               (4, 4096, 256), (4, 1024, 512), (1, 4096, 128), (1, 16384, 128),
               (2, 1000, 64), (3, 77, 128)]


@pytest.mark.parametrize("C", [64, 128, 256, 512])
def test_flash_launch_plan_fits_and_covers(C):
    for B, N, _ in PLAN_SHAPES:
        p = pfa.flash_launch_plan(B, N, C, torch.bfloat16)
        assert p["smem"] <= SMEM_LIMIT, (B, N, C, p)
        assert p["blocks"] == B * -(-N // p["bq"]), (B, N, C, p)
        assert p["blocks"] * p["bq"] >= B * N, (B, N, C, p)
        assert p["bq"] == 64 * (1 if C == 512 else p["warpgroups"])
        assert p["stages"] >= 2 and p["threads"] == 128 * (
            p["warpgroups"] + 1)
        if C < 512 and B * -(-N // 128) >= pfa.SMS:
            assert p["bq"] == 128
    with pytest.raises(ValueError, match="bf16"):
        pfa.flash_launch_plan(1, 64, C, torch.float32)
