"""The port's high-resolution attention held against the JAX package on the
CPU: the route between K2, K3a and K3c as the JAX ``flash_attention``
computes it from (N, C, dtype) and its gate; K3c's plain version against
``flash_attention_online`` (Pallas, interpret mode) tile for tile; the
gradients through the online route and K3b's plain version at C = 256 and
512; and a narrow 64px InfoDiff with the online route forced on the port's
side (its plan limit patched, as ``tests/test_flash_attention.py`` patches
the JAX one), against the JAX model, which runs the dense attention on the
CPU. Inputs and params from numpy seeds; tolerances as stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion.samplers import strided_ddim_loop as j_ddim
from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.ops.attention import _attention_xla
from infodiffusion_tpu.ops.pallas import flash_attention as jfa
from infodiffusion_tpu_torch.diffusion.samplers import strided_ddim_loop
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.interop import to_state_dict
from infodiffusion_tpu_torch.models.wrappers import InfoDiff
from infodiffusion_tpu_torch.ops import attention as pattn
from infodiffusion_tpu_torch.ops.cuda import flash_attention as pfa
from infodiffusion_tpu_torch.train.step import loss_and_grads
from torch_parity import (
    FORWARD_TOL,
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# K3c's plain version against the Pallas kernel with the same tiles: f32
# differs by summation order; bf16 rounds the same p at the same points
ONLINE_F32_TOL, ONLINE_BF16_TOL = 2e-5, 1e-2
GRAD_TOL, NOISE_FLOOR = 2e-3, 1e-4  # as tests/test_torch_train.py


def _qkv(B, N, C, seed, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, C).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("dtype,N,C,bq,bk", [
    ("float32", 256, 128, 64, 64),
    ("float32", 384, 32, 128, 128),
    ("float32", 512, 64, None, None),
    ("bfloat16", 512, 128, 128, 128),
])
def test_online_plain_matches_pallas(dtype, N, C, bq, bk):
    pdt, jdt = DTYPES[dtype]
    q, k, v = _qkv(2, N, C, seed=N + C)
    want = jfa.flash_attention_online(
        *(jnp.asarray(t, jdt) for t in (q, k, v)), block_q=bq, block_k=bk,
        interpret=True)
    got = pfa.flash_attention_online_reference(
        *(tensor(t).to(pdt) for t in (q, k, v)), block_k=bk)
    assert got.dtype == pdt
    tol = ONLINE_F32_TOL if dtype == "float32" else ONLINE_BF16_TOL
    assert_close(got.float(), np.asarray(want, np.float32), tol, "K3c plain")


def _jax_plan(n, c, jdtype):
    """``flash_attention``'s choice, from the JAX package's own planners."""
    bq = jfa._pick_block_q(n, c)
    if n % bq == 0:
        try:
            jfa._check_envelope(jax.ShapeDtypeStruct((1, n, c), jdtype), bq)
            return "flash"
        except NotImplementedError:
            pass
    obq, obk = jfa._pick_online_tiles(n)
    return "attention" if n % obq or n % obk else "flash_online"


ROUTE_N = (256, 320, 384, 512, 513, 520, 1024, 2048, 3072, 4096, 6144, 8192,
           12288, 16384, 24576, 32768)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_route_matches_jax_plan(dtype):
    pdt, jdt = DTYPES[dtype]
    for name in ("_LOGITS_BUDGET", "_FWD_PLAN_LIMIT", "_ONLINE_BQ",
                 "_ONLINE_BK"):
        assert getattr(pfa, name) == getattr(jfa, name), name
    for n in ROUTE_N:
        assert pfa._pick_online_tiles(n) == jfa._pick_online_tiles(n), n
        for c in (64, 128, 256, 512):
            assert pfa._pick_block_q(n, c) == jfa._pick_block_q(n, c)
            assert pfa.flash_plan(n, c, pdt) == _jax_plan(n, c, jdt), (n, c)


def test_route_switch_points(monkeypatch):
    """The switch depends on C and dtype, not on N alone."""
    monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
    monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
    f32, bf16 = torch.float32, torch.bfloat16
    route = pfa.flash_route
    assert route(8192, 128, f32) == "flash_online"
    assert route(8192, 128, bf16) == "flash"
    assert route(16384, 128, bf16) == "flash_online"  # 512px, level 2
    assert route(4096, 128, bf16) == "flash"
    assert route(8192, 256, bf16) == "flash_online"
    assert route(4096, 256, bf16) == "flash"
    assert route(4096, 512, bf16) == "flash_online"
    assert route(2048, 512, bf16) == "flash"
    assert route(256, 512, bf16) == "attention"  # below the gate
    assert route(513, 128, bf16) == "attention"  # no tile divides 513


def test_route_gate_matches_jax(monkeypatch):
    """INFODIFF_FLASH_ATTN_MIN_TOKENS and INFODIFF_DISABLE_FLASH_ATTENTION
    gate the port as they gate the JAX package on its device."""
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")

    def jax_route(n, c):
        return (_jax_plan(n, c, jnp.bfloat16) if jfa.flash_enabled(n)
                else "attention")

    for env in ({}, {"INFODIFF_FLASH_ATTN_MIN_TOKENS": "128"},
                {"INFODIFF_FLASH_ATTN_MIN_TOKENS": "4096"},
                {"INFODIFF_DISABLE_FLASH_ATTENTION": "1"}):
        monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
        monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for n in (64, 128, 256, 512, 4096, 8192, 16384):
            for c in (128, 512):
                assert pfa.flash_route(n, c, torch.bfloat16) == jax_route(
                    n, c), (env, n, c)
    monkeypatch.setenv("INFODIFF_DISABLE_FLASH_ATTENTION", "1")
    assert {pfa.flash_route(n, 128, torch.float32)
            for n in (512, 8192, 16384)} == {"attention"}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_route_at_c64_matches_jax(dtype, monkeypatch):
    """C = 64 (the InfoDiff at ch 32) takes the route the JAX planner
    gives it: K2 at the mnist and chairs sites, then K3a or K3c."""
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu")
    pdt, jdt = DTYPES[dtype]
    for env in ({}, {"INFODIFF_FLASH_ATTN_MIN_TOKENS": "64"},
                {"INFODIFF_DISABLE_FLASH_ATTENTION": "1"}):
        monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
        monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for n in (16, 64, 256, 1024, 4096, 16384, 32768, 65536):
            want = (_jax_plan(n, 64, jdt) if jfa.flash_enabled(n)
                    else "attention")
            assert pfa.flash_route(n, 64, pdt) == want, (env, n)
    monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION")
    monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
    assert {pfa.flash_route(n, 64, pdt) for n in (16, 64, 256)} == {
        "attention"}


def _force_online(monkeypatch, min_tokens=64):
    """The port's route as JAX's test forces it: the primary plan can hold
    nothing, so every N from ``min_tokens`` whose online tiles divide it
    takes K3c; returns the calls of each plain version, by route and N."""
    monkeypatch.delenv("INFODIFF_DISABLE_FLASH_ATTENTION", raising=False)
    monkeypatch.setenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", str(min_tokens))
    monkeypatch.setattr(pfa, "_FWD_PLAN_LIMIT", 1)
    calls = []

    def counting(route, fn):
        def run(q, k, v):
            calls.append((route, q.shape[1]))
            return fn(q, k, v)
        return run

    for route, (kernel, plain) in list(pfa._FORWARDS.items()):
        monkeypatch.setitem(pfa._FORWARDS, route,
                            (kernel, counting(route, plain)))
    return calls


def test_online_route_grads_match_jax(monkeypatch):
    """f32: the port's Function on the online route (K3c's plain forward,
    K3b's plain backward) against JAX's gradient of
    ``flash_attention_online`` (interpret)."""
    calls = _force_online(monkeypatch)
    q, k, v, do = _qkv(2, 256, 128, seed=70, n=4)
    _, vjp = jax.vjp(functools.partial(jfa.flash_attention_online,
                                       block_q=64, block_k=64,
                                       interpret=True), q, k, v)
    want = vjp(jnp.asarray(do))
    leaves = [tensor(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(pattn.single_head_attention(*leaves), leaves,
                              tensor(do))
    assert calls == [("flash_online", 256)]
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, 5e-4, what)


@pytest.mark.parametrize("C", [256, 512])
def test_flash_backward_plain_wide_matches_jax_vjp(C):
    """K3b's plain version at the vanilla UNet's and the VAE's widths
    against the JAX dense VJP, f32."""
    q, k, v, do = _qkv(2, 64, C, seed=C, n=4)
    _, vjp = jax.vjp(_attention_xla, q, k, v)
    want = vjp(jnp.asarray(do))
    got = pfa.flash_attention_bwd_reference(
        *(tensor(t) for t in (q, k, v, do)))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, FORWARD_TOL, what)


# the slice: an InfoDiff at 64px, ch 32, so level 2 attends over N = 256
# tokens (C = 64), which the online tiles divide, and the middle block
# over N = 64, which they do not
A_DIM, T, B, SIZE, STEPS = 32, 50, 2, 64, 5
SLICE_KW = dict(T=T, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
                encoder_channels=32, num_res_blocks=1, mmd_weight=0.1)


@pytest.fixture(scope="module")
def slice_models():
    rng = np.random.RandomState(71)
    jm = JInfoDiff(**SLICE_KW)
    x = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    params = randomize(init_variables(jm, x, 0, method=JInfoDiff.loss_fn)[
        "params"], seed=72)
    return jm, params, port(InfoDiff(**SLICE_KW), params)


def test_slice_online_route_matches_jax(slice_models, monkeypatch):
    jm, params, model = slice_models
    calls = _force_online(monkeypatch)
    rng = np.random.RandomState(73)
    x = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    a = rng.randn(B, A_DIM).astype(np.float32)
    t = np.array([3, 41], np.int32)

    # forward
    want = jax.jit(lambda x_, t_, a_: jm.apply({"params": params}, x_, t_,
                                               a_))(x, t, a)
    with torch.no_grad():
        got = model(tensor(x), tensor(t).long(), tensor(a))
    assert_close(got, want, FORWARD_TOL, "forward")
    # the UNet's down and up blocks at level 2 (1 + 2 with one ResBlock a
    # level) take K3c, its middle block K2 (the online tiles stop at 128
    # keys and do not divide 64)
    assert sorted(calls) == [("attention", 64)] + [("flash_online", 256)] * 3

    # DDIM-5
    eps_fn = lambda x_, t_, a_: jm.apply({"params": params}, x_, t_, a_)  # noqa
    want = jax.jit(lambda x_, a_: j_ddim(
        eps_fn, j_schedule(1e-5, 1e-2, T), x_, jr.PRNGKey(0), a_,
        num_steps=STEPS))(x, a)
    with torch.no_grad():
        got = strided_ddim_loop(model, make_schedule(1e-5, 1e-2, T),
                                tensor(x), None, tensor(a), num_steps=STEPS)
    assert_close(got, want, TRAJECTORY_TOL, "DDIM-5")

    # one loss_and_grads, every gradient leaf
    d = dict(t=t, eps=rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
             reparam_eps=rng.randn(B, A_DIM).astype(np.float32),
             prior_samples=rng.randn(B, A_DIM).astype(np.float32))
    calls.clear()

    def jloss(p):
        return jm.apply({"params": p}, x, 0, method=JInfoDiff.loss_fn,
                        deterministic=True, **d)

    (want_loss, _), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    draws = {k: tensor(v) for k, v in d.items()}
    draws["t"] = draws["t"].long()
    loss, _, grads = loss_and_grads(model, tensor(x), 0, deterministic=True,
                                    **draws)
    assert_close(loss, want_loss, FORWARD_TOL, "loss")
    # the Encoder attends at level 2 and in its middle block too
    assert sorted(calls) == [("attention", 64)] * 2 + [
        ("flash_online", 256)] * 6
    want_by_name = to_state_dict(want_grads)
    floor = NOISE_FLOOR * max(float(w.abs().max())
                              for w in want_by_name.values())
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want_by_name[name].numpy()
        err = float(np.abs(g.numpy() - w).max()) / max(np.abs(w).max(), floor)
        assert err <= GRAD_TOL, f"grad {name}: relative error {err:.3g}"
