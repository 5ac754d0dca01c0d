"""The torch port's embeddings, schedule, samplers' grid, MMD and the plain
versions of kernels K1 (adagn, forward and backward), K2 (attention) and
K3a/K3b (flash attention forward and backward), held against the JAX
package on the same numpy inputs. Tolerances: tests/torch_parity.py; bf16
gradients within 2e-2 (one bf16 rounding of the cotangents)."""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion import schedule as jsched
from infodiffusion_tpu.diffusion.samplers import sample_loop as j_sample_loop
from infodiffusion_tpu.diffusion.samplers import strided_ddim_loop as j_strided
from infodiffusion_tpu.nn import embeddings as jemb
from infodiffusion_tpu.ops import mmd as jmmd
from infodiffusion_tpu.ops.attention import _attention_xla
from infodiffusion_tpu.ops.norm import adagn as j_adagn
from infodiffusion_tpu.ops.pallas import latent_traj as jtraj
from infodiffusion_tpu_torch.diffusion import schedule as psched
from infodiffusion_tpu_torch.diffusion.samplers import (
    sample_loop,
    strided_ddim_loop,
    strided_timesteps,
)
from infodiffusion_tpu_torch.nn import embeddings as pemb
from infodiffusion_tpu_torch.ops import attention as pattn
from infodiffusion_tpu_torch.ops import mmd as pmmd
from infodiffusion_tpu_torch.ops import norm as pnorm
from infodiffusion_tpu_torch.ops.cuda import flash_attention as pflash
from infodiffusion_tpu_torch.ops.cuda import latent_traj as ptraj
from infodiffusion_tpu_torch.ops.cuda.adagn import (
    adagn_bwd_cuda,
    adagn_bwd_reference,
    adagn_cuda,
    adagn_reference,
)
from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)
from torch_parity import (
    OP_TOL,
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

T = 1000


@pytest.mark.parametrize("dim", [64, 33])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.0, 17.5, 999.0], np.float32)
    want = jemb.timestep_embedding(jnp.asarray(t), dim)
    assert_close(pemb.timestep_embedding(tensor(t), dim), want, OP_TOL,
                 "timestep_embedding")


def test_time_embedding_module():
    jm = jemb.TimeEmbedding(T=50, d_model=32, dim=64)
    t = np.array([0, 7, 49], np.int32)
    params = randomize(init_variables(jm, t)["params"], seed=1)
    want = jm.apply({"params": params}, jnp.asarray(t))
    pm = port(pemb.TimeEmbedding(50, 32, 64), params)
    assert_close(pm(tensor(t).long()), want, OP_TOL, "TimeEmbedding")
    assert_close(pemb.sinusoidal_table(50, 32), jemb.sinusoidal_table(50, 32),
                 OP_TOL, "sinusoidal_table")


def test_schedule_and_step_algebra():
    js = jsched.make_schedule(1e-5, 1e-2, T)
    ps = psched.make_schedule(1e-5, 1e-2, T)
    for name in js._fields:
        assert_close(getattr(ps, name), getattr(js, name), OP_TOL, name)
    rng = np.random.RandomState(0)
    x, eps, noise = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    X, E, N = (tensor(a) for a in (x, eps, noise))
    for idx in (0, 1, 500, 999):
        ji = jnp.full((3,), idx, jnp.int32)
        pi = torch.full((3,), idx)
        assert_close(psched.ddpm_step(ps, X, pi, E, N),
                     jsched.ddpm_step(js, x, ji, eps, noise), OP_TOL, "ddpm")
        assert_close(psched.ddim_step(ps, X, pi, E, N),
                     jsched.ddim_step(js, x, ji, eps, noise), OP_TOL, "ddim")
        for prev in (idx - 10, -1):
            jp = jnp.full((3,), prev, jnp.int32)
            assert_close(
                psched.strided_ddim_step(ps, X, pi, torch.full((3,), prev),
                                         E, N, eta=0.5),
                jsched.strided_ddim_step(js, x, ji, jp, eps, noise, eta=0.5),
                OP_TOL, f"strided {idx}->{prev}",
            )


@pytest.mark.parametrize("num_steps", [10, 50, 100, 1000])
def test_strided_grid_matches_jax(num_steps):
    """The DDIM-N timesteps must be the JAX ones exactly: an off-by-one
    timestep would pass every tolerance silently."""
    seen = []

    def eps_fn(x, t, a):
        jax.debug.callback(lambda ti: seen.append(int(ti)), t[0],
                           ordered=True)
        return jnp.zeros_like(x)

    js = jsched.make_schedule(1e-5, 1e-2, T)
    jax.block_until_ready(
        jax.jit(lambda x: j_strided(eps_fn, js, x, None,
                                    num_steps=num_steps))(jnp.ones((1, 2)))
    )
    jax.effects_barrier()
    ts, ts_prev = strided_timesteps(T, num_steps)
    assert ts.tolist() == seen
    assert ts_prev.tolist() == seen[1:] + [-1]


def _linear_eps(lib):
    """A stand-in denoiser, the same function of (x, t, a) on both sides."""
    return lambda x, t, a: 0.1 * x + lib.reshape(t, (-1, 1)) / 50.0 + a


@pytest.mark.parametrize("deterministic", [True, False])
def test_sample_loop_matches_jax(deterministic):
    rng = np.random.RandomState(11)
    x, a = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    noises = rng.randn(50, 3, 4).astype(np.float32)
    want = j_sample_loop(_linear_eps(jnp), jsched.make_schedule(1e-5, 1e-2, 50),
                         x, None, a, deterministic=deterministic, noises=noises)
    got = sample_loop(_linear_eps(torch), psched.make_schedule(1e-5, 1e-2, 50),
                      tensor(x), None, tensor(a), deterministic=deterministic,
                      noises=tensor(noises))
    assert_close(got, want, TRAJECTORY_TOL, "sample_loop")


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_strided_ddim_loop_matches_jax(eta):
    """eta 0 against the JAX loop itself; eta > 0 (which the JAX loop can
    only draw itself) against JAX's step algebra with the same noise."""
    rng = np.random.RandomState(12)
    x, a = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(np.float32)
    noises = rng.randn(10, 3, 4).astype(np.float32)
    js = jsched.make_schedule(1e-5, 1e-2, T)
    eps_j = _linear_eps(jnp)
    if eta == 0.0:
        want = j_strided(eps_j, js, x, None, a, num_steps=10)
    else:
        ts, ts_prev = (t.numpy() for t in strided_timesteps(T, 10))
        want = jnp.asarray(x)
        for i, (t, tp) in enumerate(zip(ts, ts_prev)):
            tb, tpb = jnp.full((3,), t), jnp.full((3,), tp)
            noise = noises[i] if tp >= 0 else np.zeros_like(noises[i])
            want = jsched.strided_ddim_step(js, want, tb, tpb,
                                            eps_j(want, tb, a), noise, eta=eta)
    got = strided_ddim_loop(_linear_eps(torch), psched.make_schedule(
        1e-5, 1e-2, T), tensor(x), None, tensor(a), num_steps=10, eta=eta,
        noises=tensor(noises))
    assert_close(got, want, TRAJECTORY_TOL, "strided_ddim_loop")


@pytest.mark.parametrize("deterministic", [True, False])
def test_sampling_coefficients(deterministic):
    js = jsched.make_schedule(1e-5, 1e-2, T)
    ps = psched.make_schedule(1e-5, 1e-2, T)
    idxs = np.arange(T - 1, -1, -1)
    want = jtraj.sampling_coefficients(js, idxs, deterministic)
    got = ptraj.sampling_coefficients(ps, torch.from_numpy(idxs),
                                      deterministic)
    for g, w, name in zip(got, want, ("cx", "ce", "cn")):
        assert_close(g, w, OP_TOL, name)


def test_reverse_coefficients():
    js = jsched.make_schedule(1e-5, 1e-2, T)
    ps = psched.make_schedule(1e-5, 1e-2, T)
    idxs = np.arange(1, T - 1)
    want = jtraj.reverse_coefficients(js, idxs)
    got = ptraj.reverse_coefficients(ps, torch.from_numpy(idxs))
    for g, w, name in zip(got[:2], want[:2], ("cx", "ce")):
        assert_close(g, w, OP_TOL, name)
    assert not got[2].any()


def _adagn_inputs(C, K, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 4, 4, C) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    beta = (0.1 * rng.randn(C)).astype(np.float32)
    films = [tuple(rng.randn(2, C).astype(np.float32) for _ in range(2))
             for _ in range(K)]
    return x, gamma, beta, films


@pytest.mark.parametrize("C", [64, 192])
@pytest.mark.parametrize("K", [0, 1, 2])
def test_adagn_reference_matches_jax(C, K):
    from infodiffusion_tpu.ops.pallas.adagn import adagn_pallas

    x, gamma, beta, films = _adagn_inputs(C, K)
    got = adagn_reference(tensor(x), 32, tensor(gamma), tensor(beta),
                          [(tensor(s), tensor(b)) for s, b in films])
    assert_close(got, j_adagn(x, 32, gamma, beta, films), OP_TOL, "vs XLA")
    assert_close(got, adagn_pallas(x, 32, gamma, beta, films, interpret=True),
                 OP_TOL, "vs Pallas (interpret)")


@pytest.mark.parametrize("N", [16, 64])
def test_attention_reference_matches_jax(N):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from infodiffusion_tpu.ops.pallas import attention as jatt

    rng = np.random.RandomState(N)
    B, C = 2, 128
    q, k, v = (rng.randn(B, N, C).astype(np.float32) for _ in range(3))
    got = attention_reference(tensor(q), tensor(k), tensor(v))
    assert_close(got, _attention_xla(q, k, v), OP_TOL, "vs XLA")
    spec = pl.BlockSpec((1, N, C), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    pallas = pl.pallas_call(
        functools.partial(jatt._kernel, scale=float(C) ** -0.5),
        grid=(B,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((B, N, C), jnp.float32),
        interpret=True,
    )(q, k, v)
    assert_close(got, pallas, OP_TOL, "vs Pallas (interpret)")


def test_cpu_tensors_take_the_plain_versions():
    x, gamma, beta, films = _adagn_inputs(64, 2)
    films_t = [(tensor(s), tensor(b)) for s, b in films]
    before = (adagn_cuda.launches, attention_cuda.launches)
    got = pnorm.adagn(tensor(x), 32, tensor(gamma), tensor(beta), films_t)
    assert torch.equal(got, adagn_reference(tensor(x), 32, tensor(gamma),
                                            tensor(beta), films_t))
    q = torch.randn(2, 16, 128)
    assert torch.equal(pattn.single_head_attention(q, q, q),
                       attention_reference(q, q, q))
    assert (adagn_cuda.launches, attention_cuda.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 16, 64)
    c = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        adagn_cuda(x, 32, c, c)
    q = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ptraj.latent_trajectory_cuda(torch.zeros(2, 8), *([None] * 7))


def test_import_without_jax():
    """The port and every submodule import with jax, flax and the JAX
    package blocked, as on a machine that has no JAX, and the port's Config
    instantiates."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['infodiffusion_tpu'] = None\n"
        "import infodiffusion_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from infodiffusion_tpu_torch.config import Config\n"
        "assert Config(dataset='celeba').with_dataset_config().shape == "
        "(3, 64, 64)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_config_mirrors_jax_config():
    """Every field of the port's Config is a JAX Config field with the same
    default; the dataset table and the checks are the same."""
    import dataclasses

    from infodiffusion_tpu import config as jcfg
    from infodiffusion_tpu_torch import config as pcfg

    jax_defaults = {f.name: f.default for f in dataclasses.fields(jcfg.Config)}
    for f in dataclasses.fields(pcfg.Config):
        assert f.default == jax_defaults[f.name], f.name
    assert pcfg.DATASET_CONFIG == jcfg.DATASET_CONFIG
    assert pcfg.MODELS == jcfg.MODELS and pcfg.DATASETS == jcfg.DATASETS
    for dataset in pcfg.DATASETS:
        p = pcfg.Config(dataset=dataset, a_dim=7).with_dataset_config()
        j = jcfg.Config(dataset=dataset, a_dim=7).with_dataset_config()
        assert (p.shape, p.latent_shape, p.unets_channels) == (
            j.shape, j.latent_shape, j.unets_channels)
    with pytest.raises(ValueError, match="model"):
        pcfg.Config(model="gan")
    with pytest.raises(ValueError, match="dataset"):
        pcfg.Config(dataset="imagenet")


BF16_GRAD_TOL = 2e-2


def test_q_sample_matches_jax():
    js = jsched.make_schedule(1e-5, 1e-2, T)
    ps = psched.make_schedule(1e-5, 1e-2, T)
    rng = np.random.RandomState(30)
    t = np.array([0, 1, 500, 999], np.int32)
    for shape in ((4, 3, 5, 2), (4, 6)):  # image [B, H, W, C], latent [B, d]
        x, eps = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        assert_close(psched.q_sample(ps, tensor(x), tensor(t).long(),
                                     tensor(eps)),
                     jsched.q_sample(js, x, t, eps), OP_TOL, "q_sample")


@pytest.mark.parametrize("d", [2, 32])
def test_compute_mmd_matches_jax(d):
    rng = np.random.RandomState(d)
    x = rng.randn(8, d).astype(np.float32)
    y = (rng.randn(8, d) * 0.5 + 0.3).astype(np.float32)
    for a, b in ((x, y), (x, x)):
        assert_close(pmmd.compute_mmd(tensor(a), tensor(b)),
                     jmmd.compute_mmd(a, b), OP_TOL, "compute_mmd")
    assert_close(pmmd.compute_kernel(tensor(x), tensor(y)),
                 jmmd.compute_kernel(x, y), OP_TOL, "compute_kernel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [64, 192])
@pytest.mark.parametrize("K", [0, 1, 2])
def test_adagn_plain_backward_matches_jax_vjp(C, K, dtype):
    x, gamma, beta, films = _adagn_inputs(C, K, seed=C + K)
    dy = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    jfilms = [tuple(jnp.asarray(t, jdt) for t in pair) for pair in films]
    _, vjp = jax.vjp(lambda x_, g_, b_, f_: j_adagn(x_, 32, g_, b_, f_),
                     jx, jnp.asarray(gamma), jnp.asarray(beta), jfilms)
    want_x, want_g, want_b, want_f = vjp(jdy)

    pdt = getattr(torch, dtype)
    got_x, got_g, got_b, got_f = adagn_bwd_reference(
        tensor(x).to(pdt), tensor(dy).to(pdt), 32, tensor(gamma),
        tensor(beta), [tuple(tensor(t).to(pdt) for t in p) for p in films])
    tol = OP_TOL if dtype == "float32" else BF16_GRAD_TOL
    assert got_x.dtype == pdt and got_g.dtype == torch.float32
    assert all(t.dtype == pdt for pair in got_f for t in pair)
    for got, want, what in [(got_x, want_x, "dx"), (got_g, want_g, "dgamma"),
                            (got_b, want_b, "dbeta")] + [
            (g, w, f"dfilm{k}{i}") for k, (gp, wp) in
            enumerate(zip(got_f, want_f)) for i, (g, w) in
            enumerate(zip(gp, wp))]:
        assert_close(got.float(), np.asarray(want, np.float32), tol, what)


def test_adagn_function_grads_are_the_plain_backward():
    """On the CPU the autograd.Function's backward is the explicit plain
    backward, which agrees with autograd of the plain forward."""
    x, gamma, beta, films = _adagn_inputs(64, 2, seed=3)
    leaves = [tensor(x), tensor(gamma), tensor(beta)] + [
        tensor(t) for pair in films for t in pair]
    for leaf in leaves:
        leaf.requires_grad_(True)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    pairs = list(zip(leaves[3::2], leaves[4::2]))
    got = torch.autograd.grad(pnorm.adagn(leaves[0], 32, leaves[1], leaves[2],
                                          pairs), leaves, dy)
    want = torch.autograd.grad(adagn_reference(leaves[0], 32, leaves[1],
                                               leaves[2], pairs), leaves, dy)
    for g, w in zip(got, want):
        assert_close(g, w.numpy(), OP_TOL, "grad")


def _qkvdo(B, N, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, N, 128).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_plain_matches_jax_flash(dtype):
    from infodiffusion_tpu.ops.pallas.flash_attention import flash_attention

    q, k, v, _ = _qkvdo(2, 256, seed=5)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = flash_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                           interpret=True)
    got = attention_reference(*(tensor(t).to(pdt) for t in (q, k, v)))
    tol = OP_TOL if dtype == "float32" else BF16_GRAD_TOL
    assert_close(got.float(), np.asarray(want, np.float32), tol, "K3a")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_plain_matches_jax_bwd_kernel(dtype):
    """K3b's plain version against the Pallas backward at N=256 with four
    q tiles, so dk/dv accumulate across tiles."""
    from infodiffusion_tpu.ops.pallas.flash_attention import _bwd_call

    arrays = _qkvdo(2, 256, seed=6)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _bwd_call(*(jnp.asarray(t, jdt) for t in arrays), interpret=True,
                     block_q=64)
    got = pflash.flash_attention_bwd_reference(
        *(tensor(t).to(pdt) for t in arrays))
    tol = OP_TOL if dtype == "float32" else BF16_GRAD_TOL
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == pdt
        assert_close(g.float(), np.asarray(w, np.float32), tol, what)


def test_attention_function_grads_match_jax_autodiff():
    """f32: the Function's backward (K3b's plain version) is the gradient
    of the dense attention the JAX package differentiates."""
    q, k, v, do = _qkvdo(2, 64, seed=8)
    _, vjp = jax.vjp(_attention_xla, q, k, v)
    want = vjp(do)
    leaves = [tensor(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(pattn.single_head_attention(*leaves), leaves,
                              tensor(do))
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, OP_TOL, what)


def test_flash_route_threshold(monkeypatch):
    """N >= flash_min_tokens() (default 512, the JAX env var) takes K3a."""
    monkeypatch.delenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", raising=False)
    assert pattn.flash_min_tokens() == 512
    assert [pattn.attention_route(n) for n in (64, 256, 511, 512, 1024)] == [
        "attention"] * 3 + ["flash"] * 2
    monkeypatch.setenv("INFODIFF_FLASH_ATTN_MIN_TOKENS", "64")
    assert pattn.attention_route(64) == "flash"
    assert pattn.attention_route(63) == "attention"


def test_no_grad_saves_nothing_for_backward():
    """Under no_grad or inference_mode the Functions build no graph and save
    no tensor; with grad on they do."""
    x, gamma, beta, films = _adagn_inputs(64, 2)
    leaves = [tensor(x), tensor(gamma), tensor(beta)] + [
        tensor(t) for pair in films for t in pair]
    for leaf in leaves:
        leaf.requires_grad_(True)
    q = torch.randn(2, 16, 128, requires_grad=True)

    def run(ctx):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t), ctx:
            y = pnorm.adagn(leaves[0], 32, leaves[1], leaves[2],
                            list(zip(leaves[3::2], leaves[4::2])))
            z = pattn.single_head_attention(q, q, q)
        return y, z, saved

    for ctx in (torch.no_grad(), torch.inference_mode()):
        y, z, saved = run(ctx)
        assert y.grad_fn is None and z.grad_fn is None and not saved
    y, z, saved = run(torch.enable_grad())
    assert y.grad_fn is not None and z.grad_fn is not None and saved


def test_new_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 16, 64)
    c = torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        adagn_bwd_cuda(x, x, 32, c, c, (), torch.zeros(2, 1, 2, 64))
    q = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        pflash.flash_attention_bwd_cuda(q, q, q, q)
    before = (pflash.flash_attention_cuda.launches,
              pflash.flash_attention_bwd_cuda.launches,
              adagn_bwd_cuda.launches)
    q.requires_grad_(True)
    pattn.single_head_attention(q, q, q).sum().backward()
    assert before == (pflash.flash_attention_cuda.launches,
                      pflash.flash_attention_bwd_cuda.launches,
                      adagn_bwd_cuda.launches)
