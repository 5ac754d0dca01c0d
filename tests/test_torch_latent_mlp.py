"""K5, the per-forward LatentUNet kernel, held against the JAX package: its
plain version against ``latent_unet_forward_pallas`` (interpret mode) and
``latent_eps_fn``, with f32 and bf16 packed weights; the latent sampler's
per-forward route (forced on the CPU) against JAX ``sample_loop`` /
``reverse_sample_loop`` over ``latent_eps_fn`` with the same injected
noise; and the route's gate. Tolerances: OP_TOL for one forward in f32,
1e-2 of max abs with bf16 weights (both sides round the products' inputs
to bf16; the sums differ in order), TRAJECTORY_TOL for trajectories
(tests/torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion.samplers import (
    reverse_sample_loop,
    sample_loop,
)
from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.ops.pallas import latent_mlp as JK5
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import LatentDiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.ops.cuda import latent_mlp as K5
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

D, T, B = 32, 16, 8
BF16_TOL = 1e-2
FORCE = "INFODIFF_FORCE_FUSED_LATENT"


@pytest.fixture(scope="module")
def models():
    jm = JDiff(T=T, shape=(1, D, D), is_latent=True)
    params = randomize(init_variables(
        jm, np.zeros((B, D), np.float32), np.zeros(B, np.int32))["params"],
        seed=21)
    pm = port(Diff(T=T, shape=(1, D, D), is_latent=True), params)
    return params, pm


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_plain_matches_pallas(models, tag):
    params, pm = models
    jdt, tdt = ((jnp.float32, torch.float32) if tag == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(22)
    x = rng.randn(B, D).astype(np.float32)
    t = rng.randint(0, T, size=B).astype(np.int32)
    j_packed = JK5.pack_latent_unet_params(params["backbone"], D, dtype=jdt)
    packed = K5.pack_latent_unet_params(pm.backbone, D, dtype=tdt)
    tol = OP_TOL if tag == "f32" else BF16_TOL
    # the kernel body alone, on one s per row
    s = rng.randn(B, D).astype(np.float32)
    want = JK5.latent_unet_forward_pallas(
        j_packed, jnp.asarray(x), jnp.asarray(s), interpret=True, block_b=4)
    got = K5.latent_unet_forward(packed, tensor(x), tensor(s))
    assert got.dtype == torch.float32
    assert_close(got, want, tol, f"K5 plain {tag}")
    # the whole eps function, time embedding included
    want = JK5.latent_eps_fn(j_packed, interpret=True)(jnp.asarray(x),
                                                       jnp.asarray(t))
    got = K5.latent_eps_fn(packed)(tensor(x), tensor(t).long())
    assert_close(got, want, tol, f"latent_eps_fn {tag}")


@pytest.mark.parametrize("deterministic", [True, False])
def test_per_forward_sampling_matches_jax(models, deterministic, monkeypatch):
    params, pm = models
    rng = np.random.RandomState(23)
    xT = rng.randn(B, D).astype(np.float32)
    noises = rng.randn(T, B, D).astype(np.float32)
    eps_fn = JK5.latent_eps_fn(
        JK5.pack_latent_unet_params(params["backbone"], D), interpret=True)
    want = jax.jit(lambda x, n: sample_loop(
        eps_fn, j_schedule(1e-5, 1e-2, T), x, None,
        deterministic=deterministic, noises=n))(jnp.asarray(xT),
                                                jnp.asarray(noises))
    monkeypatch.setenv(FORCE, "1")
    proc = LatentDiffusionProcess(
        Config(a_dim=D, diffusion_steps=T, deterministic=deterministic), pm)
    assert proc.per_forward
    got = proc.sampling(xT=tensor(xT), noises=tensor(noises))
    assert_close(got, want, TRAJECTORY_TOL, "per-forward sampling")


def test_per_forward_reverse_matches_jax(models, monkeypatch):
    params, pm = models
    x0 = np.random.RandomState(24).randn(B, D).astype(np.float32)
    eps_fn = JK5.latent_eps_fn(
        JK5.pack_latent_unet_params(params["backbone"], D), interpret=True)
    want = jax.jit(lambda x: reverse_sample_loop(
        eps_fn, j_schedule(1e-5, 1e-2, T), x))(jnp.asarray(x0))
    monkeypatch.setenv(FORCE, "1")
    proc = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm)
    got = proc.reverse_sampling(tensor(x0))
    assert_close(got, want, TRAJECTORY_TOL, "per-forward reverse")
    # the whole-trajectory route (K4's plain version) computes the same
    monkeypatch.delenv(FORCE)
    k4 = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm)
    assert not k4.per_forward
    assert_close(k4.reverse_sampling(tensor(x0)), want, TRAJECTORY_TOL,
                 "K4 reverse")


def test_per_forward_turbo_warns_and_samples_as_jax(models, monkeypatch):
    """turbo='int8' on the per-forward route: the port warns and samples
    bitwise as without turbo; the JAX process, whose per-forward and
    trajectory kernels are off on the CPU, warns and samples with the
    model's own forward (XLA), here with the same injected draws."""
    from infodiffusion_tpu.config import Config as JConfig
    from infodiffusion_tpu.diffusion.samplers import (
        LatentDiffusionProcess as JLatentProcess,
    )

    params, pm = models
    rng = np.random.RandomState(25)
    xT = rng.randn(B, D).astype(np.float32)
    noises = rng.randn(T, B, D).astype(np.float32)
    monkeypatch.setenv("INFODIFF_ENABLE_FUSED_LATENT", "1")
    monkeypatch.setenv(FORCE, "1")
    monkeypatch.delenv("INFODIFF_DISABLE_PALLAS", raising=False)
    cfg = Config(a_dim=D, diffusion_steps=T, deterministic=True)
    with pytest.warns(UserWarning, match="int8 weight stream"):
        turbo = LatentDiffusionProcess(cfg, pm, turbo="int8")
    plain = LatentDiffusionProcess(cfg, pm, turbo="off")
    assert turbo.per_forward and plain.per_forward
    got = turbo.sampling(xT=tensor(xT), noises=tensor(noises))
    assert torch.equal(got, plain.sampling(xT=tensor(xT),
                                           noises=tensor(noises)))
    jm = JDiff(T=T, shape=(1, D, D), is_latent=True)
    with pytest.warns(UserWarning, match="int8 weight stream"):
        jproc = JLatentProcess(JConfig(a_dim=D, diffusion_steps=T,
                                       deterministic=True), jm,
                               {"params": params}, turbo="int8")
    assert not (jproc._fused or jproc._traj)
    # the JAX process's sampling function with the same injected draws
    want = sample_loop(jproc._eps_fn(jproc.params), jproc.sched,
                       jnp.asarray(xT), None, deterministic=True,
                       noises=jnp.asarray(noises))
    assert_close(got, want, TRAJECTORY_TOL, "per-forward turbo sampling")


def test_gate(models, monkeypatch):
    params, pm = models
    assert K5.fused_latent_supported(pm.backbone, D)
    assert JK5.fused_latent_supported(params["backbone"], D)
    assert not K5.fused_latent_supported(pm.backbone, 2 * D)
    pm.backbone.layer_3.norm, saved = None, pm.backbone.layer_3.norm
    try:
        assert not K5.fused_latent_supported(pm.backbone, D)
    finally:
        pm.backbone.layer_3.norm = saved
    x = torch.zeros(1)
    for var in ("INFODIFF_ENABLE_FUSED_LATENT", FORCE,
                "INFODIFF_DISABLE_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    assert not K5.use_fused_latent(x)
    monkeypatch.setenv("INFODIFF_ENABLE_FUSED_LATENT", "1")
    assert not K5.use_fused_latent(x)  # a CPU tensor: K4's route
    monkeypatch.setenv(FORCE, "1")
    assert K5.use_fused_latent(x)
    # the int8 stream is K4's: the per-forward route warns, as JAX does,
    # and keeps the unquantized packed weights
    with pytest.warns(UserWarning, match="int8 weight stream"):
        proc = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm,
                                      turbo="int8")
    assert proc.per_forward and proc.params["W"].dtype == torch.float32
    monkeypatch.setenv("INFODIFF_DISABLE_PALLAS", "1")
    assert not K5.use_fused_latent(x)
    with pytest.raises(ValueError, match="CUDA"):
        K5.latent_unet_forward_cuda(
            torch.zeros(2, D), torch.zeros(2, D),
            *(torch.zeros(1) for _ in range(6)))
