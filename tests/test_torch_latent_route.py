"""The latent sampler's route (``ops/cuda/latent_traj.latent_route``): K4
where the cluster core takes a_dim and the W dtype, K5 on the per-forward
opt-in under the same gate, else the samplers over the model's own forward
(the "torch" route, JAX's XLA scan), as the JAX process chooses. The
"torch" route at a_dim 20, which neither kernel takes, is held against the
JAX ``LatentDiffusionProcess`` at a_dim 20 on its XLA path with the same
weights and injected draws (T=20, f32, TRAJECTORY_TOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.config import Config as JConfig
from infodiffusion_tpu.diffusion.samplers import (
    LatentDiffusionProcess as JLatentProcess,
)
from infodiffusion_tpu.diffusion.samplers import sample_loop as j_sample_loop
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import LatentDiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.ops.cuda import latent_traj as K4
from torch_parity import (
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

D, T, B = 20, 20, 6
SWITCHES = ("INFODIFF_DISABLE_PALLAS", "INFODIFF_DISABLE_FUSED_LATENT_TRAJ",
            "INFODIFF_ENABLE_FUSED_LATENT", "INFODIFF_FORCE_FUSED_LATENT")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in SWITCHES:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def models():
    jm = JDiff(T=T, shape=(1, D, D), is_latent=True)
    params = randomize(init_variables(
        jm, np.zeros((B, D), np.float32), np.zeros(B, np.int32))["params"],
        seed=31)
    pm = port(Diff(T=T, shape=(1, D, D), is_latent=True), params)
    return jm, params, pm


# (a_dim, what K4 takes with bf16 W, with f32 W)
A_DIMS = [(16, True, True), (20, False, False), (32, True, True),
          (40, False, False), (48, True, True), (256, True, True),
          (768, True, True), (784, True, False), (1024, True, False)]


@pytest.mark.parametrize("d,bf16_ok,f32_ok", A_DIMS)
@pytest.mark.parametrize("per_forward", [False, True])
def test_route_gate(d, bf16_ok, f32_ok, per_forward):
    kernel = "k5" if per_forward else "k4"
    for dtype, ok in ((torch.bfloat16, bf16_ok), (torch.float32, f32_ok)):
        assert K4.latent_route(d, dtype, per_forward) == (
            kernel if ok else "torch"), (d, dtype)


def test_route_switches(monkeypatch):
    monkeypatch.setenv("INFODIFF_DISABLE_FUSED_LATENT_TRAJ", "1")
    # K4 off, as in JAX; the per-forward opt-in still takes K5
    assert K4.latent_route(256, torch.bfloat16, False) == "torch"
    assert K4.latent_route(256, torch.bfloat16, True) == "k5"
    monkeypatch.setenv("INFODIFF_DISABLE_PALLAS", "1")
    assert K4.latent_route(256, torch.bfloat16, True) == "torch"
    monkeypatch.delenv("INFODIFF_DISABLE_FUSED_LATENT_TRAJ")
    assert K4.latent_route(256, torch.float32, False) == "torch"


def test_process_takes_the_route(models, monkeypatch):
    _, _, pm = models
    proc = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm)
    assert proc.route == "torch" and proc.params is None
    monkeypatch.setenv("INFODIFF_FORCE_FUSED_LATENT", "1")
    proc = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm)
    assert proc.route == "torch" and not proc.per_forward


def test_turbo_warns_on_the_torch_route(models):
    """turbo='int8' where K4 does not run: JAX's warning, and the samples
    are those without turbo, bitwise."""
    _, _, pm = models
    rng = np.random.RandomState(32)
    xT = tensor(rng.randn(B, D).astype(np.float32))
    noises = tensor(rng.randn(T, B, D).astype(np.float32))
    cfg = Config(a_dim=D, diffusion_steps=T, deterministic=True)
    with pytest.warns(UserWarning, match="int8 weight stream"):
        turbo = LatentDiffusionProcess(cfg, pm, turbo="int8")
    plain = LatentDiffusionProcess(cfg, pm, turbo="off")
    assert turbo.route == plain.route == "torch"
    assert torch.equal(turbo.sampling(xT=xT, noises=noises),
                       plain.sampling(xT=xT, noises=noises))


@pytest.mark.parametrize("deterministic", [True, False])
def test_torch_route_sampling_matches_jax(models, deterministic):
    jm, params, pm = models
    rng = np.random.RandomState(33 + deterministic)
    xT = rng.randn(B, D).astype(np.float32)
    noises = rng.randn(T, B, D).astype(np.float32)
    jproc = JLatentProcess(JConfig(a_dim=D, diffusion_steps=T,
                                   deterministic=deterministic), jm,
                           {"params": params})
    assert not (jproc._fused or jproc._traj)  # the XLA scan
    want = j_sample_loop(jproc._eps_fn(jproc.params), jproc.sched,
                         jnp.asarray(xT), None, deterministic=deterministic,
                         noises=jnp.asarray(noises))
    proc = LatentDiffusionProcess(
        Config(a_dim=D, diffusion_steps=T, deterministic=deterministic), pm)
    assert proc.route == "torch"
    got = proc.sampling(xT=tensor(xT), noises=tensor(noises))
    assert got.shape == (B, D) and torch.isfinite(got).all()
    assert_close(got, want, TRAJECTORY_TOL, "torch route sampling")


def test_torch_route_reverse_matches_jax(models):
    jm, params, pm = models
    x0 = np.random.RandomState(35).randn(B, D).astype(np.float32)
    jproc = JLatentProcess(JConfig(a_dim=D, diffusion_steps=T), jm,
                           {"params": params})
    want = jproc.reverse_sampling(jnp.asarray(x0))
    proc = LatentDiffusionProcess(Config(a_dim=D, diffusion_steps=T), pm)
    got = proc.reverse_sampling(tensor(x0))
    assert_close(got, want, TRAJECTORY_TOL, "torch route reverse")
