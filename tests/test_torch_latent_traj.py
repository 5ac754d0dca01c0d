"""The torch port's latent prior held against the JAX package: the
LatentUNet forward, the packed weights, and the plain version of kernel K4
(the whole latent trajectory) against ``latent_trajectory_pallas`` in
interpret mode, with the same injected noise. Tolerances:
tests/torch_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.ops.pallas.latent_mlp import (
    pack_latent_unet_params as j_pack,
)
from infodiffusion_tpu.ops.pallas.latent_traj import latent_trajectory_pallas
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import LatentDiffusionProcess
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.latent_traj import latent_trajectory
from torch_parity import (
    FORWARD_TOL,
    OP_TOL,
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

D, T, B = 32, 24, 8


@pytest.fixture(scope="module")
def models():
    jm = JDiff(T=T, shape=(1, D, D), is_latent=True)
    x = np.zeros((B, D), np.float32)
    t = np.zeros((B,), np.int32)
    params = randomize(init_variables(jm, x, t)["params"], seed=5)
    pm = port(Diff(T=T, shape=(1, D, D), is_latent=True), params)
    return jm, params, pm


def test_latent_unet_forward(models):
    jm, params, pm = models
    rng = np.random.RandomState(6)
    x = rng.randn(B, D).astype(np.float32)
    t = rng.randint(0, T, size=B).astype(np.int32)
    want = jm.apply({"params": params}, x, t)
    assert_close(pm(tensor(x), tensor(t).long()), want, FORWARD_TOL,
                 "LatentUNet")


def test_pack_latent_unet_params(models):
    _, params, pm = models
    want = j_pack(params["backbone"], D)
    got = pack_latent_unet_params(pm.backbone, D)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_close(got[key], want[key], OP_TOL, key)
    bf16 = pack_latent_unet_params(pm.backbone, D, dtype=torch.bfloat16)
    assert bf16["W"].dtype == bf16["Wc"].dtype == torch.bfloat16


@pytest.mark.parametrize("deterministic,reverse",
                         [(True, False), (False, False), (True, True)])
def test_trajectory_matches_pallas(models, deterministic, reverse):
    _, params, pm = models
    rng = np.random.RandomState(7)
    x = rng.randn(B, D).astype(np.float32)
    S = T - 2 if reverse else T
    noises = (np.zeros((S, B, D), np.float32) if reverse
              else rng.randn(S, B, D).astype(np.float32))
    want = latent_trajectory_pallas(
        j_pack(params["backbone"], D), j_schedule(1e-5, 1e-2, T),
        jnp.asarray(x), None, deterministic=deterministic, reverse=reverse,
        noises=jnp.asarray(noises), interpret=True, block_b=8,
    )
    if reverse:  # through the sampler's entry point, which draws nothing
        cfg = Config(a_dim=D, diffusion_steps=T)
        got = LatentDiffusionProcess(cfg, pm).reverse_sampling(tensor(x))
    else:
        got = latent_trajectory(
            pack_latent_unet_params(pm.backbone, D),
            make_schedule(1e-5, 1e-2, T), tensor(x),
            deterministic=deterministic, noises=tensor(noises),
        )
    assert_close(got, want, TRAJECTORY_TOL, "latent trajectory")
