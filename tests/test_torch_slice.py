"""The port's generation slice as a whole, held against the JAX package on
a tiny model: the latent prior's trajectory (K4's path) then DDIM-5
through the AuxiliaryUNet (K1's and K2's paths), with the same params, xT
and noise on both sides. Tolerance: TRAJECTORY_TOL (tests/torch_parity.py).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

from infodiffusion_tpu.diffusion.samplers import strided_ddim_loop
from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.ops.pallas.latent_mlp import (
    pack_latent_unet_params as j_pack,
)
from infodiffusion_tpu.ops.pallas.latent_traj import latent_trajectory_pallas
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import LatentDiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from torch_parity import (
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

A_DIM, T, B, SIZE, STEPS = 32, 50, 2, 16, 5


def test_latent_prior_then_ddim_matches_jax():
    rng = np.random.RandomState(8)
    kw = dict(T=T, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
              ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
    j_img = JInfoDiff(encoder_channels=32, **kw)
    j_lat = JDiff(T=T, shape=(1, A_DIM, A_DIM), is_latent=True)
    x_img = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    x_lat = rng.randn(B, A_DIM).astype(np.float32)
    noises = rng.randn(T, B, A_DIM).astype(np.float32)
    p_img = randomize(init_variables(
        j_img, x_img, np.zeros(B, np.int32), x_lat)["params"], seed=9)
    p_lat = randomize(init_variables(
        j_lat, x_lat, np.zeros(B, np.int32))["params"], seed=10)

    # JAX: the trajectory kernel (interpret mode), then DDIM-5
    sched = j_schedule(1e-5, 1e-2, T)
    a_want = latent_trajectory_pallas(
        j_pack(p_lat["backbone"], A_DIM), sched, jnp.asarray(x_lat), None,
        deterministic=True, noises=jnp.asarray(noises), interpret=True,
        block_b=8,
    )
    eps_fn = lambda x, t, a: j_img.apply({"params": p_img}, x, t, a)
    img_want = jax.jit(
        lambda x, a: strided_ddim_loop(eps_fn, sched, x, jr.PRNGKey(0), a,
                                       num_steps=STEPS)
    )(jnp.asarray(x_img), a_want)

    # port: LatentDiffusionProcess, then the pipeline's DDIM-5
    cfg = Config(model="diff", a_dim=A_DIM, diffusion_steps=T,
                 deterministic=True, input_channels=3, input_size=SIZE)
    latent = LatentDiffusionProcess(
        cfg, port(Diff(T=T, shape=(1, A_DIM, A_DIM), is_latent=True), p_lat))
    a_got = latent.sampling(xT=tensor(x_lat), noises=tensor(noises))
    assert_close(a_got, a_want, TRAJECTORY_TOL, "latents")
    # a tree from init(x, t, a) holds only the backbone: load it there
    model = InfoDiff(**kw).eval()
    port(model.backbone, p_img["backbone"])
    img_got = InfoDiffusionPipeline(cfg, model).process.sampling(
        xT=tensor(x_img), a=a_got, num_steps=STEPS)
    assert_close(img_got, img_want, TRAJECTORY_TOL, "images")


def test_pipeline_generate_shapes_and_range():
    cfg = Config(model="diff", a_dim=A_DIM, diffusion_steps=T,
                 input_channels=3, input_size=SIZE)
    model = InfoDiff(T=T, a_dim=A_DIM, shape=(3, SIZE, SIZE),
                     unets_channels=32, ch_mult=(1, 2), attn=(1,),
                     num_res_blocks=1)
    out = InfoDiffusionPipeline(cfg, model, seed=3).generate(2, steps=2)
    assert out.shape == (2, SIZE, SIZE, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and out.abs().max() <= 1.0
