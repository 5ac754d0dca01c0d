"""The port's samplers beyond generation, held against the JAX package on
tiny models with the same params, inputs and injected noise: the reverse
DDIM step and loop, two-phase sampling (both ``reference_quirk`` values)
through ``TwoPhaseDiffusionProcess``, an unconditional ``DiffusionProcess``
over the vanilla Diff, ``reverse_sampling`` with and without the D13 quirk
(mmd 0.1, kld 0: the quirk's re-encoding routes the deterministic ``a``, so
it is exact although the two RNG streams differ by design), and the
pipeline's ``invert`` / ``reconstruct``. Tolerances: OP_TOL for one step,
TRAJECTORY_TOL for trajectories (tests/torch_parity.py)."""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.config import Config as JConfig
from infodiffusion_tpu.diffusion import samplers as js
from infodiffusion_tpu.diffusion.schedule import ddim_reverse_step as j_step
from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.pipelines import InfoDiffusionPipeline as JPipeline
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    TwoPhaseDiffusionProcess,
    reverse_sample_loop,
)
from infodiffusion_tpu_torch.diffusion.schedule import (
    ddim_reverse_step,
    make_schedule,
)
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
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

A_DIM, T, B, SIZE, SPLIT, STEPS = 32, 10, 2, 16, 4, 3
ARCH = dict(T=T, shape=(3, SIZE, SIZE), unets_channels=32, ch_mult=(1, 2),
            attn=(1,), num_res_blocks=1)
CFG = dict(a_dim=A_DIM, diffusion_steps=T, input_channels=3,
           input_size=SIZE, split_step=SPLIT, mmd_weight=0.1, kld_weight=0.0)


@pytest.fixture(scope="module")
def models():
    """(JAX vanilla Diff, its params, port), (JAX InfoDiff, its full params
    with the encoder, port)."""
    x = np.zeros((B, SIZE, SIZE, 3), np.float32)
    jv = JDiff(**ARCH)
    pv = randomize(init_variables(jv, x, np.zeros(B, np.int32))["params"],
                   seed=31)
    ji = JInfoDiff(a_dim=A_DIM, encoder_channels=32, **ARCH)
    pi = randomize(init_variables(ji, x, 0, method=JInfoDiff.loss_fn)[
        "params"], seed=32)
    return ((jv, pv, port(Diff(**ARCH), pv)),
            (ji, pi, port(InfoDiff(a_dim=A_DIM, encoder_channels=32, **ARCH),
                          pi)))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
            rng.randn(B, A_DIM).astype(np.float32),
            rng.randn(T, B, SIZE, SIZE, 3).astype(np.float32))


def test_ddim_reverse_step():
    rng = np.random.RandomState(33)
    x, eps = (rng.randn(B, 4, 4, 3).astype(np.float32) for _ in range(2))
    for idx in (1, 5, T - 2):
        want = j_step(j_schedule(1e-5, 1e-2, T), jnp.asarray(x),
                      jnp.asarray(idx), jnp.asarray(eps))
        got = ddim_reverse_step(make_schedule(1e-5, 1e-2, T), tensor(x),
                                torch.tensor(idx), tensor(eps))
        assert_close(got, want, OP_TOL, f"reverse step {idx}")


def test_reverse_sample_loop(models):
    (jv, pv, pm), _ = models
    x0, _, _ = _inputs(34)
    want = jax.jit(lambda x: js.reverse_sample_loop(
        lambda y, t, a: jv.apply({"params": pv}, y, t),
        j_schedule(1e-5, 1e-2, T), x))(jnp.asarray(x0))
    got = reverse_sample_loop(lambda y, t, a: pm(y, t),
                              make_schedule(1e-5, 1e-2, T), tensor(x0))
    assert_close(got, want, TRAJECTORY_TOL, "reverse_sample_loop")


@pytest.mark.parametrize("quirk,deterministic", [(False, False),
                                                 (True, True)])
def test_two_phase(models, quirk, deterministic):
    (jv, pv, pv_m), (ji, pi, pi_m) = models
    xT, a, noises = _inputs(35)
    want = jax.jit(lambda x, a_, n: js.two_phase_sample_loop(
        lambda y, t, c: ji.apply({"params": pi}, y, t, c),
        lambda y, t: jv.apply({"params": pv}, y, t),
        j_schedule(1e-5, 1e-2, T), x, None, a_, SPLIT,
        deterministic=deterministic, reference_quirk=quirk, noises=n))(
            jnp.asarray(xT), jnp.asarray(a), jnp.asarray(noises))
    cfg = Config(two_phase_reference_quirk=quirk,
                 deterministic=deterministic, **CFG)
    got = TwoPhaseDiffusionProcess(cfg, pi_m, pv_m).sampling(
        xT=tensor(xT), a=tensor(a), noises=tensor(noises))
    assert_close(got, want, TRAJECTORY_TOL, f"two-phase quirk={quirk}")


def test_unconditional_process(models):
    (jv, pv, pm), _ = models
    xT, _, _ = _inputs(36)
    jcfg = JConfig(model="vanilla", **CFG)
    want = js.DiffusionProcess(jcfg, jv, {"params": pv}).sampling(
        jr.PRNGKey(0), xT=jnp.asarray(xT), num_steps=STEPS)
    proc = DiffusionProcess(Config(model="vanilla", **CFG), pm)
    assert not proc.is_conditional
    got = proc.sampling(torch.Generator().manual_seed(0), xT=tensor(xT),
                        num_steps=STEPS)
    assert_close(got, want, TRAJECTORY_TOL, "unconditional DDIM")
    x0 = got.numpy()
    want = js.DiffusionProcess(jcfg, jv, {"params": pv}).reverse_sampling(
        jnp.asarray(x0))
    assert_close(proc.reverse_sampling(tensor(x0)), want, TRAJECTORY_TOL,
                 "unconditional reverse")


@pytest.mark.parametrize("quirk", [False, True])
def test_reverse_sampling(models, quirk):
    """DiffusionProcess and TwoPhaseDiffusionProcess reverse sampling over
    the InfoDiff, with and without D13 (which re-encodes every step)."""
    (jv, pv, pv_m), (ji, pi, pi_m) = models
    x0, a, _ = _inputs(37)
    jcfg = JConfig(reverse_reference_quirk=quirk, **CFG)
    want = js.DiffusionProcess(jcfg, ji, {"params": pi}).reverse_sampling(
        jnp.asarray(x0), jnp.asarray(a), jr.PRNGKey(5))
    cfg = Config(reverse_reference_quirk=quirk, **CFG)
    got = DiffusionProcess(cfg, pi_m).reverse_sampling(
        tensor(x0), tensor(a), generator=torch.Generator().manual_seed(5))
    assert_close(got, want, TRAJECTORY_TOL, f"reverse, D13={quirk}")
    got = TwoPhaseDiffusionProcess(cfg, pi_m, pv_m).reverse_sampling(
        tensor(x0), tensor(a))
    assert_close(got, want, TRAJECTORY_TOL, f"two-phase reverse, D13={quirk}")


def test_pipeline_invert_and_reconstruct(models):
    _, (ji, pi, pm) = models
    x0 = np.random.RandomState(38).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(
        np.float32)
    jpipe = JPipeline(JConfig(**CFG), ji, {"params": pi})
    pipe = InfoDiffusionPipeline(Config(**CFG), pm)
    assert_close(pipe.encode(tensor(x0)), jpipe.encode(x0), OP_TOL, "encode")
    assert_close(pipe.invert(tensor(x0)), jpipe.invert(x0), TRAJECTORY_TOL,
                 "invert")
    assert_close(pipe.reconstruct(tensor(x0), steps=STEPS),
                 jpipe.reconstruct(x0, steps=STEPS), TRAJECTORY_TOL,
                 "reconstruct")


def test_turbo_is_refused(models):
    (_, _, pv_m), (_, _, pi_m) = models
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DiffusionProcess(Config(model="vanilla", **CFG), pv_m, turbo="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TwoPhaseDiffusionProcess(Config(**CFG), pi_m, pv_m, turbo="int8")
    with pytest.raises(ValueError, match="needs a"):
        DiffusionProcess(Config(**CFG), pi_m).reverse_sampling(
            torch.zeros(B, SIZE, SIZE, 3))
