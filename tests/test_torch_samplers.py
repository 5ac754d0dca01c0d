"""The port's samplers beyond generation, held against the JAX package on
tiny models with the same params, inputs and injected noise: the reverse
DDIM step and loop, two-phase sampling (both ``reference_quirk`` values)
through ``TwoPhaseDiffusionProcess``, an unconditional ``DiffusionProcess``
over the vanilla Diff, ``reverse_sampling`` with and without the D13 quirk
(mmd 0.1, kld 0: the quirk's re-encoding routes the deterministic ``a``, so
it is exact although the two RNG streams differ by design), and the
pipeline's ``invert`` / ``reconstruct``; then the int8 tier of the vanilla
Diff and of two-phase sampling (the sites and absmax of JAX's calibrate,
each model's state installed only for its phase, one quantized DDIM step)
and ``shape=``. Tolerances: OP_TOL for one step, TRAJECTORY_TOL for
trajectories (tests/torch_parity.py), the int8 ones at INT8_*."""

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
from infodiffusion_tpu.ops import quant as jq
from infodiffusion_tpu.pipelines import InfoDiffusionPipeline as JPipeline
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    TwoPhaseDiffusionProcess,
    reverse_sample_loop,
    strided_ddim_loop,
)
from infodiffusion_tpu_torch.diffusion.schedule import (
    ddim_reverse_step,
    make_schedule,
)
from infodiffusion_tpu_torch.interop import from_jax_quant
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff
from infodiffusion_tpu_torch.ops import quant as pq
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

# the int8 tier (tests/test_torch_quant.py): calibrated absmax is a max over
# one f32 forward; a quantized forward differs from JAX's where an f32
# rounding lands on a .5 boundary and flips one int8 unit
INT8_ABSMAX_TOL = 1e-4
INT8_FORWARD_TOL = 5e-3

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


def _calib_draws(a_dim=None):
    """JAX calibrate's own draws (infodiffusion_tpu/ops/quant.py)."""
    kx, ka = jr.split(jr.PRNGKey(0))
    x = np.asarray(jr.normal(kx, (32, SIZE, SIZE, 3), jnp.float32))
    a = (None if a_dim is None else
         np.asarray(jr.normal(ka, (32, a_dim), jnp.float32)))
    return x, a


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _absmax_close(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name.endswith("act_absmax"):
            g = got[name].detach().cpu().numpy()
            assert g.shape == value.shape, name
            err = np.max(np.abs(g - value) / value)
            assert err <= INT8_ABSMAX_TOL, f"{name}: {err:.3g}"


def test_turbo_is_refused(models):
    """The int8 tier over the vanilla Diff and two-phase sampling, which
    raised before: both processes calibrate (the vanilla Diff without a),
    at the sites JAX's calibrate fills, with absmax within 1e-4 relative on
    JAX's draws, and leave the models without quant state. A conditional
    reverse sampling still needs a."""
    (jv, pv, pv_m), (ji, pi, pi_m) = models
    j_van = _flat(jq.calibrate(jv, {"params": pv}, (SIZE, SIZE, 3),
                               a_dim=None, T=T)["quant"])
    j_inf = _flat(jq.calibrate(ji, {"params": pi}, (SIZE, SIZE, 3),
                               a_dim=A_DIM, T=T)["quant"])
    van = DiffusionProcess(Config(model="vanilla", **CFG), pv_m, turbo="int8")
    assert sorted(van.quant) == sorted(j_van)
    two = TwoPhaseDiffusionProcess(Config(**CFG), pi_m, pv_m, turbo="int8")
    assert sorted(two.quant1) == sorted(j_inf)
    assert sorted(two.quant2) == sorted(j_van)
    assert pq.quant_state(pv_m) == {} and pq.quant_state(pi_m) == {}
    for model, a_dim, want in ((pv_m, None, j_van), (pi_m, A_DIM, j_inf)):
        x, a = _calib_draws(a_dim)
        pq.calibrate(model, (SIZE, SIZE, 3), a_dim=a_dim, T=T, x=tensor(x),
                     a=None if a is None else tensor(a))
        got = pq.quant_state(model)
        pq.clear_quant_state(model)
        _absmax_close(got, want)
    with pytest.raises(ValueError, match="needs a"):
        DiffusionProcess(Config(**CFG), pi_m).reverse_sampling(
            torch.zeros(B, SIZE, SIZE, 3))


def test_two_phase_turbo_installs_each_state_for_its_phase(models):
    """While phase 1 (the vanilla Diff) runs only model2 holds its quant
    state; while phase 2 runs only model1 does; after sampling neither."""
    (_, _, pv_m), (_, _, pi_m) = models
    two = TwoPhaseDiffusionProcess(Config(**CFG), pi_m, pv_m, turbo="int8")
    seen = []

    def probe(tag):
        def hook(mod, args):
            seen.append((tag, pq.quant_state(pi_m) != {},
                         pq.quant_state(pv_m) != {}))
        return hook

    hooks = [pv_m.register_forward_pre_hook(probe("uncond")),
             pi_m.register_forward_pre_hook(probe("cond"))]
    xT, a, noises = _inputs(40)
    try:
        two.sampling(xT=tensor(xT), a=tensor(a), noises=tensor(noises))
    finally:
        for h in hooks:
            h.remove()
    assert [t for t, _, _ in seen] == ["uncond"] * (SPLIT + 1) + [
        "cond"] * (T - SPLIT - 1)
    assert all((cond, un) == ((True, False) if t == "cond" else
                              (False, True)) for t, cond, un in seen)
    assert pq.quant_state(pv_m) == {} and pq.quant_state(pi_m) == {}


def test_vanilla_int8_ddim_step_matches_jax(models):
    """One quantized DDIM step of the vanilla Diff with JAX's quant
    collection carried across, within the tier's per-forward bar (an f32
    rounding difference on a .5 boundary flips one int8 unit)."""
    (jv, pv, pv_m), _ = models
    jvars = jq.calibrate(jv, {"params": pv}, (SIZE, SIZE, 3), a_dim=None,
                         T=T)
    xT, _, _ = _inputs(41)
    want = jax.jit(lambda x: js.strided_ddim_loop(
        lambda y, t, a: jv.apply(jvars, y, t), j_schedule(1e-5, 1e-2, T), x,
        jr.PRNGKey(0), None, num_steps=1))(jnp.asarray(xT))
    from_jax_quant(jax.tree.map(np.asarray, jvars["quant"]), pv_m)
    try:
        with torch.no_grad():
            got = strided_ddim_loop(lambda y, t, a: pv_m(y, t),
                                    make_schedule(1e-5, 1e-2, T), tensor(xT),
                                    None, None, num_steps=1)
    finally:
        pq.clear_quant_state(pv_m)
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= INT8_FORWARD_TOL, f"vanilla int8 DDIM step: {err:.3g}"


def test_processes_take_shape(models):
    """``shape`` (C, H, W) overrides cfg.shape for the draws of xT."""
    (_, _, pv_m), (_, _, pi_m) = models
    cfg = Config(**CFG)
    half = (3, SIZE // 2, SIZE // 2)
    gen = torch.Generator().manual_seed(0)
    for proc in (DiffusionProcess(cfg.replace(model="vanilla"), pv_m,
                                  shape=half),
                 DiffusionProcess(cfg, pi_m, shape=half)):
        assert proc.data_shape == (SIZE // 2, SIZE // 2, 3)
        out = proc.sampling(gen, sampling_number=1, num_steps=1)
        assert tuple(out.shape) == (1, SIZE // 2, SIZE // 2, 3)
    two = TwoPhaseDiffusionProcess(cfg.replace(split_step=T), pi_m, pv_m,
                                   shape=half)
    assert two.data_shape == (SIZE // 2, SIZE // 2, 3)
