"""GPipe over the LatentUNet's middle layers (``--pp``) on 2 and 4 gloo
ranks against the JAX package's executor on its virtual CPU mesh, with the
same weights: the pipelined forward (``latent_pp_forward``), the loss and
its gradients (``pp_latent_loss``), and the first pp train step's loss
(``make_pp_train_step`` with ``deterministic_dropout_off``) on the port's
own step draws; S=2 and S=4 stages, and dp x pp (2 x 2). Then the port's
pipelined train steps, dropout off and on, against its one-process steps:
the pipeline draws every dropout layer's bits for the whole batch in the
sequential model's order, so the two agree with dropout on too. Bars: the
JAX tests' (forward 1e-5, gradients 1e-4, the loss rel 1e-5, parameters
1e-5)."""

import functools
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from infodiffusion_tpu.diffusion.schedule import make_schedule, q_sample
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.parallel.pp import (
    latent_pp_forward,
    make_dp_stage_mesh as jdp_stage_mesh,
    make_stage_mesh as jstage_mesh,
    pp_latent_loss,
)
from infodiffusion_tpu_torch.interop import to_state_dict
from infodiffusion_tpu_torch.parallel.launch import spawn
from infodiffusion_tpu_torch.train.step import step_rngs

HERE = os.path.dirname(os.path.abspath(__file__))
T_STEPS = 16
# (world, stages, microbatches): S=2 and 4, and 2 pipelines of 2 stages
CONFIGS = {2: ((2, 2), (2, 4)), 4: ((4, 4), (2, 2))}
CASES = [(w, s, m) for w, cs in CONFIGS.items() for s, m in cs]

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def jax_setup():
    """JAX Diff(is_latent) params, the step's inputs and the state dict."""
    D, B = W.LATENT_D, W.LATENT_BATCH
    model = JDiff(T=T_STEPS, shape=(1, D, D), is_latent=True)
    rs = np.random.RandomState(3)
    x = rs.randn(B, D).astype(np.float32)
    t = rs.randint(0, T_STEPS, size=(B,)).astype(np.int64)
    eps = rs.randn(B, D).astype(np.float32)
    params = model.init({"params": jr.PRNGKey(0), "noise": jr.PRNGKey(1),
                         "dropout": jr.PRNGKey(2)}, jnp.asarray(x), 0,
                        method=JDiff.loss_fn)["params"]
    # perturb the zero biases so that every gradient leaf is exercised
    leaves, tdef = jax.tree.flatten(params)
    keys = jr.split(jr.PRNGKey(9), len(leaves))
    params = jax.tree.unflatten(tdef, [
        l + 0.05 * jr.normal(k, l.shape) for l, k in zip(leaves, keys)])
    return model, params, x, t, eps


def _mesh(world, S):
    return jstage_mesh(S) if world == S else jdp_stage_mesh(world // S, S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, params, x, t, eps = jax_setup()
    sd = to_state_dict(params)
    out = {}
    for world, configs in CONFIGS.items():
        work = str(tmp_path_factory.mktemp(f"pp{world}"))
        out[world] = spawn(
            "torch_dist_workers:pp_battery", world,
            {"state_dict": sd, "x": torch.from_numpy(x),
             "t": torch.from_numpy(t), "eps": torch.from_numpy(eps),
             "configs": configs},
            workdir=work, timeout=300, pythonpath=[HERE])
    return out


def _assemble(results, key):
    """The ranks' rows of one config's forward, in data order (stage 0
    of each pipeline; every stage holds the same)."""
    rows = {}
    for r in results:
        got = r[key]
        if got["d"] in rows:
            assert torch.equal(rows[got["d"]], got["fwd"])
        rows[got["d"]] = got["fwd"]
    return torch.cat([rows[d] for d in sorted(rows)])


@pytest.mark.parametrize("world,S,M", CASES)
def test_pp_forward_matches_jax(runs, world, S, M):
    model, params, x, t, _ = jax_setup()
    want = jax.jit(lambda p: latent_pp_forward(
        p, jnp.asarray(x), jnp.asarray(t), mesh=_mesh(world, S),
        microbatches=M))(params["backbone"])
    got = _assemble(runs[world], (S, M))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("world,S,M", CASES)
def test_pp_grads_match_jax(runs, world, S, M):
    model, params, x, t, eps = jax_setup()
    sched = make_schedule(model.beta1, model.betaT, model.T)
    x_tilde = q_sample(sched, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(eps))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: pp_latent_loss(p, x_tilde, jnp.asarray(t),
                                 jnp.asarray(eps), mesh=_mesh(world, S),
                                 microbatches=M)))(params)
    want = to_state_dict(grads)
    for r in runs[world]:
        got = r[(S, M)]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        assert set(got["grads"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                       atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("world,S,M", CASES)
def test_pp_train_step_loss_matches_jax(runs, world, S, M):
    """The first dropout-off step's loss against JAX's pipelined loss on
    the step's own draws (the port's (seed, step) generators)."""
    model, params, *_ = jax_setup()
    x = W.latent_batch()
    rngs = step_rngs(W.SEED, 0, "cpu")
    t = torch.randint(0, T_STEPS, (x.shape[0],), generator=rngs.noise)
    eps = torch.randn(x.shape, generator=rngs.noise)
    sched = make_schedule(model.beta1, model.betaT, model.T)
    tj, ej = jnp.asarray(t.numpy()), jnp.asarray(eps.numpy())
    want = jax.jit(lambda p: pp_latent_loss(
        p, q_sample(sched, jnp.asarray(x.numpy()), tj, ej), tj, ej,
        mesh=_mesh(world, S), microbatches=M))(params)
    for r in runs[world]:
        got = r[(S, M)]["steps"][True]["metrics"][0]
        np.testing.assert_allclose(got["loss"], float(want), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _one_process(dropout_off):
    return W.latent_one_process(dropout_off, to_state_dict(jax_setup()[1]))


@pytest.mark.parametrize("dropout_off", [True, False])
@pytest.mark.parametrize("world,S,M", CASES)
def test_pp_steps_match_one_process(runs, world, S, M, dropout_off):
    want = _one_process(dropout_off)
    for r in runs[world]:
        got = r[(S, M)]["steps"][dropout_off]
        assert got["layers"] == list(range(1 + got["stage"] * 8 // S,
                                           1 + (got["stage"] + 1) * 8 // S))
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=1e-5)
        for k, v in want["params"].items():
            err = (got["params"][k] - v).abs().max().item()
            assert err <= 1e-5, (k, err)


def test_latent_unet_dropout_as_jax():
    """The JAX LatentUNet drops units (rate 0.1) after layers 0 .. 8 in
    training; the port's did not before the pipeline needed its draws.
    Layer by layer, the share of units a dropout-on forward zeroes, over a
    large batch, against the rate; the last layer has none."""
    from infodiffusion_tpu.models.wrappers import LATENT_BACKBONE_KWARGS
    from infodiffusion_tpu_torch.models.latent_unet import DROPOUT, NUM_LAYERS

    assert DROPOUT == LATENT_BACKBONE_KWARGS["dropout"]
    assert NUM_LAYERS == LATENT_BACKBONE_KWARGS["num_layers"]
    bb = W.tiny_latent().backbone
    x = torch.randn(4096, W.LATENT_D, generator=torch.Generator().manual_seed(0))
    t = torch.zeros(4096, dtype=torch.long)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        temb = bb.time_embed(t)
        h = None
        for i in range(NUM_LAYERS):
            det = bb.layer(i, h, x, temb)
            h = bb.layer(i, h, x, temb, deterministic=False, generator=gen)
            dropped = ((h == 0) & (det != 0)).float().mean().item()
            if i < NUM_LAYERS - 1:
                assert abs(dropped - DROPOUT) < 0.01, (i, dropped)
                kept = h != 0
                torch.testing.assert_close(h[kept], det[kept] / (1 - DROPOUT))
            else:
                assert dropped == 0.0
