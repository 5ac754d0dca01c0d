"""The port's training slice held against the JAX package on a tiny model
(T 50, a_dim 32, 16x16, ch 32, ch_mult (1, 2), attention at level 1, one
ResBlock per level, batch 4): the Encoder, ``InfoDiff.loss_fn`` and its
gradients with injected draws, the LR schedule, the clip + AdamW chain
against optax, the EMA, dropout and the prior draws. Tolerances:
tests/torch_parity.py; every gradient leaf within 2e-3 of its max abs
(f32 reassociation through the whole backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from infodiffusion_tpu import utils as jutils
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.models.unet import Encoder as JEncoder
from infodiffusion_tpu.train import state as jstate
from infodiffusion_tpu_torch import utils as putils
from infodiffusion_tpu_torch.interop import to_state_dict
from infodiffusion_tpu_torch.models.unet import Encoder
from infodiffusion_tpu_torch.models.wrappers import InfoDiff, Rngs
from infodiffusion_tpu_torch.nn.blocks import dropout
from infodiffusion_tpu_torch.train import state as pstate
from infodiffusion_tpu_torch.train.step import (
    loss_and_grads,
    make_eval_encode_step,
    make_train_step,
    step_rngs,
    update_ema,
)
from torch_parity import (
    FORWARD_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

A_DIM, T, B, SIZE = 32, 50, 4, 16
ARCH = dict(ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
GRAD_TOL = 2e-3
# A gradient leaf's error is taken relative to its max abs, floored at this
# share of the largest leaf's: some leaves are zero up to f32 noise in both
# implementations (a conv bias right before a GroupNorm with one channel
# per group is cancelled by the normalisation, and so is the key
# projection's bias by the softmax); their values are noise 1e-7 to 1e-9
# of the largest leaf.
NOISE_FLOOR = 1e-4


def _model_kw(**loss_kw):
    return dict(T=T, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
                encoder_channels=32, **ARCH, **loss_kw)


def _draws(seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
        t=np.array([0, 7, 23, 49], np.int32),
        eps=rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
        reparam_eps=rng.randn(B, A_DIM).astype(np.float32),
        prior_samples=rng.randn(B, A_DIM).astype(np.float32),
    )


def test_encoder_forward_and_eval_encode():
    rng = np.random.RandomState(40)
    x = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    rep = rng.randn(B, A_DIM).astype(np.float32)
    jm = JEncoder(a_dim=A_DIM, shape=(3, SIZE, SIZE), ch=32, **ARCH)
    params = randomize(init_variables(jm, x)["params"], seed=41)
    want = jax.jit(lambda p, x_, r: jm.apply({"params": p}, x_, reparam_eps=r))(
        params, x, rep)
    pm = port(Encoder(A_DIM, (3, SIZE, SIZE), ch=32, **ARCH), params)
    got = pm(tensor(x), reparam_eps=tensor(rep))
    for g, w, what in zip(got, want, ("a", "a_q", "mu", "log_var")):
        assert_close(g, w, FORWARD_TOL, what)

    model = InfoDiff(**_model_kw()).eval()
    port(model.encoder, params)
    for pick_mu, want_v in ((False, want[0]), (True, want[2])):
        got_v = make_eval_encode_step(model, pick_mu=pick_mu)(tensor(x))
        assert got_v.grad_fn is None
        assert_close(got_v, want_v, FORWARD_TOL, f"encode pick_mu={pick_mu}")


# the four rows of InfoDiff._route_latent (mmd, kld), the KLD rows also
# through the capacity branch
@pytest.mark.parametrize("mmd,kld,use_C", [
    (0.1, 0.0, False), (0.0, 0.0, False), (0.1, 0.5, True), (0.0, 0.5, False),
])
def test_loss_and_grads_match_jax(mmd, kld, use_C):
    loss_kw = dict(mmd_weight=mmd, kld_weight=kld, use_C=use_C, C_max=5.0,
                   epochs=4)
    jm = JInfoDiff(**_model_kw(**loss_kw))
    d = _draws(seed=42)
    x = d.pop("x")
    params = randomize(init_variables(jm, x, 0, method=JInfoDiff.loss_fn)[
        "params"], seed=43)
    epoch = 3

    def jloss(p):
        return jm.apply({"params": p}, x, epoch, method=JInfoDiff.loss_fn,
                        deterministic=True, **d)

    (want_loss, want_aux), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    model = port(InfoDiff(**_model_kw(**loss_kw)), params)
    draws = {k: tensor(v) for k, v in d.items()}
    draws["t"] = draws["t"].long()
    loss, aux, grads = loss_and_grads(model, tensor(x), epoch,
                                      deterministic=True, **draws)
    assert_close(loss, want_loss, FORWARD_TOL, "loss")
    assert set(aux) == set(want_aux)
    for key in aux:
        assert_close(aux[key], want_aux[key], FORWARD_TOL, key)

    want_by_name = to_state_dict(want_grads)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want_by_name)
    floor = NOISE_FLOOR * max(float(w.abs().max())
                              for w in want_by_name.values())
    zero_leaves = []
    for name, g in zip(names, grads):
        w = want_by_name[name].numpy()
        if not np.any(w):
            assert not torch.any(g), f"{name}: JAX's gradient is exactly 0"
            zero_leaves.append(name)
            continue
        err = float(np.abs(g.numpy() - w).max()) / max(np.abs(w).max(), floor)
        assert err <= GRAD_TOL, f"grad {name}: relative error {err:.3g}"
    # fc_mu/fc_var take part in the loss only through the KLD or a_q
    assert (len(zero_leaves) == 4) == (kld == 0), zero_leaves


def test_warmup_cosine_schedule_matches_jax():
    epochs, spe = 5, 3
    jf = jstate.warmup_cosine_schedule(1e-4, epochs, spe)
    pf = pstate.warmup_cosine_schedule(1e-4, epochs, spe)
    steps = np.arange((epochs + 3) * spe)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = np.array([pf(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grad_scale", [0.01, 100.0])  # clip off / on
def test_clip_adamw_matches_optax(grad_scale):
    rng = np.random.RandomState(44)
    shapes = {"w": (6, 5), "b": (5,), "unused": (3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads_seq = [
        {k: (grad_scale * rng.randn(*s)).astype(np.float32)
         if k != "unused" else np.zeros(s, np.float32)
         for k, s in shapes.items()}
        for _ in range(3)
    ]
    jtx = jstate.make_optimizer(1e-2, epochs=2, steps_per_epoch=1)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    ptx = pstate.make_optimizer(1e-2, epochs=2, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jp)
    popt = ptx.init(pt)
    for grads in grads_seq:
        upd, jopt = jtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                               jopt, jp)
        jp = optax.apply_updates(jp, upd)
        norm = ptx.update(pt, [torch.tensor(grads[k]) for k in pt], popt)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for k in pt:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    # the zero-gradient leaf still decays
    assert not np.array_equal(pt["unused"].numpy(), params["unused"])


def test_ema_update_matches_jax_formula():
    rng = np.random.RandomState(45)
    e = {"a": rng.randn(4, 3).astype(np.float32)}
    p = {"a": rng.randn(4, 3).astype(np.float32)}
    d = 0.999
    want = jax.tree.map(lambda e_, p_: e_ * d + p_ * (1.0 - d), e, p)
    ema = {k: torch.tensor(v) for k, v in e.items()}
    update_ema(ema, {k: torch.tensor(v) for k, v in p.items()}, d)
    np.testing.assert_allclose(ema["a"].numpy(), want["a"], rtol=1e-6)


def test_dropout_keep_rate_scale_and_repeatability():
    x = torch.rand(8, 16, 32, 32) + 0.5
    g = step_rngs(7, 3, "cpu").dropout
    y = dropout(x, 0.1, False, g)
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - 0.9) < 0.01, rate
    assert torch.equal(y[kept], x[kept] / 0.9)  # Flax: x / keep_prob
    again = dropout(x, 0.1, False, step_rngs(7, 3, "cpu").dropout)
    other = dropout(x, 0.1, False, step_rngs(7, 4, "cpu").dropout)
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert dropout(x, 0.1, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, False, None)


def test_prior_draws_match_jax_in_distribution():
    n = 100000
    labels = np.arange(n) % 10
    jz = np.asarray(jutils.gaussian_mixture(jax.random.PRNGKey(0), n, 4,
                                            label_indices=labels))
    pz = putils.gaussian_mixture(torch.Generator().manual_seed(0), n, 4,
                                 label_indices=labels).numpy()
    assert pz.shape == jz.shape == (n, 4)
    for lab in (0, 3, 7):
        sel = labels == lab
        np.testing.assert_allclose(pz[sel].mean(0), jz[sel].mean(0),
                                   atol=0.02)
        np.testing.assert_allclose(pz[sel].std(0), jz[sel].std(0), atol=0.02)
    jr_ = np.asarray(jutils.swiss_roll(jax.random.PRNGKey(1), n))
    pr = putils.swiss_roll(torch.Generator().manual_seed(1), n).numpy()
    assert pr.shape == jr_.shape == (n, 2)
    np.testing.assert_allclose(pr.mean(0), jr_.mean(0), atol=0.05)
    np.testing.assert_allclose(pr.std(0), jr_.std(0), atol=0.05)


def test_train_step_moves_every_parameter_in_the_loss():
    """Two steps with dropout on: finite metrics, every parameter that takes
    part in the loss gets a non-zero gradient and moves, and the draws
    repeat from (seed, step)."""
    torch.manual_seed(0)
    x = torch.randn(B, SIZE, SIZE, 3)
    runs = []
    for _ in range(2):
        torch.manual_seed(1)
        model = InfoDiff(**_model_kw())
        tx = pstate.make_optimizer(1e-3, 50, 10)
        st = pstate.create_train_state(model, seed=5, tx=tx, ema=True)
        before = {n: p.detach().clone() for n, p in st.params.items()}
        step = make_train_step(model, tx, ema_decay=0.9)
        metrics = []
        for _ in range(2):
            st, m = step(st, x, 0)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append(metrics)
        moved = {n for n, p in st.params.items()
                 if not torch.equal(p, before[n])}
        frozen = set(st.params) - moved
        assert frozen == {f"encoder.{m}.{p}" for m in ("fc_mu", "fc_var")
                          for p in ("weight", "bias")}, frozen
    assert st.step == 2
    assert all(np.isfinite(v) for m in runs[0] for v in m.values())
    assert set(runs[0][0]) == {"loss", "grad_norm", "denoise", "recon", "mmd"}
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="noise"):
        InfoDiff(**_model_kw()).loss_fn(x, rngs=Rngs())
