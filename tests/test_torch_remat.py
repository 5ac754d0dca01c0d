"""``INFODIFF_REMAT=1`` in the port (``nn.blocks.remat_block`` in the UNet
skeletons) on a tiny InfoDiff (T 50, a_dim 32, 16x16, ch 32, ch_mult
(1, 2), attention at level 1, one ResBlock per level, batch 4), f32 on the
CPU:

- two train steps with dropout on, from explicit generators, leave the
  parameters as the plain steps do, within 1e-6 (the recompute draws the
  forward's masks: the dropout generator is restored for it);
- the loss and every gradient leaf with injected draws match JAX's
  ``INFODIFF_REMAT=1`` (``nn.remat``) at the train harness's bars
  (``tests/test_torch_train.py``).
"""

import jax
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu_torch.interop import flax_param_tree, to_state_dict
from infodiffusion_tpu_torch.models.wrappers import InfoDiff
from infodiffusion_tpu_torch.nn import blocks
from infodiffusion_tpu_torch.train import state as pstate
from infodiffusion_tpu_torch.train.step import loss_and_grads, make_train_step
from torch_parity import (
    FORWARD_TOL,
    assert_close,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

A_DIM, T, B, SIZE = 32, 50, 4, 16
ARCH = dict(ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
KW = dict(T=T, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
          encoder_channels=32, mmd_weight=0.1, epochs=4, **ARCH)
PARAM_TOL = 1e-6
GRAD_TOL = 2e-3  # tests/test_torch_train.py's bars
NOISE_FLOOR = 1e-4


def _two_steps(monkeypatch, remat: bool):
    """Parameters and metrics after two train steps (dropout on)."""
    if remat:
        monkeypatch.setenv("INFODIFF_REMAT", "1")
    else:
        monkeypatch.delenv("INFODIFF_REMAT", raising=False)
    torch.manual_seed(1)
    model = InfoDiff(**KW)
    tx = pstate.make_optimizer(1e-3, 50, 10)
    st = pstate.create_train_state(model, seed=5, tx=tx)
    step = make_train_step(model, tx)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        B, SIZE, SIZE, 3).astype(np.float32))
    for _ in range(2):
        st, m = step(st, x, 0)
    return ({n: p.detach().clone() for n, p in st.params.items()},
            {k: float(v) for k, v in m.items()})


def test_remat_steps_equal_plain_steps_with_dropout(monkeypatch):
    calls = []
    real = blocks.remat_block

    def counted(*a, **k):
        calls.append(k.get("generator") is not None)
        return real(*a, **k)

    monkeypatch.setattr("infodiffusion_tpu_torch.models.unet.remat_block",
                        counted)
    plain, m_plain = _two_steps(monkeypatch, remat=False)
    assert not calls
    remat, m_remat = _two_steps(monkeypatch, remat=True)
    # every block of the backbone and the Encoder (8 each: 2 down, 2
    # middle, 4 up), each step, each with the step's dropout generator
    assert len(calls) == 2 * (8 + 8) and all(calls)
    assert m_remat == pytest.approx(m_plain, rel=PARAM_TOL, abs=PARAM_TOL)
    for name, p in plain.items():
        err = float((remat[name] - p).abs().max())
        assert err <= PARAM_TOL, f"{name}: {err:.3g}"


def test_remat_skipped_without_autograd(monkeypatch):
    """Sampling (no autograd) takes no checkpoint, as nothing is
    recomputed."""
    monkeypatch.setenv("INFODIFF_REMAT", "1")
    monkeypatch.setattr(
        "infodiffusion_tpu_torch.models.unet.remat_block",
        lambda *a, **k: pytest.fail("remat_block under no_grad"))
    model = InfoDiff(**KW).eval()
    x = torch.zeros(1, SIZE, SIZE, 3)
    with torch.no_grad():
        out = model(x, torch.zeros(1, dtype=torch.long),
                    torch.zeros(1, A_DIM))
    assert out.shape == x.shape


def test_remat_loss_and_grads_match_jax_remat(monkeypatch):
    monkeypatch.setenv("INFODIFF_REMAT", "1")
    rng = np.random.RandomState(42)
    x = rng.randn(B, SIZE, SIZE, 3).astype(np.float32)
    d = dict(t=np.array([0, 7, 23, 49], np.int32),
             eps=rng.randn(B, SIZE, SIZE, 3).astype(np.float32),
             reparam_eps=rng.randn(B, A_DIM).astype(np.float32),
             prior_samples=rng.randn(B, A_DIM).astype(np.float32))
    jm = JInfoDiff(**KW)
    model = InfoDiff(**KW)
    # the parameters' shapes without tracing the init
    params = randomize(flax_param_tree(
        model, lambda shape: np.zeros(shape, np.float32)), seed=43)

    def jloss(p):
        return jm.apply({"params": p}, x, 3, method=JInfoDiff.loss_fn,
                        deterministic=True, **d)

    (want_loss, want_aux), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    model = port(model, params)
    draws = {k: tensor(v) for k, v in d.items()}
    draws["t"] = draws["t"].long()
    loss, aux, grads = loss_and_grads(model, tensor(x), 3,
                                      deterministic=True, **draws)
    assert_close(loss, want_loss, FORWARD_TOL, "loss")
    for key in aux:
        assert_close(aux[key], want_aux[key], FORWARD_TOL, key)
    want_by_name = to_state_dict(want_grads)
    floor = NOISE_FLOOR * max(float(w.abs().max())
                              for w in want_by_name.values())
    for (name, _), g in zip(model.named_parameters(), grads):
        w = want_by_name[name].numpy()
        if not np.any(w):
            assert not torch.any(g), f"{name}: JAX's gradient is exactly 0"
            continue
        err = float(np.abs(g.numpy() - w).max()) / max(np.abs(w).max(), floor)
        assert err <= GRAD_TOL, f"grad {name}: relative error {err:.3g}"
