"""Attention at C = 64, the InfoDiff UNet's width at ch 32 (mnist, fmnist
and dsprites at 32px: N = 64 at level 2 and N = 16 in the middle block;
chairs at 64px: N = 256 and N = 64), held against the JAX package on the
CPU: the attention family's channel lists and per-C launch counters, K3a's
and K3b's plain versions against the Pallas kernels (interpret mode) at
C = 64, and the mnist and chairs InfoDiff as ``with_dataset_config()``
builds them, cut to one ResBlock per level and T = 50: forward, loss and
every gradient leaf, with the attention sites checked to run at C = 64.
Inputs and params from numpy seeds. Tolerances: tests/torch_parity.py;
bf16 kernels 2e-2 of max abs (the rounding of w and ds); gradient leaves
as tests/test_torch_train.py (2e-3 of the leaf's max abs, floored at 1e-4
of the largest leaf's: f32 reassociation through the whole backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.ops.pallas import flash_attention as jfa
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.interop import to_state_dict
from infodiffusion_tpu_torch.models.wrappers import InfoDiff, pick_ch_mult
from infodiffusion_tpu_torch.ops.cuda import attention as pk2
from infodiffusion_tpu_torch.ops.cuda import flash_attention as pfa
from infodiffusion_tpu_torch.train.step import loss_and_grads
from torch_parity import (
    FORWARD_TOL,
    OP_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

BF16_TOL = 2e-2
GRAD_TOL, NOISE_FLOOR = 2e-3, 1e-4  # as tests/test_torch_train.py
A_DIM, T, B = 32, 50, 2
# the attention sites (N, C) of one UNet forward per dataset
SITES = {"mnist": {(64, 64), (16, 64)}, "chairs": {(256, 64), (64, 64)}}


def _qkvdo(N, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, N, 64).astype(np.float32) for _ in range(4)]


def test_attention_family_takes_c64():
    assert 64 in pk2.CHANNELS and 64 in pfa.CHANNELS  # K2 and K2'; K3a-c
    for fn in (pk2.attention_cuda, pfa.flash_attention_cuda,
               pfa.flash_attention_online_cuda, pfa.flash_attention_bwd_cuda):
        assert set(fn.launches_by_c) == {64, 128, 256, 512}, fn.__name__


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_plain_matches_jax_at_c64(dtype):
    """K3a's plain version (K2's contract) against the Pallas forward."""
    q, k, v, _ = _qkvdo(512, seed=90)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jfa.flash_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                               interpret=True)
    got = pk2.attention_reference(*(tensor(t).to(pdt) for t in (q, k, v)))
    assert got.dtype == pdt
    tol = OP_TOL if dtype == "float32" else BF16_TOL
    assert_close(got.float(), np.asarray(want, np.float32), tol, "K3a C=64")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [16, 256])
def test_flash_backward_plain_matches_jax_at_c64(dtype, N):
    """K3b's plain version against the Pallas backward at the mnist middle
    block's N = 16 and the chairs level 2's N = 256 (four q tiles)."""
    arrays = _qkvdo(N, seed=91 + N)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jfa._bwd_call(*(jnp.asarray(t, jdt) for t in arrays),
                         interpret=True, block_q=min(N, 64))
    got = pfa.flash_attention_bwd_reference(
        *(tensor(t).to(pdt) for t in arrays))
    tol = OP_TOL if dtype == "float32" else BF16_TOL
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == pdt
        assert_close(g.float(), np.asarray(w, np.float32), tol, what)


def _model_kw(dataset):
    cfg = Config(model="diff", dataset=dataset, a_dim=A_DIM,
                 diffusion_steps=T).with_dataset_config()
    assert cfg.unets_channels == 32  # level 2 attends at C = 2 * 32
    kw = dict(T=T, a_dim=A_DIM, shape=cfg.shape,
              unets_channels=cfg.unets_channels,
              encoder_channels=cfg.encoder_channels,
              ch_mult=pick_ch_mult("diff", cfg.input_size), attn=(2,),
              num_res_blocks=1, mmd_weight=cfg.mmd_weight)
    return cfg, kw


@pytest.fixture(scope="module", params=["mnist", "chairs"])
def infodiff(request):
    dataset = request.param
    cfg, kw = _model_kw(dataset)
    rng = np.random.RandomState(92)
    size, ch = cfg.input_size, cfg.input_channels
    d = dict(x=rng.randn(B, size, size, ch).astype(np.float32),
             t=np.array([3, 41], np.int32),
             eps=rng.randn(B, size, size, ch).astype(np.float32),
             reparam_eps=rng.randn(B, A_DIM).astype(np.float32),
             prior_samples=rng.randn(B, A_DIM).astype(np.float32),
             a=rng.randn(B, A_DIM).astype(np.float32))
    jm = JInfoDiff(**kw)
    params = randomize(init_variables(jm, d["x"], 0,
                                      method=JInfoDiff.loss_fn)["params"],
                       seed=93)
    return dataset, jm, params, port(InfoDiff(**kw), params), d


def _record_sites(monkeypatch):
    """The (N, C) of every attention call on the CPU, by route."""
    sites = set()
    for route, (kernel, plain) in list(pfa._FORWARDS.items()):
        def run(q, k, v, plain=plain):
            sites.add(tuple(q.shape[1:]))
            return plain(q, k, v)
        monkeypatch.setitem(pfa._FORWARDS, route, (kernel, run))
    return sites


def test_infodiff_c64_forward_matches_jax(infodiff, monkeypatch):
    dataset, jm, params, pm, d = infodiff
    want = jax.jit(jm.apply)({"params": params}, d["x"], d["t"], d["a"])
    sites = _record_sites(monkeypatch)
    got = pm(tensor(d["x"]), tensor(d["t"]).long(), tensor(d["a"]))
    assert sites == SITES[dataset]
    assert_close(got, want, FORWARD_TOL, f"{dataset} forward")


def test_infodiff_c64_loss_and_grads_match_jax(infodiff, monkeypatch):
    dataset, jm, params, pm, d = infodiff
    draws = {k: d[k] for k in ("t", "eps", "reparam_eps", "prior_samples")}

    def jloss(p):
        return jm.apply({"params": p}, d["x"], 0, method=JInfoDiff.loss_fn,
                        deterministic=True, **draws)

    (want_loss, _), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    sites = _record_sites(monkeypatch)
    tdraws = {k: tensor(v) for k, v in draws.items()}
    tdraws["t"] = tdraws["t"].long()
    loss, _, grads = loss_and_grads(pm, tensor(d["x"]), 0,
                                    deterministic=True, **tdraws)
    assert {c for _, c in sites} == {64}
    assert_close(loss, want_loss, FORWARD_TOL, f"{dataset} loss")
    want_by_name = to_state_dict(want_grads)
    names = [n for n, _ in pm.named_parameters()]
    assert set(names) == set(want_by_name)
    floor = NOISE_FLOOR * max(float(w.abs().max())
                              for w in want_by_name.values())
    for name, g in zip(names, grads):
        w = want_by_name[name].numpy()
        if not np.any(w):
            assert not torch.any(g), f"{name}: JAX's gradient is exactly 0"
            continue
        err = float(np.abs(g.numpy() - w).max()) / max(np.abs(w).max(), floor)
        assert err <= GRAD_TOL, f"{dataset} grad {name}: {err:.3g}"
