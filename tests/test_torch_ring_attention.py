"""Ring attention (``--sp``) on 2 and 4 gloo ranks against the JAX
package's ``ring_attention`` on its virtual CPU mesh of as many devices,
forward and q/k/v gradients, on the same inputs (f32: 1e-5 forward, 1e-4
gradients, the JAX tests' bars; bf16 forward against JAX's bf16 ring within
its bf16 test's 3e-2). Then the model under ``--sp``: the gradients of a
vanilla UNet whose attention sits at its deepest level (JAX's
test_sp_grads_deep_attention_level, where a weight gradient once came out
S times too large) with the ring route taken, on every rank, against the
port's dense gradients."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from infodiffusion_tpu.parallel.ring_attention import (
    make_seq_mesh,
    ring_attention,
)
from infodiffusion_tpu_torch.parallel.launch import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = (2, 64, 32)  # B, N, C
MIN_TOKENS = 16  # the deep UNet's attention has 16 tokens

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for S in (2, 4):
        work = str(tmp_path_factory.mktemp(f"ring{S}"))
        out[S] = spawn("torch_dist_workers:ring_battery", S,
                       {"shape": SHAPE, "min_tokens": MIN_TOKENS},
                       workdir=work, timeout=300, pythonpath=[HERE])
    return out


@functools.lru_cache(maxsize=None)
def _jax_ring(S, dtype):
    q, k, v, do = (jnp.asarray(x.numpy(), dtype)
                   for x in W.ring_inputs(*SHAPE))
    mesh = make_seq_mesh(S)

    @jax.jit
    def fwd_bwd(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: ring_attention(q, k, v, mesh=mesh), q, k, v)
        return out, vjp(do)

    return fwd_bwd(q, k, v, do)


@pytest.mark.parametrize("S", [2, 4])
def test_ring_forward_matches_jax(runs, S):
    out, _ = _jax_ring(S, jnp.float32)
    for r in runs[S]:
        np.testing.assert_allclose(r["f32"]["out"].numpy(), np.asarray(out),
                                   atol=1e-5)


@pytest.mark.parametrize("S", [2, 4])
def test_ring_gradients_match_jax(runs, S):
    _, grads = _jax_ring(S, jnp.float32)
    for r in runs[S]:
        for name, want in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(r["f32"][name].numpy(),
                                       np.asarray(want), atol=1e-4,
                                       rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("S", [2, 4])
def test_ring_bf16_policy_matches_jax(runs, S):
    out, _ = _jax_ring(S, jnp.bfloat16)
    for r in runs[S]:
        got = r["bf16"]
        assert got["out"].dtype == torch.bfloat16
        assert got["dq"].dtype == torch.bfloat16
        np.testing.assert_allclose(got["out"].float().numpy(),
                                   np.asarray(out, np.float32), atol=3e-2)


@pytest.mark.parametrize("S", [2, 4])
def test_sp_grads_deep_attention_level(runs, S):
    model, x, t = W.deep_unet()
    want = W.unet_grads(model, x, t)
    for r in runs[S]:
        got = r["unet"]
        # one attention forward (the middle block's, 16 tokens) and the
        # up path's at level 2, both through the ring
        assert got["ring_calls"] >= 1
        for k, g in want.items():
            err = (got["grads"][k] - g).abs().max().item()
            assert err <= 1e-4 + 1e-3 * g.norm().item(), (k, err)
        for k in want:
            assert torch.equal(got["grads"][k], runs[S][0]["unet"]["grads"][k])
