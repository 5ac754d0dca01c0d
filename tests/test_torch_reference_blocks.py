"""The reference's blocks that no model builds, held against the JAX
package: ``CrossAttnBlock`` (queries from ``a``, keys and values from ``x``,
one shared GroupNorm) and the 1-D ``LatentDownSample`` / ``LatentUpSample``,
on the same numpy inputs with the JAX params moved across by
``from_jax_params`` under ``load_state_dict(strict=True)``. Tolerance:
FORWARD_TOL (tests/torch_parity.py), f32."""

import numpy as np
import pytest
import torch

from infodiffusion_tpu.nn.attention import CrossAttnBlock as JCrossAttnBlock
from infodiffusion_tpu.nn.blocks import LatentDownSample as JLatentDownSample
from infodiffusion_tpu.nn.blocks import LatentUpSample as JLatentUpSample
from infodiffusion_tpu_torch.nn.attention import CrossAttnBlock
from infodiffusion_tpu_torch.nn.blocks import LatentDownSample, LatentUpSample
from torch_parity import (
    FORWARD_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW channels_last layout."""
    return tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("channels", [32, 64])
def test_cross_attn_block(channels):
    rng = np.random.RandomState(channels)
    x = rng.randn(2, 8, 8, channels).astype(np.float32)
    # a on another scale and offset: the shared norm must normalize each
    a = (3.0 * rng.randn(2, 8, 8, channels) + 1.0).astype(np.float32)
    jm = JCrossAttnBlock()
    params = randomize(init_variables(jm, x, a)["params"], seed=5)
    want = jm.apply({"params": params}, x, a)
    got = port(CrossAttnBlock(channels), params)(_nchw(x), _nchw(a))
    assert_close(got.permute(0, 2, 3, 1), want, FORWARD_TOL,
                 "CrossAttnBlock")
    # queries from a: swapping the inputs changes the output
    swapped = jm.apply({"params": params}, a, x)
    assert not np.allclose(np.asarray(swapped), np.asarray(want))


def test_cross_attn_block_keeps_reference_names():
    names = set(CrossAttnBlock(32).state_dict())
    assert names == {f"{m}.{p}" for m in ("group_norm", "proj_q", "proj_k",
                                          "proj_v", "proj")
                     for p in ("weight", "bias")}


@pytest.mark.parametrize("length", [7, 8])
def test_latent_down_sample(length):
    rng = np.random.RandomState(length)
    x = rng.randn(3, length, 16).astype(np.float32)
    jm = JLatentDownSample()
    params = randomize(init_variables(jm, x)["params"], seed=6)
    want = jm.apply({"params": params}, x)
    got = port(LatentDownSample(16), params)(tensor(x))
    assert tuple(got.shape) == (3, (length + 1) // 2, 16)
    assert_close(got, want, FORWARD_TOL, "LatentDownSample")


@pytest.mark.parametrize("length", [5, 8])
def test_latent_up_sample(length):
    rng = np.random.RandomState(10 + length)
    x = rng.randn(3, length, 16).astype(np.float32)
    jm = JLatentUpSample()
    params = randomize(init_variables(jm, x)["params"], seed=7)
    want = jm.apply({"params": params}, x)
    got = port(LatentUpSample(16), params)(tensor(x))
    assert tuple(got.shape) == (3, 2 * length, 16)
    assert_close(got, want, FORWARD_TOL, "LatentUpSample")
    assert set(LatentUpSample(16).state_dict()) == {"conv.weight",
                                                    "conv.bias"}
