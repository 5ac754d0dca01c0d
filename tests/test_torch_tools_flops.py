"""``tools.flops_report`` against XLA's HLO cost analysis of the JAX
package (the lowered program's, as ``jax.jit(...).lower(...)`` reports
it), on a tiny InfoDiff (a_dim 32, 32x32, ch 32, ch_mult (1, 2),
attention at level 1, one ResBlock per level, batch 4):

- a single convolution (padding 1, strides 1 and 2, even and odd sizes)
  and a single product: the port's valid-tap count equals XLA's exactly;
- the forward and the train step: XLA's count exceeds the valid-tap count
  only by the elementwise FLOPs it counts besides (bias adds, norms,
  activations, residual adds, the optimizer), under 2% of its count here
  (1.7% for the forward, 0.05% for the train step), so the valid-tap
  count is the mfu basis; the all-taps count adds only the padding taps
  of the convolutions;
- the count is the same on the ``meta`` device and on the CPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.train import (
    TrainState,
    make_optimizer,
    make_train_step,
)
from infodiffusion_tpu_torch.interop import flax_param_tree
from infodiffusion_tpu_torch.models.wrappers import InfoDiff
from infodiffusion_tpu_torch.tools import flops_report

B, SIZE, A_DIM = 4, 32, 32
KW = dict(T=1000, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
          encoder_channels=32, ch_mult=(1, 2), attn=(1,), num_res_blocks=1,
          mmd_weight=0.1, epochs=50)
ELEMENTWISE_SHARE = 0.02


def _xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).cost_analysis()
    return float((cost[0] if isinstance(cost, list) else cost)["flops"])


@pytest.mark.parametrize("n,stride,cin,cout", [
    (8, 1, 4, 8), (8, 2, 4, 8), (7, 1, 3, 5), (7, 2, 3, 5), (16, 1, 8, 8)])
def test_conv_counts_valid_taps_as_xla(n, stride, cin, cout):
    x = np.zeros((2, n, n, cin), np.float32)
    w = np.zeros((3, 3, cin, cout), np.float32)
    want = _xla_flops(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")), x, w)
    conv = torch.nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
    got = flops_report.count(lambda: conv(torch.zeros(2, cin, n, n)), 1)
    assert got["valid_taps"]["convolution"] * 1e9 == pytest.approx(want,
                                                                   rel=1e-12)
    assert got["all_taps"]["convolution"] >= got["valid_taps"]["convolution"]


def test_product_counts_as_xla():
    a, b = np.zeros((6, 10), np.float32), np.zeros((10, 7), np.float32)
    want = _xla_flops(jnp.matmul, a, b)
    got = flops_report.count(
        lambda: torch.zeros(6, 10) @ torch.zeros(10, 7), 1)
    assert got["all_taps"]["total"] * 1e9 == want == 2 * 6 * 10 * 7


@pytest.fixture(scope="module")
def port_counts():
    with torch.device("meta"):
        model = InfoDiff(**KW)
    kw = dict(batch=B, size=SIZE, model=model, a_dim=A_DIM)
    return (flops_report.forward_counts(**kw),
            flops_report.train_step_counts(**kw))


@pytest.fixture(scope="module")
def xla_counts():
    model = JInfoDiff(**KW)
    x = jnp.zeros((B, SIZE, SIZE, 3))
    tx = make_optimizer(1e-4, 50, 1000)
    # create_train_state's shapes without tracing the init
    with torch.device("meta"):
        params = flax_param_tree(
            InfoDiff(**KW), lambda s: jax.ShapeDtypeStruct(s, jnp.float32))
    state = TrainState(step=jax.ShapeDtypeStruct((), jnp.int32),
                       params=params, opt_state=jax.eval_shape(tx.init,
                                                               params),
                       rng=jax.eval_shape(lambda: jr.PRNGKey(0)),
                       ema_params=None)
    fwd = _xla_flops(lambda v, x, t, a: model.apply(v, x, t, a),
                     {"params": params}, x, jnp.zeros((B,), jnp.int32),
                     jnp.zeros((B, A_DIM)))
    cost = make_train_step(model, tx, donate=False).lower(
        state, x, 0).cost_analysis()
    train = float((cost[0] if isinstance(cost, list) else cost)["flops"])
    return fwd / B / 1e9, train / B / 1e9


@pytest.mark.parametrize("which", [0, 1], ids=["forward", "train_step"])
def test_counts_against_xla(port_counts, xla_counts, which):
    got, want = port_counts[which], xla_counts[which]
    valid, every = got["valid_taps"], got["all_taps"]
    assert valid["total"] <= want <= valid["total"] * (1 + ELEMENTWISE_SHARE)
    # the conventions differ in the convolutions' padding taps only
    assert {k: v for k, v in every.items() if "conv" not in k
            and k != "total"} == {k: v for k, v in valid.items()
                                  if "conv" not in k and k != "total"}
    assert every["total"] > valid["total"]


def test_count_is_the_same_on_meta_and_the_cpu(port_counts):
    torch.manual_seed(0)
    model = InfoDiff(**KW)
    kw = dict(batch=B, size=SIZE, model=model, a_dim=A_DIM)
    assert flops_report.forward_counts(**kw) == port_counts[0]
    assert flops_report.train_step_counts(**kw) == port_counts[1]


def test_achieved_only_from_a_measured_rate():
    assert flops_report.achieved(None, 15.0, "card") is None
    got = flops_report.achieved(1000.0, 80.0, "NVIDIA H100 80GB HBM3, 700 W")
    assert got["tflops"] == pytest.approx(80.0)
    assert got["share"] == pytest.approx(80.0 / 989.0)
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700 W"
