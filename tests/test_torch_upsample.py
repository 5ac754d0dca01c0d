"""``INFODIFF_SUBPIXEL_UPSAMPLE=1`` held against the JAX package's
``_SubpixelUpConv``: the port keeps the literal ``UpSample`` conv (the
same function; the four-phase form measured slower on the H100, PERF.md)
and, under the variable, runs it unquantized in the int8 tiers, as JAX's
form is. Its forward and gradients against JAX's subpixel form, and the
int8 tier's calibration sites and forward under the variable.

Tolerances: forwards within 2e-5 of the output's max abs (the JAX
package's own bar for the two forms, tests/test_ops.py: the kernel entries
re-associated, f32); gradients within 1e-4 (the same sums, transposed, and
the upsampled gradient summed back over the four phases); calibrated
absmax within 1e-4 relative (a max over one f32 forward); the int8 forward
under the variable within 5e-3 of JAX's where no int8 unit flips, else
``torch_parity.CASCADE_TOL`` (granted by ``int8_flipped`` only for a
rounding flip).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import AuxiliaryUNet as JAuxiliaryUNet
from infodiffusion_tpu.nn.blocks import UpSample as JUpSample
from infodiffusion_tpu.ops import quant as jq
from infodiffusion_tpu_torch.interop import from_jax_quant
from infodiffusion_tpu_torch.models.unet import AuxiliaryUNet
from infodiffusion_tpu_torch.nn.blocks import UpSample
from infodiffusion_tpu_torch.ops import quant as pq
from torch_parity import (
    CASCADE_TOL,
    assert_close,
    init_variables,
    int8_flipped,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

FORWARD_TOL = 2e-5
GRAD_TOL = 1e-4
ABSMAX_TOL = 1e-4
INT8_FORWARD_TOL = 5e-3
SUBPIXEL = "INFODIFF_SUBPIXEL_UPSAMPLE"
SHAPES = [(2, 5, 7, 32), (1, 8, 8, 64)]


def _pair(shape, seed):
    """(JAX UpSample, its params, the port's UpSample, x NHWC)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jm = JUpSample()
    params = randomize(init_variables(jm, x)["params"], seed=seed + 1)
    return jm, params, port(UpSample(shape[-1]), params), x


def _nchw(x):
    return tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_subpixel_forward_matches_jax_and_literal(shape, monkeypatch):
    """JAX's four-phase form against the port's UpSample under the
    variable, which in the model dtype is the literal conv unchanged."""
    jm, params, pm, x = _pair(shape, 1)
    with torch.no_grad():
        literal = pm(_nchw(x))
        monkeypatch.setenv(SUBPIXEL, "1")
        got = pm(_nchw(x))
    want = jm.apply({"params": params}, x)  # JAX reads the variable too
    B, H, W, C = shape
    assert tuple(got.shape) == (B, C, 2 * H, 2 * W)
    assert_close(got.permute(0, 2, 3, 1), want, FORWARD_TOL,
                 "literal vs JAX subpixel")
    assert torch.equal(got, literal)


@pytest.mark.parametrize("shape", SHAPES)
def test_subpixel_gradients_match_jax(shape, monkeypatch):
    """d/dx, d/dkernel and d/dbias of <out, g> for a random cotangent g,
    through autograd against jax.grad of JAX's subpixel form."""
    monkeypatch.setenv(SUBPIXEL, "1")
    jm, params, pm, x = _pair(shape, 2)
    B, H, W, C = shape
    g = np.random.RandomState(3).randn(B, 2 * H, 2 * W, C).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * g)

    jp, jx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _nchw(x).requires_grad_(True)
    (pm(xt) * _nchw(g)).sum().backward()
    assert_close(xt.grad.permute(0, 2, 3, 1), jx, GRAD_TOL, "d/dx")
    # torch's OIHW weight is the HWIO kernel transposed
    assert_close(pm.conv.weight.grad.permute(2, 3, 1, 0),
                 jp["conv"]["kernel"], GRAD_TOL, "d/dkernel")
    assert_close(pm.conv.bias.grad, jp["conv"]["bias"], GRAD_TOL, "d/dbias")


class _NHWCUp(torch.nn.Module):
    """An UpSample as ``calibrate`` calls a model: ``(x NHWC, t)``."""

    def __init__(self, up):
        super().__init__()
        self.up = up

    def forward(self, x, t):
        return self.up(x.permute(0, 3, 1, 2))


def test_subpixel_runs_in_the_model_dtype(monkeypatch):
    """bf16 with the int8 tier's quant state: the upsample conv runs W8A8,
    and under the variable it runs in the model dtype, bitwise the conv
    without quant state, and calibrating observes nothing there."""
    rng = np.random.RandomState(4)
    up = UpSample(32, dtype=torch.bfloat16)
    x = tensor(rng.randn(2, 6, 6, 32).astype(np.float32))
    with torch.no_grad():
        plain = up(x.permute(0, 3, 1, 2))
        pq.calibrate(_NHWCUp(up), (6, 6, 32), x=x)
        assert up.conv.act_absmax is not None and up.conv.quantized
        int8 = up(x.permute(0, 3, 1, 2))
        monkeypatch.setenv(SUBPIXEL, "1")
        got = up(x.permute(0, 3, 1, 2))
        assert not up.conv.quantized and pq.quant_sites(up) == {}
        pq.calibrate(_NHWCUp(up), (6, 6, 32), x=x)
    assert got.dtype == plain.dtype == torch.bfloat16
    assert torch.equal(got, plain)
    assert not torch.equal(int8, plain)  # the int8 conv did run
    assert up.conv.act_absmax is None


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


@pytest.mark.parametrize("mode", ["int8", "int8x"])
def test_subpixel_calibration_sites_match_jax(mode, monkeypatch):
    """Under the variable the upsample conv is no quantized conv: JAX's
    calibrate gives it no act_absmax, nor does the port's, whose
    quant_sites and from_jax_quant see the same set; the model then runs
    JAX's int8 forward, the upsample in f32."""
    monkeypatch.setenv(SUBPIXEL, "1")
    T, A, S = 10, 4, 16
    arch = dict(ch=32, ch_mult=(1, 2), attn=(1,), out_ch=1)
    jm = JAuxiliaryUNet(T=T, a_dim=A, **arch)
    rng = np.random.RandomState(5)
    x = rng.randn(2, S, S, 1).astype(np.float32)
    t = np.array([3, 7], np.int32)
    a = rng.randn(2, A).astype(np.float32)
    params = randomize(init_variables(jm, x, t, a)["params"], seed=6)
    jv = jq.calibrate(jm, {"params": params}, (S, S, 1), a_dim=A, T=T,
                      batch=8, mode=mode)
    want = _flat(jv["quant"])
    assert "unet.up_1.conv.act_absmax" not in want
    kx, ka = jr.split(jr.PRNGKey(0))
    pm = port(AuxiliaryUNet(T=T, a_dim=A, **arch), params)
    pq.calibrate(pm, (S, S, 1), a_dim=A, T=T,
                 x=tensor(jr.normal(kx, (8, S, S, 1))),
                 a=tensor(jr.normal(ka, (8, A))), mode=mode)
    got = {k: v.numpy() for k, v in pq.quant_state(pm).items()}
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if name.endswith("absmax"):
            err = np.max(np.abs(got[name] - value) / value)
            assert err <= ABSMAX_TOL, f"{name}: {err:.3g}"
    sites = pq.quant_sites(pm)
    assert "unet.up_1.conv.act_absmax" not in sites
    pm = from_jax_quant(jv["quant"], pm)
    with torch.no_grad():
        y = pm(tensor(x), tensor(t).long(), tensor(a))
    ref = np.asarray(jm.apply(jv, x, t, a))
    err = np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref)
    bar = (CASCADE_TOL if int8_flipped(pm, jm, jv, (x, t, a))
           else INT8_FORWARD_TOL)
    assert err <= bar, f"{mode} forward under subpixel: {err:.3g}"
    # the literal form's sites hold the upsample conv again
    monkeypatch.delenv(SUBPIXEL)
    assert "unet.up_1.conv.act_absmax" in pq.quant_sites(pm)
    with pytest.raises(ValueError, match="missing.*up_1.conv.act_absmax"):
        from_jax_quant(jv["quant"], pm)
