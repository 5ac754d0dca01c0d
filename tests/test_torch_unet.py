"""The port's other backbones held against the JAX package: ResBlock, the
UNet skeleton in all four ``aux_mode``s, BottleneckAuxUNet, the image Diff
(forward and loss), the Decoder and the VAE (forward and loss, both
regularizers), ``build_model``, the initializers (in distribution) and the
attention kernel's plain version at the vanilla UNet's C=256 and 512. The
same numpy inputs on both sides, the JAX params moved across by
``from_jax_params`` under ``load_state_dict(strict=True)``. Tolerances:
FORWARD_TOL and OP_TOL (tests/torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import initializers as flax_init

from infodiffusion_tpu.config import Config as JConfig
from infodiffusion_tpu.models import build_model as j_build_model
from infodiffusion_tpu.models.unet import Decoder as JDecoder
from infodiffusion_tpu.models.unet import _UNetSkeleton as JSkeleton
from infodiffusion_tpu.models.wrappers import VAE as JVAE
from infodiffusion_tpu.models.wrappers import Diff as JDiff
from infodiffusion_tpu.models.wrappers import InfoDiff as JInfoDiff
from infodiffusion_tpu.nn import initializers as jinit
from infodiffusion_tpu.nn.blocks import ResBlock as JResBlock
from infodiffusion_tpu.ops.attention import single_head_attention
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.unet import Decoder, _UNetSkeleton
from infodiffusion_tpu_torch.models.wrappers import (
    VAE,
    Diff,
    InfoDiff,
    build_model,
)
from infodiffusion_tpu_torch.nn import initializers as pinit
from infodiffusion_tpu_torch.nn.blocks import ResBlock
from infodiffusion_tpu_torch.ops.cuda.attention import (
    CHANNELS,
    attention_reference,
)
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

SIZE, A_DIM = 16, 32
# two levels, attention at level 1, one block per level: every block kind,
# a skip concat, a channel change and an attention site
SMALL = dict(ch_mult=(1, 2), attn=(1,), num_res_blocks=1)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return tensor(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("in_ch,attn", [(32, False), (64, True)])
def test_res_block(in_ch, attn):
    rng = np.random.RandomState(in_ch)
    x = rng.randn(2, 8, 8, in_ch).astype(np.float32)
    temb = rng.randn(2, 16).astype(np.float32)
    jm = JResBlock(out_ch=64, attn=attn)
    params = randomize(init_variables(jm, x, temb)["params"], seed=1)
    want = jm.apply({"params": params}, x, temb)
    pm = port(ResBlock(in_ch, 64, 16, attn), params)
    assert_close(_nhwc(pm(_nchw(x), tensor(temb))), want, FORWARD_TOL,
                 "ResBlock")


@pytest.mark.parametrize("aux_mode", ["none", "all", "bottleneck", "encoder"])
def test_unet_skeleton(aux_mode):
    rng = np.random.RandomState(2)
    out_ch = 1 if aux_mode == "encoder" else 3
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    temb, aemb = (rng.randn(2, 16).astype(np.float32) for _ in range(2))
    jm = JSkeleton(32, SMALL["ch_mult"], out_ch, aux_mode, SMALL["attn"],
                   SMALL["num_res_blocks"])
    params = randomize(init_variables(jm, x, temb, aemb)["params"], seed=3)
    want = jm.apply({"params": params}, x, temb, aemb)
    pm = port(_UNetSkeleton(32, SMALL["ch_mult"], out_ch, 16, SMALL["attn"],
                            SMALL["num_res_blocks"], aux_mode=aux_mode,
                            in_ch=3), params)
    got = _nhwc(pm(_nchw(x), tensor(temb), tensor(aemb)))
    assert_close(got, want, FORWARD_TOL, f"skeleton {aux_mode}")


def test_bottleneck_infodiff_forward():
    kw = dict(T=20, a_dim=A_DIM, shape=(3, SIZE, SIZE), unets_channels=32,
              is_bottleneck=True, **SMALL)
    jm = JInfoDiff(encoder_channels=32, **kw)
    rng = np.random.RandomState(4)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    t = np.array([3, 17], np.int32)
    a = rng.randn(2, A_DIM).astype(np.float32)
    params = randomize(init_variables(jm, x, t, a)["params"], seed=5)
    want = jax.jit(jm.apply)({"params": params}, x, t, a)
    pm = InfoDiff(**kw).eval()
    port(pm.backbone, params["backbone"])
    assert type(pm.backbone).__name__ == "BottleneckAuxUNet"
    assert_close(pm(tensor(x), tensor(t).long(), tensor(a)), want,
                 FORWARD_TOL, "BottleneckAuxUNet")


@pytest.fixture(scope="module")
def vanilla():
    kw = dict(T=20, shape=(3, SIZE, SIZE), unets_channels=32, **SMALL)
    jm = JDiff(**kw)
    params = randomize(init_variables(
        jm, np.zeros((1, SIZE, SIZE, 3), np.float32),
        np.zeros(1, np.int32))["params"], seed=6)
    return jm, params, port(Diff(**kw), params)


def test_diff_forward_and_loss(vanilla):
    jm, params, pm = vanilla
    rng = np.random.RandomState(7)
    x = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    t = np.array([0, 19], np.int32)
    eps = rng.randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = jm.apply({"params": params}, x, t)
    assert_close(pm(tensor(x), tensor(t).long()), want, FORWARD_TOL, "Diff")
    j_loss, j_aux = jm.apply({"params": params}, x, method=JDiff.loss_fn,
                             deterministic=True, t=jnp.asarray(t),
                             eps=jnp.asarray(eps))
    loss, aux = pm.loss_fn(tensor(x), deterministic=True,
                           t=tensor(t).long(), eps=tensor(eps))
    assert_close(loss, np.asarray(j_loss), OP_TOL, "Diff loss")
    assert sorted(aux) == sorted(j_aux) == ["denoise"]


def test_decoder():
    rng = np.random.RandomState(8)
    a = rng.randn(2, A_DIM).astype(np.float32)
    jm = JDecoder(a_dim=A_DIM, shape=(3, SIZE, SIZE), ch=32, **SMALL)
    params = randomize(init_variables(jm, a)["params"], seed=9)
    want = jm.apply({"params": params}, a)
    pm = port(Decoder(A_DIM, (3, SIZE, SIZE), ch=32, **SMALL), params)
    assert_close(pm(tensor(a)), want, FORWARD_TOL, "Decoder")


@pytest.mark.parametrize("mmd,kld,use_C", [(0.1, 0.0, False),
                                           (0.0, 1e-3, True)])
def test_vae(mmd, kld, use_C):
    kw = dict(a_dim=A_DIM, shape=(3, SIZE, SIZE), encoder_channels=32,
              mmd_weight=mmd, kld_weight=kld, use_C=use_C, epochs=10, **SMALL)
    jm = JVAE(**kw)
    rng = np.random.RandomState(10)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    reparam = rng.randn(2, A_DIM).astype(np.float32)
    prior = rng.randn(2, A_DIM).astype(np.float32)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
        reparam_eps=jnp.asarray(reparam)))()
    params = randomize(variables["params"], seed=11)
    pm = port(VAE(**kw), params)
    apply = lambda **k: jm.apply({"params": params}, jnp.asarray(x), **k)
    want = apply(reparam_eps=jnp.asarray(reparam))
    got = pm(tensor(x), reparam_eps=tensor(reparam))
    for name, g, w in zip(("rec", "a_q", "mu", "log_var"), got, want):
        assert_close(g, w, FORWARD_TOL, f"VAE {name}")
    assert_close(pm.decode(tensor(reparam)),
                 jm.apply({"params": params}, jnp.asarray(reparam),
                          method=JVAE.decode), FORWARD_TOL, "VAE.decode")
    j_loss, j_aux = apply(method=JVAE.loss_fn, curr_epoch=3,
                          deterministic=True,
                          reparam_eps=jnp.asarray(reparam),
                          prior_samples=jnp.asarray(prior))
    loss, aux = pm.loss_fn(tensor(x), 3, deterministic=True,
                           reparam_eps=tensor(reparam),
                           prior_samples=tensor(prior))
    assert sorted(aux) == sorted(j_aux)
    assert_close(loss, np.asarray(j_loss), OP_TOL, "VAE loss")
    for k in aux:
        assert_close(aux[k], np.asarray(j_aux[k]), OP_TOL, f"VAE {k}")


@pytest.mark.parametrize("model,latent,bottleneck", [
    ("vanilla", False, False), ("diff", False, False), ("diff", False, True),
    ("vae", False, False), ("diff", True, False)])
def test_build_model(model, latent, bottleneck):
    """The port's build_model picks the JAX one's class and architecture:
    the JAX param tree (its shapes, from an abstract init) loads strictly.
    The forwards of these classes are held against JAX above."""
    kw = dict(model=model, a_dim=A_DIM, input_channels=3, input_size=SIZE,
              unets_channels=32, encoder_channels=32, diffusion_steps=20,
              is_bottleneck=bottleneck, ch_mult="1,2", attn="1")
    jm = j_build_model(JConfig(**kw), latent=latent)
    pm = build_model(Config(**kw), latent=latent, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    x = jnp.zeros((1, A_DIM) if latent else (1, SIZE, SIZE, 3))
    t = jnp.zeros((1,), jnp.int32)
    init = {"vae": lambda r: jm.init(r, x, reparam_eps=jnp.zeros((1, A_DIM))),
            "diff": lambda r: jm.init(r, x, 0, method=type(jm).loss_fn,
                                      reparam_eps=jnp.zeros((1, A_DIM)),
                                      prior_samples=jnp.zeros((1, A_DIM)))
            }.get(model if not latent else "", lambda r: jm.init(r, x, t))
    tree = jax.eval_shape(lambda: init(
        {k: jax.random.PRNGKey(0)
         for k in ("params", "noise", "reparam", "dropout")}))["params"]
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   tree)
    port(pm, zeros)


def test_build_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        build_model(Config(model="vanilla", input_size=SIZE))
    m = build_model(Config(model="vanilla", input_size=SIZE, ch_mult="1,2",
                           attn="1", bf16=True), device="cpu")
    assert next(m.parameters()).device.type == "cpu"
    assert m.backbone.unet.head.dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["kaiming_normal_relu", "lecun_normal"])
def test_initializers_in_distribution(name):
    """Same std and truncation as the JAX initializers on a [256, 512]
    kernel (fan_in 256), to 3% (2.6e5 draws). The torch draws come from a
    fixed seed in a forked generator, so they do not depend on which tests
    ran before in the process."""
    fan_in, fan_out = 256, 512
    init = (jinit.kaiming_normal_relu() if name == "kaiming_normal_relu"
            else flax_init.lecun_normal())
    want = np.asarray(init(jax.random.PRNGKey(0), (fan_in, fan_out)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        got = getattr(pinit, name + "_")(torch.empty(fan_out, fan_in)).numpy()
    assert abs(got.std() / want.std() - 1) < 0.03
    assert abs(np.abs(got).max() / np.abs(want).max() - 1) < 0.25


@pytest.mark.parametrize("c,n", [(256, 16), (512, 8)])
def test_attention_reference_wide(c, n):
    """K2's plain version at the vanilla UNet's widths, against the JAX
    attention (its XLA form on the CPU); the kernel is compiled for them."""
    assert c in CHANNELS
    rng = np.random.RandomState(c)
    q, k, v = (rng.randn(2, n, c).astype(np.float32) for _ in range(3))
    want = single_head_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = attention_reference(tensor(q), tensor(k), tensor(v))
    assert_close(got, want, OP_TOL, f"attention C={c}")
