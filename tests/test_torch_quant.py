"""The port's int8 turbo tier held against the JAX package: the quantizers,
the plain int8 conv, calibration (with JAX's own draws), the tiny
AuxiliaryUNet's int8 forward on both routes with JAX's quant collection
carried across, a DDIM-3 trajectory, the latent leg's int8 weight stream,
and the tier's routing.

Tolerances, each with its reason:
- int8 arrays equal, scales within 1e-7 relative: the same f32 divide,
  round-half-even and clip on the same inputs;
- int8 conv int32 equal: the conv is exact in both;
- calibrated absmax within 1e-5 relative: a max over one f32 forward,
  which differs from JAX's by summation order only;
- int8 forward vs JAX's 5e-3 relative L2: the same tier, where an f32
  rounding difference that lands on a .5 boundary flips one int8 unit;
- int8 vs the f32 forward 0.15 relative L2: the JAX package's own bar for
  W8A8 noise on random weights (tests/test_quant.py);
- DDIM-3 1e-2: those flips, compounded over three steps;
- the int8-W latent trajectory TRAJECTORY_TOL (tests/torch_parity.py).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion.samplers import (
    strided_ddim_loop as j_strided,
)
from infodiffusion_tpu.diffusion.schedule import make_schedule as j_schedule
from infodiffusion_tpu.models import AuxiliaryUNet as JAuxiliaryUNet
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.ops import quant as jq
from infodiffusion_tpu.ops.pallas.latent_mlp import (
    pack_latent_unet_params as j_pack,
)
from infodiffusion_tpu.ops.pallas.latent_traj import (
    latent_trajectory_pallas,
)
from infodiffusion_tpu.ops.pallas.latent_traj import (
    quantize_packed_weights as j_quantize_packed,
)
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    LatentDiffusionProcess,
    _resolve_turbo,
    strided_ddim_loop,
)
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.interop import from_jax_quant
from infodiffusion_tpu_torch.models.unet import AuxiliaryUNet
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.nn.blocks import AuxResBlock
from infodiffusion_tpu_torch.ops import quant as pq
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.latent_traj import (
    latent_trajectory,
    quantize_packed_weights,
)
from torch_parity import (
    TRAJECTORY_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

SCALE_TOL = 1e-7
ABSMAX_TOL = 1e-5
INT8_FORWARD_TOL = 5e-3
INT8_VS_F32_TOL = 0.15
INT8_TRAJECTORY_TOL = 1e-2

T, A_DIM, SIZE, CALIB_BATCH = 10, 4, 16, 8


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def assert_scales(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.abs(want))
    assert err <= SCALE_TOL, f"{what}: scales off by {err:.3g}"


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("shape,dims", [((3, 3, 16, 32), (0, 1, 2)),
                                        ((24, 40), (0,))])
def test_quantize_weight_matches_jax(shape, dims):
    k = (np.random.RandomState(0).randn(*shape) * 0.3).astype(np.float32)
    jk, js = jq.quantize_weight(jnp.asarray(k), dims)
    pk, ps = pq.quantize_weight(tensor(k), dims)
    assert pk.dtype == torch.int8 and ps.shape == js.shape
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    assert_scales(ps, js, "weight scale")


def test_quantize_act_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 8, 8, 16) * 2).astype(np.float32)
    absmax = np.float32(3.1)  # below max|x|: values saturate too
    jx, js = jq.quantize_act(jnp.asarray(x), jnp.asarray(absmax))
    px, ps = pq.quantize_act(tensor(x), torch.tensor(absmax))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    assert_scales(ps, js, "act scale")


def test_quantize_pieces_folded_matches_jax():
    rng = np.random.RandomState(2)
    pieces = [rng.randn(2, 8, 8, 16).astype(np.float32),
              (3 * rng.randn(2, 8, 8, 8)).astype(np.float32)]
    absmax = np.array([2.5, 7.0], np.float32)
    k = (rng.randn(3, 3, 24, 32) * 0.2).astype(np.float32)
    jx, jk, js = jq.quantize_pieces_folded(
        [jnp.asarray(p) for p in pieces], jnp.asarray(absmax), jnp.asarray(k))
    px, pk, ps = pq.quantize_pieces_folded(
        [tensor(p) for p in pieces], tensor(absmax), tensor(k))
    for a, b in zip(px, jx):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    assert_scales(ps, js, "folded weight scale")


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_int8_conv_matches_jax(stride):
    rng = np.random.RandomState(3 + stride)
    xq = rng.randint(-127, 128, size=(2, 9, 10, 24)).astype(np.int8)
    kq = rng.randint(-127, 128, size=(3, 3, 24, 16)).astype(np.int8)
    want = jq.int8_conv(jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
                        ((1, 1), (1, 1)))
    got = pq.int8_conv(tensor(xq), tensor(kq), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- the tiny UNet, calibrated


def _jax_draws():
    """calibrate's own draws (infodiffusion_tpu/ops/quant.py calibrate)."""
    kx, ka = jr.split(jr.PRNGKey(0))
    x = jr.normal(kx, (CALIB_BATCH, SIZE, SIZE, 1), jnp.float32)
    a = jr.normal(ka, (CALIB_BATCH, A_DIM), jnp.float32)
    return np.asarray(x), np.asarray(a)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tests' tiny AuxiliaryUNet with random params, calibrated by
    JAX, and its port (no quant state)."""
    jm = JAuxiliaryUNet(T=T, a_dim=A_DIM, ch=32, ch_mult=(1, 2), attn=(1,),
                        out_ch=1)
    rng = np.random.RandomState(11)
    x = rng.randn(2, SIZE, SIZE, 1).astype(np.float32)
    t = np.array([3, 7], np.int32)
    a = rng.randn(2, A_DIM).astype(np.float32)
    params = randomize(init_variables(jm, x, t, a)["params"], seed=12)
    jv = jq.calibrate(jm, {"params": params}, (SIZE, SIZE, 1), a_dim=A_DIM,
                      T=T, batch=CALIB_BATCH)

    def make():
        return port(AuxiliaryUNet(T=T, a_dim=A_DIM, ch=32, ch_mult=(1, 2),
                                  attn=(1,), out_ch=1), params)

    return jm, params, jv, make, (x, t, a)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def test_calibration_matches_jax(tiny):
    jm, params, jv, make, _ = tiny
    pm = make()
    assert pq.quant_state(pm) == {}  # none after construction
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    x, a = _jax_draws()
    pq.calibrate(pm, (SIZE, SIZE, 1), a_dim=A_DIM, T=T, x=tensor(x),
                 a=tensor(a))
    got = {k: v.numpy() for k, v in pq.quant_state(pm).items()}
    want = _flat(jv["quant"])
    assert sorted(got) == sorted(want)  # same sites, same markers
    assert not any(w in k for k in got for w in ("head", "tail", "shortcut"))
    for name, value in want.items():
        if name.endswith("act_absmax"):
            assert got[name].shape == value.shape, name
            err = np.max(np.abs(got[name] - value) / value)
            assert err <= ABSMAX_TOL, f"{name}: {err:.3g}"
    after = pm.state_dict()
    assert sorted(after) == sorted(before)  # quant state is not a param
    for k in before:
        assert torch.equal(after[k], before[k]), k


def test_calibrated_linspace_timesteps_truncate():
    """t = linspace(0, T-1, batch) cast to int truncates, as astype does."""
    seen = []

    class Probe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def forward(self, x, t):
            seen.append(t.clone())
            return x

    pq.calibrate(Probe(), (1,), T=1000, batch=7)
    want = np.asarray(jnp.linspace(0.0, 999, 7).astype(jnp.int32))
    np.testing.assert_array_equal(seen[0].numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_int8_forward_matches_jax(tiny, fused, monkeypatch):
    """Both routes with JAX's quant collection carried across: the default
    (int8 conv) and the forced fused one (K7's plain version)."""
    jm, params, jv, make, (x, t, a) = tiny
    if fused:
        monkeypatch.setenv("INFODIFF_FORCE_FUSED_QCONV", "1")
    want = jm.apply(jv, x, t, a)
    pm = from_jax_quant(jv["quant"], make())
    with torch.no_grad():
        got = pm(tensor(x), tensor(t).long(), tensor(a))
    err = rel_l2(got, want)
    assert err <= INT8_FORWARD_TOL, f"int8 forward: {err:.3g}"
    f32 = jm.apply({"params": params}, x, t, a)
    assert rel_l2(got, f32) < INT8_VS_F32_TOL


def test_model_dtype_path_unchanged_by_quant_plumbing(tiny):
    """With no quant state the model runs the plain path: the int8 tier's
    buffers are absent from state_dict, and an up block fed the pieces
    (h, skip) gives bitwise what it gives for their concat, in bf16."""
    _, _, _, make, (x, t, a) = tiny
    pm = make()
    assert not any("absmax" in k or "fused" in k for k in pm.state_dict())
    rng = np.random.RandomState(13)
    block = AuxResBlock(96, 64, 16, dtype=torch.bfloat16,
                        skip_concat=True).eval()
    h = tensor(rng.randn(2, 64, 8, 8).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    skip = tensor(rng.randn(2, 32, 8, 8).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    temb, aemb = (tensor(rng.randn(2, 16).astype(np.float32))
                  for _ in range(2))
    with torch.no_grad():
        got = block((h, skip), temb, aemb)
        want = block(torch.cat([h, skip], dim=1), temb, aemb)
    assert torch.equal(got, want)


def test_strided_ddim_int8_matches_jax(tiny):
    jm, _, jv, make, _ = tiny
    rng = np.random.RandomState(14)
    xT = rng.randn(2, SIZE, SIZE, 1).astype(np.float32)
    a = rng.randn(2, A_DIM).astype(np.float32)
    want = jax.jit(lambda x, a: j_strided(
        lambda x, t, a: jm.apply(jv, x, t, a), j_schedule(1e-5, 1e-2, T), x,
        jr.PRNGKey(0), a, num_steps=3))(jnp.asarray(xT), jnp.asarray(a))
    pm = make()
    x, ja = _jax_draws()
    pq.calibrate(pm, (SIZE, SIZE, 1), a_dim=A_DIM, T=T, x=tensor(x),
                 a=tensor(ja))
    with torch.no_grad():
        got = strided_ddim_loop(pm, make_schedule(1e-5, 1e-2, T),
                                tensor(xT), None, tensor(a), num_steps=3)
    err = rel_l2(got, want)
    assert err <= INT8_TRAJECTORY_TOL, f"DDIM-3 int8: {err:.3g}"


def test_diffusion_process_turbo_calibrates_and_installs(tiny):
    """turbo='int8' calibrates at construction; each process installs its
    state only while it samples, so the model is left without it."""
    from infodiffusion_tpu_torch.models.wrappers import InfoDiff

    cfg = Config(a_dim=A_DIM, diffusion_steps=T, input_size=SIZE,
                 deterministic=True)
    model = InfoDiff(T=T, a_dim=A_DIM, shape=(1, SIZE, SIZE),
                     unets_channels=32, encoder_channels=32, ch_mult=(1, 2),
                     attn=(1,)).eval()
    turbo = DiffusionProcess(cfg, model, turbo="int8")
    assert turbo.turbo == "int8" and turbo.quant
    assert all(k.startswith("backbone.") for k in turbo.quant)
    assert pq.quant_state(model) == {}
    off = DiffusionProcess(cfg, model, turbo="off")
    xT = torch.randn(1, SIZE, SIZE, 1)
    a = torch.randn(1, A_DIM)
    y_off = off.sampling(xT=xT, a=a, num_steps=2)
    seen = []
    hook = model.backbone.unet.downblock_0.conv1.register_forward_pre_hook(
        lambda mod, args: seen.append(mod.act_absmax is not None))
    y_int8 = turbo.sampling(xT=xT, a=a, num_steps=2)
    hook.remove()
    assert seen == [True, True]  # installed while sampling
    assert pq.quant_state(model) == {}  # and removed after
    assert not torch.equal(y_off, y_int8)


# ------------------------------------------------------ the latent leg


@pytest.fixture(scope="module")
def latent():
    D, TL, B = 32, 24, 8
    jm = JDiff(T=TL, shape=(1, D, D), is_latent=True)
    params = randomize(init_variables(
        jm, np.zeros((B, D), np.float32), np.zeros((B,), np.int32)
    )["params"], seed=15)
    pm = port(Diff(T=TL, shape=(1, D, D), is_latent=True), params)
    return D, TL, B, params, pm


def test_quantize_packed_weights_matches_jax(latent):
    D, _, _, params, pm = latent
    want = j_quantize_packed(j_pack(params["backbone"], D))
    got = quantize_packed_weights(pack_latent_unet_params(pm.backbone, D))
    assert got["W"].dtype == torch.int8
    np.testing.assert_array_equal(got["W"].numpy(), np.asarray(want["W"]))
    assert_scales(got["Wsc"], want["Wsc"], "Wsc")


def test_int8_weight_trajectory_matches_pallas(latent):
    D, TL, B, params, pm = latent
    rng = np.random.RandomState(16)
    x = rng.randn(B, D).astype(np.float32)
    noises = rng.randn(TL, B, D).astype(np.float32)
    want = latent_trajectory_pallas(
        j_quantize_packed(j_pack(params["backbone"], D)),
        j_schedule(1e-5, 1e-2, TL), jnp.asarray(x), None, deterministic=True,
        noises=jnp.asarray(noises), interpret=True, block_b=8,
    )
    got = latent_trajectory(
        quantize_packed_weights(pack_latent_unet_params(pm.backbone, D)),
        make_schedule(1e-5, 1e-2, TL), tensor(x), deterministic=True,
        noises=tensor(noises))
    assert_close(got, want, TRAJECTORY_TOL, "int8-W latent trajectory")
    cfg = Config(a_dim=D, diffusion_steps=TL, deterministic=True)
    proc = LatentDiffusionProcess(cfg, pm, turbo="int8")
    assert proc.params["W"].dtype == torch.int8
    assert torch.equal(proc.sampling(xT=tensor(x), noises=tensor(noises)),
                       got)


# ---------------------------------------------------------------- routing


def test_resolve_turbo_order(monkeypatch):
    monkeypatch.delenv("INFODIFF_TURBO", raising=False)
    cfg = Config()
    assert _resolve_turbo(cfg, None) == ""
    monkeypatch.setenv("INFODIFF_TURBO", "int8")
    assert _resolve_turbo(cfg, None) == "int8"      # env
    assert _resolve_turbo(Config(turbo="off"), None) == ""  # cfg 'off' wins
    assert _resolve_turbo(cfg, "off") == ""         # argument 'off' wins
    monkeypatch.setenv("INFODIFF_TURBO", "off")
    assert _resolve_turbo(Config(turbo="int8"), None) == "int8"  # cfg > env
    assert _resolve_turbo(cfg, "int8") == "int8"    # argument > all


@pytest.mark.parametrize("mode", ["fp4", "int4"])
def test_unported_turbo_modes_raise(mode):
    with pytest.raises(ValueError, match="unknown"):
        _resolve_turbo(Config(), mode)
    with pytest.raises(ValueError, match="turbo"):
        Config(turbo=mode)


def test_from_jax_quant_is_strict(tiny):
    _, _, jv, make, _ = tiny
    tree = jax.tree.map(np.asarray, jv["quant"])
    pm = from_jax_quant(tree, make())
    assert sorted(pq.quant_state(pm)) == sorted(_flat(tree))
    missing = jax.tree.map(lambda v: v, tree)
    del missing["unet"]["downblock_0"]["conv1"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_quant(missing, make())
    extra = jax.tree.map(lambda v: v, tree)
    extra["unet"]["head"] = {"act_absmax": np.ones((), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_quant(extra, make())
    shaped = jax.tree.map(lambda v: v, tree)
    shaped["unet"]["downblock_0"]["conv1"]["act_absmax"] = np.ones(
        (2,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_quant(shaped, make())


def test_calibrate_encoder_matches_jax():
    """Encoder-only calibration (one deterministic encode in observe mode)
    on the same data batch: the same sites and markers, absmax within
    ABSMAX_TOL."""
    from infodiffusion_tpu.models import InfoDiff as JInfoDiff
    from infodiffusion_tpu_torch.models.wrappers import InfoDiff

    kw = dict(T=50, a_dim=8, shape=(3, SIZE, SIZE), unets_channels=32,
              encoder_channels=32, ch_mult=(1, 2), attn=(1,),
              num_res_blocks=1)
    jm = JInfoDiff(**kw)
    x = np.random.RandomState(17).randn(4, SIZE, SIZE, 3).astype(np.float32)
    params = randomize(init_variables(jm, x, method=JInfoDiff.encode)
                       ["params"], seed=18)
    want = _flat(jq.calibrate_encoder(jm, {"params": params},
                                      x=jnp.asarray(x)))
    pm = InfoDiff(**kw).eval()
    port(pm.encoder, params["encoder"])
    pq.calibrate_encoder(pm, x=tensor(x))
    got = {k: v.numpy() for k, v in pq.quant_state(pm).items()}
    assert sorted(got) == sorted(want) and want
    for name, value in want.items():
        err = np.max(np.abs(got[name] - value) / value)
        assert err <= ABSMAX_TOL, f"{name}: {err:.3g}"
