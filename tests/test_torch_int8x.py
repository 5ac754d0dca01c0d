"""The port's int8x turbo tier held against the JAX package: the s8 view of
a block's input, the s8 shortcut, calibration (with JAX's own draws), every
ResBlock and the whole forward of a tiny AuxiliaryUNet and UNet with JAX's
int8x quant collection carried across, a vanilla DDIM step, the processes
and the strictness of ``from_jax_quant``.

Tolerances, each with its reason:
- s8 views equal: the same f32 divide, round-half-even and clip;
- the plain s8 product int32 equal: exact in both;
- calibrated absmax within 1e-4 relative: a max over one f32 forward,
  which differs from JAX's by summation order only;
- ``int8_shortcut`` within 1e-5 relative of JAX's (f32 rounding of the
  dequantized sum), and within 0.02 relative L2 of the f32 projection
  (the JAX package's own bar, tests/test_quant.py);
- each ResBlock, fed the inputs it has in the port's forward, within 5e-3
  relative L2 of JAX's block on the same inputs: the tier's per-forward
  bar, where an f32 rounding difference that lands on a .5 boundary flips
  one int8 unit (one flip moves a block's output by ~1e-3);
- the whole forward and a DDIM-1 step within 5e-3 where no int8 unit
  flipped against JAX's, else within ``torch_parity.CASCADE_TOL`` (one
  flip carries the output of every later layer; see there), which
  ``int8_flipped`` grants only where every quantizer input up to the first
  s8 difference agrees with JAX's and that difference is a rounding flip.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.diffusion import samplers as js
from infodiffusion_tpu.models import AuxiliaryUNet as JAuxiliaryUNet
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.models import UNet as JUNet
from infodiffusion_tpu.nn import blocks as jb
from infodiffusion_tpu.ops import quant as jq
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    LatentDiffusionProcess,
    TwoPhaseDiffusionProcess,
)
from infodiffusion_tpu_torch.interop import from_jax_quant
from infodiffusion_tpu_torch.models.unet import AuxiliaryUNet, UNet
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff
from infodiffusion_tpu_torch.nn.blocks import _ResBlockBase
from infodiffusion_tpu_torch.ops import quant as pq
from torch_parity import (
    CASCADE_TOL,
    init_variables,
    int8_flipped,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)

ABSMAX_TOL = 1e-4
SHORTCUT_TOL = 1e-5
SHORTCUT_VS_F32_TOL = 0.02
INT8_FORWARD_TOL = 5e-3

T, A_DIM, SIZE, CALIB_BATCH = 10, 4, 16, 8
ARCH = dict(ch=32, ch_mult=(1, 2), attn=(1,), out_ch=1)


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if hasattr(value, "items"):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _jax_draws(a_dim=A_DIM, batch=CALIB_BATCH, channels=1):
    """calibrate's own draws (infodiffusion_tpu/ops/quant.py calibrate)."""
    kx, ka = jr.split(jr.PRNGKey(0))
    x = jr.normal(kx, (batch, SIZE, SIZE, channels), jnp.float32)
    a = None if a_dim is None else np.asarray(
        jr.normal(ka, (batch, a_dim), jnp.float32))
    return np.asarray(x), a


def _absmax_close(got, want):
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        g = np.asarray(got[name])
        assert g.shape == value.shape, name
        err = np.max(np.abs(g - value) / value)
        assert err <= ABSMAX_TOL, f"{name}: {err:.3g}"


# ------------------------------------------------------------- the ops


def test_quantize_x_pieces_matches_jax():
    rng = np.random.RandomState(1)
    pieces = [rng.randn(2, 8, 8, 16).astype(np.float32),
              (4 * rng.randn(2, 8, 8, 8)).astype(np.float32)]
    absmax = np.array([2.2, 9.5], np.float32)  # saturates both pieces
    jqs, js_ = jq.quantize_x_pieces([jnp.asarray(p) for p in pieces],
                                    jnp.asarray(absmax))
    pqs, ps = pq.quantize_x_pieces([tensor(p) for p in pieces],
                                   tensor(absmax))
    for got, want in zip(pqs, jqs):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js_))
    # elementwise: an NCHW channels_last piece keeps its layout
    nchw = tensor(pieces[0]).permute(0, 3, 1, 2)
    q, _ = pq.quantize_x_pieces([nchw], tensor(absmax[:1]))
    assert q[0].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(q[0].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jqs[0]))


@pytest.mark.parametrize("k", [24, 4096])
def test_int8_dot_plain_is_exact(k):
    rng = np.random.RandomState(2)
    xq = rng.randint(-127, 128, size=(2, 5, 7, k)).astype(np.int8)
    kq = rng.randint(-127, 128, size=(k, 40)).astype(np.int8)
    want = jq.int8_dot(jnp.asarray(xq), jnp.asarray(kq))
    got = pq.int8_dot(tensor(xq), tensor(kq))
    assert got.dtype == torch.int32 and pq.int8_dot.launches == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_shortcut_matches_jax():
    """Mismatched piece ranges, a residual: JAX's int8_shortcut within
    1e-5, the f32 projection within 0.02 relative L2."""
    rng = np.random.RandomState(3)
    p1 = rng.randn(2, 8, 8, 16).astype(np.float32)
    p2 = (4.0 * rng.randn(2, 8, 8, 8)).astype(np.float32)
    kernel = (0.2 * rng.randn(24, 32)).astype(np.float32)
    bias = (0.1 * rng.randn(32)).astype(np.float32)
    res = rng.randn(2, 8, 8, 32).astype(np.float32)
    absmax = np.array([np.abs(p1).max(), np.abs(p2).max()], np.float32)
    want = jq.int8_shortcut(
        jq.quantize_x_pieces([jnp.asarray(p1), jnp.asarray(p2)],
                             jnp.asarray(absmax)),
        jnp.asarray(kernel), jnp.asarray(bias), jnp.float32,
        residual=jnp.asarray(res))
    got = pq.int8_shortcut(
        pq.quantize_x_pieces([tensor(p1), tensor(p2)], tensor(absmax)),
        tensor(kernel), tensor(bias), torch.float32, residual=tensor(res))
    want = np.asarray(want)
    err = np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want))
    assert err <= SHORTCUT_TOL, f"int8_shortcut vs JAX: {err:.3g}"
    f32 = res + np.concatenate([p1, p2], -1) @ kernel + bias
    assert rel_l2(got, f32) < SHORTCUT_VS_F32_TOL


# ------------------------------------------------ the tiny UNets, int8x


def _build(kind):
    """(JAX model, params, JAX int8x variables, port maker, inputs, calib
    draws) for the tiny AuxiliaryUNet ('aux') or UNet ('vanilla')."""
    aux = kind == "aux"
    jm = (JAuxiliaryUNet(T=T, a_dim=A_DIM, **ARCH) if aux
          else JUNet(T=T, **ARCH))
    rng = np.random.RandomState(21)
    x = rng.randn(2, SIZE, SIZE, 1).astype(np.float32)
    t = np.array([3, 7], np.int32)
    a = rng.randn(2, A_DIM).astype(np.float32)
    args = (x, t, a) if aux else (x, t)
    params = randomize(init_variables(jm, *args)["params"], seed=22)
    a_dim = A_DIM if aux else None
    jv = jq.calibrate(jm, {"params": params}, (SIZE, SIZE, 1), a_dim=a_dim,
                      T=T, batch=CALIB_BATCH, mode="int8x")

    def make():
        return port(AuxiliaryUNet(T=T, a_dim=A_DIM, **ARCH) if aux
                    else UNet(T=T, **ARCH), params)

    return jm, params, jv, make, args, _jax_draws(a_dim)


@pytest.fixture(scope="module", params=["aux", "vanilla"])
def tiny(request):
    return request.param, _build(request.param)


def test_int8x_calibration_matches_jax(tiny):
    """The same sites as JAX's calibrate(mode='int8x'): x_absmax (1,) or
    (2,) under every ResBlock's xq, act_absmax at every quantized conv, no
    fused_qconv marker; each absmax within 1e-4 relative."""
    _, (_, _, jv, make, _, (cx, ca)) = tiny
    pm = make()
    pq.calibrate(pm, (SIZE, SIZE, 1), a_dim=None if ca is None else A_DIM,
                 T=T, x=tensor(cx), a=None if ca is None else tensor(ca),
                 mode="int8x")
    got = {k: v.numpy() for k, v in pq.quant_state(pm).items()}
    want = _flat(jv["quant"])
    _absmax_close(got, want)
    assert not any(k.endswith("fused_qconv") for k in got)
    blocks = [n for n, m in pm.named_modules() if isinstance(m, _ResBlockBase)]
    assert sorted(k for k in got if k.endswith("x_absmax")) == sorted(
        f"{n}.xq.x_absmax" for n in blocks)
    assert {got[f"{n}.xq.x_absmax"].shape for n in blocks} == {(1,), (2,)}
    assert not any("absmax" in k for k in pm.state_dict())


def test_int8x_calibrate_encoder_matches_jax():
    """Encoder-only calibration under int8x on the same data batch: JAX's
    sites (x_absmax under each EncoderResBlock's xq, act_absmax, no
    marker), absmax within 1e-4 relative; the encode then runs on it."""
    kw = dict(T=50, a_dim=8, shape=(3, SIZE, SIZE), unets_channels=32,
              encoder_channels=32, ch_mult=(1, 2), attn=(1,),
              num_res_blocks=1)
    jm = JInfoDiff(**kw)
    x = np.random.RandomState(17).randn(4, SIZE, SIZE, 3).astype(np.float32)
    params = randomize(init_variables(jm, x, method=JInfoDiff.encode)
                       ["params"], seed=18)
    want = _flat(jq.calibrate_encoder(jm, {"params": params},
                                      x=jnp.asarray(x), mode="int8x"))
    pm = InfoDiff(**kw).eval()
    port(pm.encoder, params["encoder"])
    pq.calibrate_encoder(pm, x=tensor(x), mode="int8x")
    got = {k: v.numpy() for k, v in pq.quant_state(pm).items()}
    _absmax_close(got, want)
    assert any(k.endswith("xq.x_absmax") for k in got)
    assert not any(k.endswith("fused_qconv") for k in got)
    with torch.no_grad():
        a = pm.encode(tensor(x), sample=False)[0]
    assert torch.isfinite(a).all()


def _block_inputs(pm, args):
    """Each ResBlock's inputs and output in one port forward."""
    seen, hooks = {}, []
    for name, mod in pm.named_modules():
        if isinstance(mod, _ResBlockBase):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o, n=name: (seen.setdefault(n, (a, o)), None)[1]))
    with torch.no_grad():
        pm(*(tensor(v) if v.dtype != np.int32 else tensor(v).long()
             for v in args))
    for h in hooks:
        h.remove()
    return seen


def _nhwc(t):
    return np.asarray(t.permute(0, 2, 3, 1).contiguous().numpy())


def test_int8x_blocks_match_jax(tiny):
    """Every ResBlock, fed the inputs it has in the port's forward, against
    JAX's block on the same inputs with its slice of JAX's int8x
    collection: the tier's per-forward bar."""
    kind, (_, params, jv, make, args, _) = tiny
    pm = from_jax_quant(jv["quant"], make())
    seen = _block_inputs(pm, args)
    assert len(seen) == sum(isinstance(m, _ResBlockBase)
                            for m in pm.modules())
    for name, (a, out) in seen.items():
        mod = pm.get_submodule(name)
        key = name.split(".")[-1]
        x = a[0]
        jx = (tuple(_nhwc(p) for p in x) if isinstance(x, tuple)
              else _nhwc(x))
        cls = jb.AuxResBlock if kind == "aux" else jb.ResBlock
        jblock = cls(mod.conv1.weight.shape[0], attn=mod.attn is not None,
                     name=None)
        conds = [c.numpy() for c in a[1:3 if kind == "aux" else 2]]
        want = jblock.apply({"params": params["unet"][key],
                             "quant": jv["quant"]["unet"][key]},
                            jx, *conds, True)
        err = rel_l2(_nhwc(out), want)
        assert err <= INT8_FORWARD_TOL, f"{kind} {name}: {err:.3g}"


def test_int8x_forward_matches_jax(tiny):
    """The whole forward with JAX's int8x collection carried across: within
    5e-3 where every s8 value equals JAX's, else, where ``int8_flipped``
    finds the first difference to be a rounding flip, within CASCADE_TOL;
    and within the JAX package's own int8x bar of the f32 forward."""
    kind, (jm, params, jv, make, args, _) = tiny
    want = jm.apply(jv, *args)
    pm = from_jax_quant(jv["quant"], make())
    with torch.no_grad():
        got = pm(*(tensor(v) if v.dtype != np.int32 else tensor(v).long()
                   for v in args))
    err = rel_l2(got, want)
    bar = CASCADE_TOL if int8_flipped(pm, jm, jv, args) else INT8_FORWARD_TOL
    assert err <= bar, f"{kind} int8x forward: {err:.3g} (bar {bar})"
    f32 = jm.apply({"params": params}, *args)
    assert rel_l2(got, f32) < 0.25  # tests/test_quant.py's int8x bar


def test_x_view_feeds_norm1_and_shortcut(monkeypatch):
    """bf16 blocks under int8x: norm1 reads the dequantized view in f32,
    a channel change's shortcut is the s8 product even on the K6 route,
    and an identity block adds its raw input."""
    from infodiffusion_tpu_torch.nn.blocks import AuxResBlock

    monkeypatch.setenv("INFODIFF_FORCE_FUSED_SHORTCUT", "1")
    rng = np.random.RandomState(4)
    x = tensor(rng.randn(2, 64, 8, 8).astype(np.float32)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    temb, aemb = (tensor(rng.randn(2, 16).astype(np.float32))
                  for _ in range(2))
    calls = []
    orig = pq.int8_shortcut
    monkeypatch.setattr(pq, "int8_shortcut",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    for out_ch in (128, 64):
        block = AuxResBlock(64, out_ch, 16, dtype=torch.bfloat16).eval()
        with torch.no_grad(), pq._calibrating("int8x"):
            block(x, temb, aemb)
        assert block.xq.x_absmax.shape == (1,)
        seen = {}
        block.norm1.register_forward_pre_hook(
            lambda m, a: (seen.setdefault("norm1", a[0].dtype), None)[1])
        block.conv3.register_forward_hook(
            lambda m, a, o: (seen.setdefault("h", o), None)[1])
        with torch.no_grad():
            y = block(x, temb, aemb)
        assert seen["norm1"] == torch.float32
        assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
        if out_ch == 64:
            assert torch.equal(y, seen["h"] + x)
    assert calls == [1]


# ------------------------------------------------------------ samplers


@pytest.fixture(scope="module")
def vanilla():
    arch = dict(T=T, shape=(3, SIZE, SIZE), unets_channels=32,
                ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
    x = np.zeros((2, SIZE, SIZE, 3), np.float32)
    jv = JDiff(**arch)
    pv = randomize(init_variables(jv, x, np.zeros(2, np.int32))["params"],
                   seed=31)
    return jv, pv, port(Diff(**arch), pv), arch


def test_vanilla_int8x_ddim_step_matches_jax(vanilla):
    """A DiffusionProcess(turbo='int8x') DDIM step of the vanilla Diff with
    JAX's process's quant collection carried into the port's process."""
    jv, pv, pm, _ = vanilla
    from infodiffusion_tpu.config import Config as JConfig

    jcfg = JConfig(model="vanilla", a_dim=A_DIM, diffusion_steps=T,
                   input_channels=3, input_size=SIZE, turbo="int8x")
    jproc = js.DiffusionProcess(jcfg, jv, {"params": pv},
                                shape=(3, SIZE, SIZE))
    assert jproc.turbo == "int8x"
    cfg = Config(model="vanilla", a_dim=A_DIM, diffusion_steps=T,
                 input_channels=3, input_size=SIZE)
    proc = DiffusionProcess(cfg, pm, turbo="int8x", shape=(3, SIZE, SIZE))
    assert proc.turbo == "int8x" and pq.quant_state(pm) == {}
    j_draws, _ = _jax_draws(None, batch=32, channels=3)
    pq.calibrate(pm, (SIZE, SIZE, 3), T=T, x=tensor(j_draws), mode="int8x")
    got_q = pq.quant_state(pm)
    pq.clear_quant_state(pm)
    _absmax_close({k: v.numpy() for k, v in got_q.items()},
                  _flat(jproc.params["quant"]))
    assert sorted(proc.quant) == sorted(got_q)
    proc.quant = pq.quant_state(from_jax_quant(jproc.params["quant"], pm))
    pq.clear_quant_state(pm)
    xT = np.random.RandomState(41).randn(2, SIZE, SIZE, 3).astype(
        np.float32)
    want = jproc._jit_strided(jproc.params, jnp.asarray(xT), None,
                              jr.PRNGKey(0), num_steps=1)
    seen = []
    hook = pm.register_forward_pre_hook(
        lambda m, a: seen.append(tuple(v.numpy() for v in a)))
    try:
        got = proc.sampling(xT=tensor(xT), num_steps=1)
    finally:
        hook.remove()
    assert pq.quant_state(pm) == {} and len(seen) == 1
    err = rel_l2(got, want)
    x, t = seen[0]
    from_jax_quant(jproc.params["quant"], pm)
    try:
        flipped = int8_flipped(pm, jv, jproc.params, (x, t.astype(np.int32)))
    finally:
        pq.clear_quant_state(pm)
    bar = CASCADE_TOL if flipped else INT8_FORWARD_TOL
    assert err <= bar, f"vanilla int8x DDIM step: {err:.3g} (bar {bar})"


def test_two_phase_installs_both_int8x_states(vanilla):
    """TwoPhaseDiffusionProcess(turbo='int8x') calibrates both models at
    JAX's int8x sites (the InfoDiff with a, the vanilla Diff without) and
    installs each only while its phase runs."""
    _, _, pv_m, arch = vanilla
    x = np.zeros((2, SIZE, SIZE, 3), np.float32)
    ji = JInfoDiff(a_dim=A_DIM, encoder_channels=32, **arch)
    pi = randomize(init_variables(ji, x, 0, method=JInfoDiff.loss_fn)[
        "params"], seed=32)
    pi_m = port(InfoDiff(a_dim=A_DIM, encoder_channels=32, **arch), pi)
    cfg = Config(a_dim=A_DIM, diffusion_steps=T, input_channels=3,
                 input_size=SIZE, split_step=4)
    two = TwoPhaseDiffusionProcess(cfg, pi_m, pv_m, turbo="int8x")
    assert two.turbo == "int8x"
    j_inf = _flat(jq.calibrate(ji, {"params": pi}, (SIZE, SIZE, 3),
                               a_dim=A_DIM, T=T, mode="int8x")["quant"])
    j_van = _flat(jq.calibrate(JDiff(**arch), {"params": randomize(
        init_variables(JDiff(**arch), x, np.zeros(2, np.int32))["params"],
        seed=31)}, (SIZE, SIZE, 3), a_dim=None, T=T, mode="int8x")["quant"])
    assert sorted(two.quant1) == sorted(j_inf)
    assert sorted(two.quant2) == sorted(j_van)
    assert any(k.endswith("x_absmax") for k in two.quant1)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, a, tag=tag: seen.append(
            (tag, pq.quant_state(pi_m) != {}, pq.quant_state(pv_m) != {})))
        for tag, m in (("cond", pi_m), ("uncond", pv_m))]
    rng = np.random.RandomState(42)
    try:
        out = two.sampling(
            xT=tensor(rng.randn(1, SIZE, SIZE, 3).astype(np.float32)),
            a=tensor(rng.randn(1, A_DIM).astype(np.float32)),
            noises=tensor(rng.randn(T, 1, SIZE, SIZE, 3).astype(
                np.float32)))
    finally:
        for h in hooks:
            h.remove()
    assert torch.isfinite(out).all()
    assert all((c, u) == ((True, False) if t == "cond" else (False, True))
               for t, c, u in seen)
    assert pq.quant_state(pv_m) == {} and pq.quant_state(pi_m) == {}


def test_latent_process_takes_int8_for_int8x():
    D = 32
    lat = Diff(T=T, shape=(1, D, D), is_latent=True)
    cfg = Config(a_dim=D, diffusion_steps=T, deterministic=True)
    proc = LatentDiffusionProcess(cfg, lat, turbo="int8x")
    assert proc.turbo == "int8"
    assert proc.params["W"].dtype == torch.int8


@pytest.mark.parametrize("how", ["config", "env", "process"])
def test_int8x_is_accepted_everywhere(vanilla, how, monkeypatch):
    _, _, pm, _ = vanilla
    cfg = dict(model="vanilla", a_dim=A_DIM, diffusion_steps=T,
               input_channels=3, input_size=SIZE)
    if how == "config":
        proc = DiffusionProcess(Config(turbo="int8x", **cfg), pm)
    elif how == "env":
        monkeypatch.setenv("INFODIFF_TURBO", "int8x")
        proc = DiffusionProcess(Config(**cfg), pm)
    else:
        proc = DiffusionProcess(Config(**cfg), pm, turbo="int8x")
    assert proc.turbo == "int8x"
    assert any(k.endswith("xq.x_absmax") for k in proc.quant)
    out = proc.sampling(torch.Generator().manual_seed(0), 1, num_steps=1)
    assert torch.isfinite(out).all() and pq.quant_state(pm) == {}


def test_from_jax_quant_checks_x_absmax():
    """A missing or an extra x_absmax raises, as a wrong shape does."""
    _, _, jv, make, _, _ = _build("aux")
    tree = jax.tree.map(np.asarray, jv["quant"])
    pm = from_jax_quant(tree, make())
    assert sorted(pq.quant_state(pm)) == sorted(_flat(tree))
    missing = jax.tree.map(lambda v: v, tree)
    del missing["unet"]["upblock_6"]["xq"]
    with pytest.raises(ValueError, match="missing.*upblock_6.xq.x_absmax"):
        from_jax_quant(missing, make())
    extra = jax.tree.map(lambda v: v, tree)
    extra["unet"]["down_0"]["xq"] = {"x_absmax": np.ones((1,), np.float32)}
    with pytest.raises(ValueError, match="unexpected.*down_0.xq.x_absmax"):
        from_jax_quant(extra, make())
    shaped = jax.tree.map(lambda v: v, tree)
    shaped["unet"]["upblock_6"]["xq"]["x_absmax"] = np.ones((1,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_quant(shaped, make())
