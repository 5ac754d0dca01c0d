"""K7, the fused quantize-conv, and the int8 conv kernels' plain versions
and routing, held against the JAX package (ops/pallas/qconv.py,
ops/norm.py group_norm_affine, nn/blocks.py): the folded and packed
weights, the affine rows, the plain K7 against JAX's oracle and against
the Pallas kernel (both bodies) in interpret mode, the W8A8 convs, the
shape gate, the env gates and the kernel wrappers' refusal of CPU tensors.

Tolerances: packed int8 equal and scales within 1e-7 relative (the same f32
arithmetic); the affine rows 2e-5 (the JAX test's own bar); K7's plain
version 1e-6 relative L2 against JAX (the same f32 chain and an exact s32
conv: float rounding only, the JAX test's bar); the W8A8 convs 1e-6 (one
f32 dequant on the same exact sums).
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu.nn.blocks import Conv3 as JConv3
from infodiffusion_tpu.nn.blocks import _PieceConv3 as JPieceConv3
from infodiffusion_tpu.ops.norm import group_norm_affine as j_affine
from infodiffusion_tpu.ops.pallas import qconv as jqc
from infodiffusion_tpu_torch.interop import from_jax_params
from infodiffusion_tpu_torch.nn.blocks import (
    Conv3,
    PieceConv3,
    _AffineChain,
    _GNParams,
)
from infodiffusion_tpu_torch.ops import quant as pq
from infodiffusion_tpu_torch.ops.cuda import latent_traj as ptraj
from infodiffusion_tpu_torch.ops.cuda import qconv as pqc
from infodiffusion_tpu_torch.ops.norm import group_norm_affine
from torch_parity import tensor

torch.set_num_threads(2)

QCONV_TOL = 1e-6
AFFINE_TOL = 2e-5


def rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _case(shapes, cout, seed=0):
    """tests/test_qconv.py's operands, drawn with numpy."""
    rng = np.random.RandomState(seed)
    ps = [(0.5 * rng.randn(*s)).astype(np.float32) for s in shapes]
    ctot = sum(s[-1] for s in shapes)
    B = shapes[0][0]
    A = (1.0 + 0.1 * rng.randn(B, ctot)).astype(np.float32)
    Brow = (0.1 * rng.randn(B, ctot)).astype(np.float32)
    absmax = np.array([np.abs(p).max() * 1.2 for p in ps], np.float32)
    k = (0.2 * rng.randn(3, 3, ctot, cout)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return ps, A, Brow, absmax, k, b


SHAPES = [
    ([(8, 16, 16, 32)], 64),
    ([(8, 8, 8, 64), (8, 8, 8, 32)], 64),
    ([(16, 32, 32, 64)], 64),
    ([(32, 16, 16, 64), (32, 16, 16, 64)], 128),
]


def test_fold_pack_matches_jax():
    ps, _, _, absmax, k, _ = _case([(2, 8, 8, 64), (2, 8, 8, 32)], 64)
    s = np.maximum(absmax, 1e-30) / 127.0
    jk, jsw = jqc._fold_pack(jnp.asarray(k), jnp.asarray(s), [64, 32])
    pk, psw = pqc._fold_pack(tensor(k), tensor(s), [64, 32])
    assert pk.dtype == torch.int8 and pk.shape == (3 * 96, 3 * 64)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    err = np.max(np.abs(psw.numpy() - np.asarray(jsw)) / np.asarray(jsw))
    assert err <= 1e-7


@pytest.mark.parametrize("pieces", [1, 2])
@pytest.mark.parametrize("n_films", [0, 1, 2])
def test_group_norm_affine_matches_jax(pieces, n_films):
    rng = np.random.RandomState(pieces * 10 + n_films)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    xs = ([x] if pieces == 1 else
          [x[..., :32], (2.0 * rng.randn(2, 8, 8, 32)).astype(np.float32)])
    scale = (1.0 + 0.1 * rng.randn(64)).astype(np.float32)
    bias = (0.1 * rng.randn(64)).astype(np.float32)
    films = [tuple((0.1 * rng.randn(2, 64)).astype(np.float32)
                   for _ in range(2)) for _ in range(n_films)]
    jx = xs[0] if pieces == 1 else [jnp.asarray(p) for p in xs]
    jA, jB = j_affine(jx, 32, jnp.asarray(scale), jnp.asarray(bias),
                      [tuple(map(jnp.asarray, f)) for f in films])
    px = tensor(xs[0]) if pieces == 1 else [tensor(p) for p in xs]
    pA, pB = group_norm_affine(px, 32, tensor(scale), tensor(bias),
                               [tuple(map(tensor, f)) for f in films])
    for got, want in ((pA, jA), (pB, jB)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=AFFINE_TOL, rtol=AFFINE_TOL)


@pytest.mark.parametrize("shapes,cout", SHAPES)
def test_qconv_reference_matches_jax(shapes, cout):
    ps, A, Brow, absmax, k, b = _case(shapes, cout)
    want = jqc.qconv_reference([jnp.asarray(p) for p in ps], jnp.asarray(A),
                               jnp.asarray(Brow), jnp.asarray(absmax),
                               jnp.asarray(k), jnp.asarray(b), jnp.float32)
    got = pqc.qconv_reference([tensor(p) for p in ps], tensor(A),
                              tensor(Brow), tensor(absmax), tensor(k),
                              tensor(b), torch.float32)
    assert rel_l2(got, want) <= QCONV_TOL


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("shapes,cout", [SHAPES[0], SHAPES[1]])
def test_qconv_fused_matches_pallas_interpret(shapes, cout, v2, monkeypatch):
    """The port's K7 entry (its plain version on the CPU) against the Pallas
    kernel in interpret mode, body v1 and v2."""
    if v2:
        monkeypatch.setenv("INFODIFF_QCONV_V2", "1")
    else:
        monkeypatch.delenv("INFODIFF_QCONV_V2", raising=False)
    ps, A, Brow, absmax, k, b = _case(shapes, cout, seed=1)
    want = jqc.qconv_fused([jnp.asarray(p) for p in ps], jnp.asarray(A),
                           jnp.asarray(Brow), jnp.asarray(absmax),
                           jnp.asarray(k), jnp.asarray(b), jnp.float32,
                           interpret=True)
    got = pqc.qconv_fused([tensor(p) for p in ps], tensor(A), tensor(Brow),
                          tensor(absmax), tensor(k), tensor(b), torch.float32)
    assert rel_l2(got, want) <= QCONV_TOL


def _calibrated(jm, *args):
    v = jm.init(jr.PRNGKey(0), *args)
    _, q = jm.apply(v, *args, mutable=["quant"])
    return v, {**v, **q}


@pytest.mark.parametrize("stride,repeat", [(1, 1), (2, 1), (1, 2)])
def test_conv3_int8_matches_jax(stride, repeat):
    """Conv3's W8A8 branch (per-forward weight quantization, the act scale,
    the int8 conv, ``f32(y) * (sx * sw) + bias``) at stride 1, stride 2 and
    with the repeat before it, on JAX's calibrated absmax."""
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    jm = JConv3(features=64, strides=stride, repeat=repeat)
    v, vq = _calibrated(jm, jnp.asarray(x))
    want = jm.apply(vq, jnp.asarray(x))
    pm = from_jax_params(v["params"], Conv3(32, 64, stride=stride,
                                            repeat=repeat))
    pm.act_absmax = tensor(np.asarray(vq["quant"]["act_absmax"]))
    got = pm(tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert rel_l2(got, want) <= QCONV_TOL


def test_piece_conv_int8_matches_jax():
    """_PieceConv3's int8 arithmetic: per-piece scales, per-piece s32
    convs, the partial rounded to bf16 between pieces, one dequant."""
    rng = np.random.RandomState(3)
    p1 = rng.randn(2, 8, 8, 32).astype(np.float32)
    p2 = (3.0 * rng.randn(2, 8, 8, 64)).astype(np.float32)
    jm = JPieceConv3(features=64)
    v, vq = _calibrated(jm, [jnp.asarray(p1), jnp.asarray(p2)])
    want = jm.apply(vq, [jnp.asarray(p1), jnp.asarray(p2)])
    pm = from_jax_params(v["params"], PieceConv3(96, 64))
    pm.act_absmax = tensor(np.asarray(vq["quant"]["act_absmax"]))
    x = torch.cat([tensor(p1), tensor(p2)], dim=-1).permute(0, 3, 1, 2)
    got = pm(x, [32, 64]).permute(0, 2, 3, 1)
    assert rel_l2(got, want) <= QCONV_TOL
    # without quant state: the model-dtype conv over the concat
    pm.act_absmax = None
    assert torch.equal(pm(x, [32, 64]), pm(x))


def test_gate_covers_flagship_and_rejects_odd():
    flagship = [
        ([(128, 64, 64, 64)], 64),
        ([(128, 64, 64, 64), (128, 64, 64, 64)], 64),
        ([(128, 64, 64, 128), (128, 64, 64, 64)], 64),
        ([(128, 32, 32, 128)], 128),
        ([(128, 32, 32, 128), (128, 32, 32, 128)], 128),
        ([(128, 16, 16, 128)], 128),
        ([(128, 8, 8, 128), (128, 8, 8, 128)], 128),
        ([(32, 64, 64, 64)], 64),
        ([(8, 300, 300, 64)], 64),  # no W <= 256 limit in the port
    ]
    for shapes, cout in flagship:
        assert pqc.fused_qconv_supported(shapes, cout), (shapes, cout)
    assert not pqc.fused_qconv_supported([(128, 64, 64, 3)], 64)
    assert not pqc.fused_qconv_supported([(128, 64, 64, 64)], 48)
    assert not pqc.fused_qconv_supported([(8, 64)], 64)
    assert not pqc.fused_qconv_supported([(8, 8, 8, 32), (8, 4, 4, 32)], 64)
    assert not pqc.fused_qconv_supported([(8, 2, 2, 64)], 64)
    assert not pqc.fused_qconv_supported([(8, 8, 8, 28), (8, 8, 8, 4)], 64)


def test_env_gates_mirror_jax(monkeypatch):
    for var in ("INFODIFF_FORCE_FUSED_QCONV", "INFODIFF_ENABLE_FUSED_QCONV",
                "INFODIFF_DISABLE_FUSED_QCONV", "INFODIFF_DISABLE_PALLAS",
                "INFODIFF_QCONV_V2"):
        monkeypatch.delenv(var, raising=False)
    cpu = torch.zeros(1)
    assert not pqc.use_fused_qconv(cpu) and not jqc.use_fused_qconv()
    monkeypatch.setenv("INFODIFF_ENABLE_FUSED_QCONV", "1")
    # enabled, but a CPU tensor (JAX: a CPU backend) stays off
    assert not pqc.use_fused_qconv(cpu) and not jqc.use_fused_qconv()
    monkeypatch.delenv("INFODIFF_ENABLE_FUSED_QCONV")
    monkeypatch.setenv("INFODIFF_FORCE_FUSED_QCONV", "1")
    assert pqc.use_fused_qconv(cpu) and jqc.use_fused_qconv()
    monkeypatch.setenv("INFODIFF_DISABLE_FUSED_QCONV", "1")
    assert not pqc.use_fused_qconv(cpu) and not jqc.use_fused_qconv()
    monkeypatch.delenv("INFODIFF_DISABLE_FUSED_QCONV")
    monkeypatch.setenv("INFODIFF_DISABLE_PALLAS", "1")
    assert not pqc.use_fused_qconv(cpu) and not jqc.use_fused_qconv()
    assert not pqc._use_v2()
    monkeypatch.setenv("INFODIFF_QCONV_V2", "1")
    assert pqc._use_v2() and jqc._use_v2()


def test_gnparams_chain_only_when_deterministic(monkeypatch):
    monkeypatch.setenv("INFODIFF_FORCE_FUSED_QCONV", "1")
    m = _GNParams(64, fused_out_ch=64)
    x = torch.randn(2, 64, 8, 8)
    assert isinstance(m(x), torch.Tensor)  # no marker: plain GN
    m.fused_qconv = torch.ones(())
    chain = m(x, deterministic=True)
    assert isinstance(chain, _AffineChain)
    assert chain.A.shape == (2, 64) and chain.B.shape == (2, 64)
    assert isinstance(m(x, deterministic=False), torch.Tensor)
    monkeypatch.setenv("INFODIFF_DISABLE_FUSED_QCONV", "1")
    assert isinstance(m(x, deterministic=True), torch.Tensor)
    assert "fused_qconv" not in m.state_dict()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    monkeypatch.setenv("INFODIFF_QCONV_V2", "1")
    before = (pqc.qconv_cuda.launches, pqc.qconv_v2_cuda.launches,
              pqc.int8_conv_cuda.launches)
    ps, A, Brow, absmax, k, b = _case([(2, 8, 8, 32)], 32)
    args = ([tensor(p) for p in ps], tensor(A), tensor(Brow), tensor(absmax),
            tensor(k), tensor(b), torch.float32)
    assert torch.equal(pqc.qconv_fused(*args), pqc.qconv_reference(*args))
    xq = torch.randint(-127, 128, (2, 8, 8, 32), dtype=torch.int8)
    kq = torch.randint(-127, 128, (3, 3, 32, 16), dtype=torch.int8)
    assert torch.equal(pq.int8_conv(xq, kq, 2),
                       pq.int8_conv_reference(xq, kq, 2))
    assert before == (pqc.qconv_cuda.launches, pqc.qconv_v2_cuda.launches,
                      pqc.int8_conv_cuda.launches)


def test_int8_kernel_wrappers_refuse_cpu_tensors():
    xq = torch.zeros(2, 8, 8, 32, dtype=torch.int8)
    kq = torch.zeros(3, 3, 32, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        pqc.int8_conv_cuda(xq, kq, 1)
    p = torch.zeros(2, 8, 8, 32)
    ab = torch.zeros(2, 32)
    kmat = torch.zeros(96, 96, dtype=torch.int8)
    for run in (pqc.qconv_cuda, pqc.qconv_v2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            run([p], ab, ab, torch.ones(1), kmat, torch.ones(32),
                torch.zeros(32))
    W = torch.zeros(10, 40, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        ptraj.latent_trajectory_cuda(torch.zeros(2, 8), None, W,
                                     *([None] * 5), torch.ones(10, 32))
