"""The Hopper bodies of the int8 conv (``csrc/int8_conv_wgmma.cuh``) and of
K6 in bf16 (``csrc/shortcut_fused.cu``) on the CPU: their launch plans
(``int8_conv_launch_plan``, ``shortcut_launch_plan``) fit the card's shared
memory at every site of the models that run them, and a plain-torch walk
over each plan's tiles, reading operands the way the kernels address them
(the int8 conv's window with its halo, tap shift, stride, images a tile,
weight stages and N split; K6's 64-channel K tiles across the two pieces,
row and column tiles and W panels), reproduces the plain versions: the
int8 conv exactly in int32 against the JAX package's XLA conv, K6 in f32
for one piece and two.

Tolerances: the int8 conv is exact; K6's walk sums each row's products in
another order than one matmul, 1e-5 of max abs in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.ops.quant import int8_conv as j_int8_conv
from infodiffusion_tpu_torch.ops.cuda import qconv as K7
from infodiffusion_tpu_torch.ops.cuda import shortcut_fused as K6

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMS = 132
K6_TOL = 1e-5

# (H, W, Cin, Cout, stride) of every chainless int8 conv of the flagship
# InfoDiff (CelebA-64, ch 64, ch_mult (1,2,2,2)) forward, at B = 128
INT8_SITES = [
    (8, 8, 128, 128, 1), (16, 16, 128, 128, 1), (16, 16, 128, 128, 2),
    (32, 32, 64, 128, 1), (32, 32, 128, 128, 1), (32, 32, 128, 128, 2),
    (64, 64, 64, 64, 1), (64, 64, 64, 64, 2), (64, 64, 128, 64, 1),
    (64, 64, 128, 128, 1),
]
# ragged shapes: odd sizes, a padded Cin, Cout off the N tile and off a
# multiple of 4, Cout past one N tile (split, streamed weights), Cin past
# one weight panel
INT8_RAGGED = [
    (3, 7, 9, 32, 40, 1), (3, 5, 5, 64, 40, 2), (2, 9, 7, 3, 16, 1),
    (2, 6, 11, 160, 300, 2), (1, 20, 150, 96, 24, 1), (3, 1, 1, 32, 8, 2),
    (2, 5, 7, 32, 30, 1), (2, 4, 4, 40, 7, 2),
]

# (H, W, piece channels, N) of every K6 site of one forward: the flagship
# InfoDiff's backbone (13), the vanilla UNet (15) and the VAE decoder (15),
# CelebA-64 widths
_DEEP = [(32, 32, (64,), 128), (16, 16, (128,), 256), (8, 8, (256,), 512),
         (8, 8, (512, 512), 512), (8, 8, (512, 512), 512),
         (8, 8, (512, 256), 512), (16, 16, (512, 256), 256),
         (16, 16, (256, 256), 256), (16, 16, (256, 128), 256),
         (32, 32, (256, 128), 128), (32, 32, (128, 128), 128),
         (32, 32, (128, 64), 128), (64, 64, (128, 64), 64),
         (64, 64, (64, 64), 64), (64, 64, (64, 64), 64)]
K6_SITES = {
    "infodiff": [(32, 32, (64,), 128)] + [(8, 8, (128, 128), 128)] * 3
    + [(16, 16, (128, 128), 128)] * 3 + [(32, 32, (128, 128), 128)] * 2
    + [(32, 32, (128, 64), 128), (64, 64, (128, 64), 64)]
    + [(64, 64, (64, 64), 64)] * 2,
    "vanilla": _DEEP,
    "vae_decoder": _DEEP,
}


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ the int8 conv


@pytest.mark.parametrize("site", INT8_SITES + [s[1:] for s in INT8_RAGGED])
def test_int8_conv_plan_fits_and_covers(site):
    H, W, C, cout, s = site
    for B in (1, 3, 128):
        cin = K7.int8_conv_cin(C)
        p = K7.int8_conv_launch_plan(B, H, W, cin, cout, s)
        Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
        assert p["smem"] <= SMEM_LIMIT, (B, site, p)
        assert p["ipt"] * p["th"] * p["tw"] <= 128
        assert p["n"] * p["nsplit"] >= cout and p["n"] in (64, 128, 256)
        assert p["groups"] * p["ipt"] >= B
        assert p["row_tiles"] * p["th"] >= Ho
        assert p["col_tiles"] * p["tw"] >= Wo
        assert p["blocks"] == min(p["tiles"], SMS)
        assert p["stages"] == p["n_stages"] if p["resident"] else \
            2 <= p["stages"] <= 4
        # at the flagship's small images a tile packs whole images, as
        # many as fit: no warpgroup idles where two fit
        if site in INT8_SITES and Ho * Wo <= 128:
            assert p["ipt"] == min(B, 128 // (Ho * Wo))
    with pytest.raises(ValueError):
        K7.int8_conv_launch_plan(1, H, W, 48, cout, s)


def _stage_matrix(stage: torch.Tensor, n: int, kp: int) -> torch.Tensor:
    """A weight stage's [n/8][kp/16][8][16] core matrices as the [n, kp]
    matrix wgmma reads (B K-major: row n, byte k)."""
    return stage.reshape(n // 8, kp // 16, 8, 16).permute(0, 2, 1, 3) \
        .reshape(n, kp)


def _emulate_int8_conv(xq: torch.Tensor, kq: torch.Tensor, stride: int):
    """The kernel's walk in plain torch (f64, exact): each tile's window
    with the halo zero-filled as the loaders do, each consumer pixel's
    window row (its ldmatrix address), the tap's shift and each weight
    stage as the core-matrix layout stores it."""
    B, H, W, C = xq.shape
    cout = kq.shape[3]
    cin = K7.int8_conv_cin(C)
    p = K7.int8_conv_launch_plan(B, H, W, cin, cout, stride)
    x = torch.nn.functional.pad(xq, (0, cin - C)).to(torch.float64)
    wst = K7.int8_conv_weights(kq, cin, p).to(torch.float64)
    n, kp = p["n"], p["kp"]
    panels = cin // kp
    assert wst.shape == (p["nsplit"], 9, panels, n // 8, kp // 16, 8, 16)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.full((B, Ho, Wo, cout), -2**31, dtype=torch.float64)
    wr, wc = p["win_rows"], p["win_cols"]
    assert (p["th"] - 1) * stride + 3 == wr and (p["tw"] - 1) * stride + 3 == wc
    # window positions: image, row, column
    pos = torch.arange(p["ipt"] * wr * wc)
    img, r, c = pos // (wr * wc), (pos % (wr * wc)) // wc, pos % wc
    m = torch.arange(128)
    per = p["th"] * p["tw"]
    m_img, m_oh, m_ow = m // per, (m % per) // p["tw"], m % p["tw"]
    for tile in range(p["tiles"]):
        ct = tile % p["col_tiles"]
        rt = (tile // p["col_tiles"]) % p["row_tiles"]
        grp = (tile // (p["col_tiles"] * p["row_tiles"])) % p["groups"]
        ns = tile // (p["col_tiles"] * p["row_tiles"] * p["groups"])
        b0, oh0, ow0 = grp * p["ipt"], rt * p["th"], ct * p["tw"]
        ih, iw, b = oh0 * stride - 1 + r, ow0 * stride - 1 + c, b0 + img
        ok = (b < B) & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
        win = torch.zeros(len(pos), cin, dtype=torch.float64)
        win[ok] = x[b[ok], ih[ok], iw[ok]]
        valid = ((m < p["ipt"] * per) & (b0 + m_img < B)
                 & (oh0 + m_oh < Ho) & (ow0 + m_ow < Wo))
        pos0 = torch.where(valid, m_img * wr * wc + m_oh * stride * wc
                           + m_ow * stride, torch.zeros_like(m))
        acc = torch.zeros(128, n, dtype=torch.float64)
        for j in range(9 * panels):
            tap, panel = divmod(j, panels)
            rows = win[pos0 + (tap // 3) * wc + tap % 3,
                       panel * kp:(panel + 1) * kp]
            acc += rows @ _stage_matrix(wst[ns, tap, panel], n, kp).T
        cols = ns * n + torch.arange(n)
        keep = cols < cout
        mv = m[valid]
        out[(b0 + m_img[mv])[:, None], (oh0 + m_oh[mv])[:, None],
            (ow0 + m_ow[mv])[:, None], cols[keep]] = acc[mv][:, keep]
    assert (out > -2**31).all(), "an output no tile wrote"
    return out.to(torch.int32)


def _int8_case(B, H, W, C, cout, seed):
    rng = np.random.RandomState(seed)
    xq = rng.randint(-127, 128, (B, H, W, C)).astype(np.int8)
    kq = rng.randint(-127, 128, (3, 3, C, cout)).astype(np.int8)
    return xq, kq


@pytest.mark.parametrize("case", [(2,) + s for s in INT8_SITES] + INT8_RAGGED,
                         ids=lambda c: "x".join(map(str, c)))
def test_int8_conv_tile_walk_is_exact(case):
    B, H, W, C, cout, s = case
    xq, kq = _int8_case(B, H, W, C, cout, seed=H * W + C + cout + s)
    got = _emulate_int8_conv(torch.from_numpy(xq), torch.from_numpy(kq), s)
    want = np.asarray(j_int8_conv(jnp.asarray(xq), jnp.asarray(kq), (s, s),
                                  ((1, 1), (1, 1))))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------- K6 bf16


@pytest.mark.parametrize("model", sorted(K6_SITES))
def test_shortcut_plan_fits_and_covers(model):
    sites = K6_SITES[model]
    assert len(sites) == {"infodiff": 13}.get(model, 15)
    for hh, ww, cs, n in sites:
        for B in (1, 64, 128):
            M = B * hh * ww
            p = K6.shortcut_launch_plan(M, cs[0], cs[1] if len(cs) > 1 else 0,
                                        n, torch.bfloat16)
            assert p["smem"] <= SMEM_LIMIT, (model, cs, n, p)
            # with W resident every output column is in one product, so
            # each piece row is read once; else 128 x 128 GEMM tiles
            assert p["nsplit"] * p["nw"] >= n
            assert p["tiles"] == _cdiv(M, 128) * p["nsplit"]
            assert p["kt"] * 64 >= sum(cs)
            assert p["blocks"] == min(p["tiles"], SMS)
            assert 2 <= p["stages"] <= 4
            if p["resident"]:
                assert p["nsplit"] == 1 and p["w_bytes"] >= n * sum(cs) * 2
            else:
                assert p["nw"] == 128
            assert p["tma"] == (not p["resident"] and cs[0] % 64 == 0)
            if model == "infodiff":  # W resident at every flagship site
                assert p["resident"]
    with pytest.raises(ValueError, match="bf16"):
        K6.shortcut_launch_plan(64, 64, 0, 64, torch.float32)


def _emulate_shortcut(h, pieces, weight, bias):
    """K6's bf16 body walked in plain torch, in f32: row and column
    tiles, the concat's 64-channel K tiles read from the pieces in place
    (zeros past the channels, a tile may straddle the pieces), W's panels,
    each consumer warpgroup's rows, then h + bias."""
    N = h.shape[-1]
    P = [p.reshape(-1, p.shape[-1]) for p in pieces]
    cs = [p.shape[1] for p in P]
    c0, c1 = cs[0], cs[1] if len(cs) > 1 else 0
    M, ctot = P[0].shape[0], c0 + c1
    p = K6.shortcut_launch_plan(M, c0, c1, N, torch.bfloat16)
    hr = h.reshape(M, N)
    out = torch.full((M, N), float("nan"))
    npad = p["nw"]
    for tile in range(p["tiles"]):
        row0 = (tile // p["nsplit"]) * 128
        col0 = (tile % p["nsplit"]) * npad
        rows = torch.arange(row0, row0 + 128)
        acc = torch.zeros(128, npad)
        for kt in range(p["kt"]):
            kc = torch.arange(kt * 64, kt * 64 + 64)
            a = torch.zeros(128, 64)
            w = torch.zeros(npad, 64)
            for j, (piece, lo, c) in enumerate(((P[0], 0, c0),
                                                (P[1] if c1 else None, c0, c1))):
                sel = (kc >= lo) & (kc < lo + c)
                if piece is None or not sel.any():
                    continue
                rv = (rows < M).nonzero()[:, 0]
                a[rv[:, None], sel.nonzero()[:, 0]] = \
                    piece[rows[rv]][:, kc[sel] - lo]
            ncols = torch.arange(col0, col0 + npad)
            nv = (ncols < N).nonzero()[:, 0]
            kv = (kc < ctot).nonzero()[:, 0]
            w[nv[:, None], kv] = weight[ncols[nv]][:, kc[kv]]
            # the two consumer warpgroups, 64 rows each
            for wg in range(2):
                acc[64 * wg:64 * wg + 64] += a[64 * wg:64 * wg + 64] @ w.T
        rv = rows < M
        cv = torch.arange(col0, min(col0 + npad, N))
        out[rows[rv][:, None], cv] = (hr[rows[rv]][:, cv] + bias[cv]
                                      + acc[rv][:, :len(cv)])
    assert not out.isnan().any(), "an output no tile wrote"
    return out.reshape(h.shape)


@pytest.mark.parametrize("cs,n,rows", [
    ((64,), 128, 300), ((128, 64), 64, 257), ((40, 24), 64, 130),
    ((256,), 512, 70), ((512, 256), 512, 64), ((72, 56), 640, 100),
    ((128, 128), 256, 129), ((64,), 384, 100),
], ids=lambda v: str(v))
def test_shortcut_tile_walk_matches_plain(cs, n, rows):
    rng = np.random.RandomState(sum(cs) + n + rows)
    h = torch.from_numpy(rng.randn(rows, n).astype(np.float32))
    pieces = [torch.from_numpy(rng.randn(rows, c).astype(np.float32))
              for c in cs]
    weight = torch.from_numpy(
        (rng.randn(n, sum(cs)) / np.sqrt(sum(cs))).astype(np.float32))
    bias = torch.from_numpy(rng.randn(n).astype(np.float32))
    got = _emulate_shortcut(h, pieces, weight, bias)
    want = K6.shortcut_fused_reference(h, pieces, weight, bias)
    err = (got - want).abs().max() / want.abs().max()
    assert err <= K6_TOL, err
