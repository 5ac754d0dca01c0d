"""K7's Hopper bodies (``csrc/qconv_wgmma.cuh`` on the int8 conv's core)
on the CPU: their launch plan (``qconv_launch_plan``) fits the card's
shared memory and covers every output at the flagship's 11 ResBlock conv
sites and at odd shapes, for both bodies and both piece dtypes; and a walk
in plain torch over each plan's tiles, reading and writing operands the way
the kernels address them, reproduces the plain versions. The walk mirrors
the kernel: each block's walks (blockIdx.x + k gridDim.x), the window ring
with the two halo rows a tile carries on, the chain workers' chunks of
eight channels (their incremental positions, the piece split inside a
16-byte panel, zeros outside the image and past the channels), v2's raw-row
ring as worker 0 issues whole fills into it ahead of the chain, the
consumers' ldmatrix
rows per tap, the weight stages as ``int8_conv_weights`` lays them out, the
N tile's masking and the epilogue. The chain's int8 values are the plain
version's (``chain_q``): the walk checks where each is written and read and
that each input element is quantized once a walk, not the chain's
arithmetic, which the card checks.

Tolerances: the s32 sums are exact against the JAX package's int8 conv of
the same int8 values; the output within 1e-6 relative L2 of the JAX
package's ``qconv_reference`` and of its Pallas ``qconv_fused`` in
interpret mode (tests/test_torch_qconv.py's bar: float rounding only).
Also pinned: the chainless conv's plans at its flagship sites, as a literal
table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.ops.pallas import qconv as jqc
from infodiffusion_tpu.ops.quant import int8_conv as j_int8_conv
from infodiffusion_tpu_torch.ops.cuda import qconv as K7

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMS = 132
CHAIN = 256          # chain workers a block
QCONV_TOL = 1e-6

# (H, W, piece channels, Cout) of the flagship InfoDiff's (CelebA-64, ch
# 64, ch_mult (1,2,2,2)) ResBlock convs, K7's sites
SITES = [
    (8, 8, (128,), 128), (8, 8, (128, 128), 128), (16, 16, (128,), 128),
    (16, 16, (128, 128), 128), (32, 32, (64,), 128), (32, 32, (128,), 128),
    (32, 32, (128, 64), 128), (32, 32, (128, 128), 128),
    (64, 64, (64,), 64), (64, 64, (64, 64), 64), (64, 64, (128, 64), 64),
]
# odd shapes: Ctot 32, 96, 192, 320; a piece boundary inside a 16-byte
# panel (24, 40); Cout 32, 96, 256 and past one N tile; a ragged last row
# tile; columns past one tile (W > 128)
ODD = [
    (6, 7, (32,), 32), (9, 5, (64, 32), 96), (15, 20, (24, 40), 64),
    (12, 12, (128, 64), 256), (7, 9, (256, 64), 96), (5, 150, (32,), 32),
    (10, 10, (64,), 300), (20, 9, (96,), 64),
]


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ the plans


def _check_plan(p, B, H, W, ctot, cout, dtype, v2):
    elem = 2 if dtype == torch.bfloat16 else 4
    assert p["smem"] <= SMEM_LIMIT
    assert p["ipt"] * p["th"] * p["tw"] <= 128
    assert p["cin"] >= ctot and p["cin"] % p["kp"] == 0
    # Cout in one N tile up to 128, beyond that tiles of 128 from one
    # window: quantized once for all of it
    assert p["n"] == (64 if cout <= 64 else 128)
    assert p["npass"] == p["nsplit"] == _cdiv(cout, p["n"])
    if cout <= 128:
        assert p["npass"] == 1
    assert p["groups"] * p["ipt"] >= B
    assert p["row_tiles"] * p["th"] >= H and p["col_tiles"] * p["tw"] >= W
    assert p["segs"] * p["rps"] >= p["row_tiles"]
    assert (p["segs"] - 1) * p["rps"] < p["row_tiles"]  # no empty segment
    assert p["walks"] == p["groups"] * p["col_tiles"] * p["segs"]
    assert p["blocks"] == min(p["walks"], SMS)
    wr = p["ipt"] * p["win_rows"]
    rows = p["row_tiles"] > 1
    assert p["ipt"] == 1 or not rows  # whole images never carry rows
    assert p["ring"] == 2 * wr or (rows and p["ring"] == wr + p["th"])
    if v2:  # the raw ring holds a fill's staged rows, at most 64
        fill = p["th"] + 2 if rows else p["ipt"] * H
        assert fill <= p["raw_rows"] <= 64
        assert p["raw_row_bytes"] >= min(p["win_cols"], W) * ctot * elem
    else:
        assert p["raw_rows"] == 0
    assert p["stages"] == p["npass"] * p["n_stages"] <= 72 if p["resident"] \
        else 2 <= p["stages"] <= 8
    assert p["kp"] == (p["cin"] if p["n"] == 64 and p["cin"] <= 192 else
                       128 if p["cin"] % 128 == 0 else 64)
    # where the image walks would leave half the SMs idle, an image's rows
    # split between blocks
    strips = p["groups"] * p["col_tiles"]
    if 2 * strips <= SMS and p["row_tiles"] > 1:
        assert p["segs"] > 1


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("site", SITES + ODD, ids=lambda s: (
    f"{s[0]}x{s[1]}-{'+'.join(map(str, s[2]))}-{s[3]}"))
def test_qconv_plan_fits_and_covers(site, dtype, v2):
    H, W, cs, cout = site
    for B in (1, 3, 128, 140):
        p = K7.qconv_launch_plan(B, H, W, sum(cs), cout, dtype, v2)
        _check_plan(p, B, H, W, sum(cs), cout, dtype, v2)


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_flagship_plans_walk_each_image_once(v2):
    """At B=128 bf16 each flagship site's walks are whole images (or image
    pairs at 8x8), each window quantized once for all of Cout: every input
    element is quantized once, which the walk below counts."""
    for H, W, cs, cout in SITES:
        p = K7.qconv_launch_plan(128, H, W, sum(cs), cout, torch.bfloat16, v2)
        assert p["segs"] == 1 and p["col_tiles"] == 1
        assert p["walks"] == _cdiv(128, p["ipt"])
        assert p["ipt"] == (2 if H * W == 64 else 1)
        if not v2:  # v1 keeps the weights resident where Ctot * Cout allows
            assert p["resident"] == (9 * p["cin"] * cout <= 150_000)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        K7.qconv_launch_plan(2, 8, 8, 36, 64, torch.bfloat16, False)
    with pytest.raises(ValueError):
        K7.qconv_launch_plan(2, 8, 8, 64, 64, torch.float16, False)
    assert K7.qconv_cin(32) == 64 and K7.qconv_cin(96) == 128
    assert K7.qconv_cin(128) == 128
    assert K7.qconv_cin(192) == 192 and K7.qconv_cin(320) == 320


# the chainless int8 conv's plans at its flagship sites (B = 128): K7's
# bodies share its core, and its plans stay as they were
INT8_PLANS = {
    (8, 8, 128, 128, 1): (2, 8, 8, 128, 9, True, 205824, 64, 64),
    (16, 16, 128, 128, 1): (1, 8, 16, 128, 9, True, 200192, 256, 132),
    (16, 16, 128, 128, 2): (2, 8, 8, 128, 3, False, 216576, 64, 64),
    (32, 32, 64, 128, 1): (1, 4, 32, 128, 9, True, 107264, 1024, 132),
    (32, 32, 128, 128, 1): (1, 4, 32, 128, 9, True, 207104, 1024, 132),
    (32, 32, 128, 128, 2): (1, 8, 16, 128, 4, False, 228096, 256, 132),
    (64, 64, 64, 64, 1): (1, 2, 64, 64, 9, True, 79872, 4096, 132),
    (64, 64, 64, 64, 2): (1, 4, 32, 64, 9, True, 131328, 1024, 132),
    (64, 64, 128, 64, 1): (1, 2, 64, 64, 9, True, 150528, 4096, 132),
    (64, 64, 128, 128, 1): (1, 2, 64, 128, 9, True, 224256, 4096, 132),
}


@pytest.mark.parametrize("site", sorted(INT8_PLANS),
                         ids=lambda s: "x".join(map(str, s)))
def test_chainless_plans_unchanged(site):
    H, W, c, cout, s = site
    p = K7.int8_conv_launch_plan(128, H, W, K7.int8_conv_cin(c), cout, s)
    got = tuple(p[k] for k in ("ipt", "th", "tw", "n", "stages", "resident",
                               "smem", "tiles", "blocks"))
    assert got == INT8_PLANS[site]


# ------------------------------------------------------------- the walk


def _stage_matrix(stage, n, kp):
    """A weight stage's [n/8][kp/16][8][16] core matrices as the [n, kp]
    matrix wgmma reads."""
    return stage.reshape(n // 8, kp // 16, 8, 16).permute(0, 2, 1, 3) \
        .reshape(n, kp)


def _walker(p, block, grid):
    """The block's tiles in order, as csrc/int8_conv_wgmma.cuh's Walker:
    (it, first, base, ns, b0, oh0, ow0, walk)."""
    wr = p["ipt"] * p["win_rows"]
    it, base, walk = 0, 0, block
    while walk < p["walks"]:
        w = walk
        ow0 = (w % p["col_tiles"]) * p["tw"]
        w //= p["col_tiles"]
        seg = w % p["segs"]
        w //= p["segs"]
        b0, ns = (w % p["groups"]) * p["ipt"], w // p["groups"]
        rt0 = seg * p["rps"]
        for rt in range(rt0, min(p["row_tiles"], rt0 + p["rps"])):
            first = rt == rt0
            if it:
                base = (base + (wr if first else wr - 2)) % p["ring"]
            yield it, first, base, ns, b0, rt * p["th"], ow0, walk
            it += 1
        walk += grid


class _Walk:
    """K7's walk over one plan, in plain torch: the chain threads fill the
    ring (v2 through the raw ring), the consumers read it per tap."""

    def __init__(self, pieces, A, Bv, s_act, q, kq, sw, bias, v2, grid=None):
        self.pieces = [p.float() for p in pieces]
        self.A, self.Bv, self.s, self.q = A, Bv, s_act, q
        B, H, W, _ = pieces[0].shape
        self.cs = [p.shape[-1] for p in pieces]
        self.B, self.H, self.W = B, H, W
        self.ctot, self.cout = sum(self.cs), kq.shape[3]
        self.v2 = v2
        p = self.p = K7.qconv_launch_plan(B, H, W, self.ctot, self.cout,
                                          pieces[0].dtype, v2)
        self.grid = grid or p["blocks"]
        self.wst = K7.int8_conv_weights(kq, p["cin"], p).to(torch.float64)
        self.sw, self.bias = sw, bias
        self.out = torch.full((B, H, W, self.cout), float("nan"))
        self.acc = torch.full((B, H, W, self.cout), -2.0**40,
                              dtype=torch.float64)
        self.quantized = {}  # (walk, b, ih, iw, channel group) -> times

    # -- the chain threads
    def _fill(self, first, base, b0, oh0, ow0, walk_id):
        p, cs = self.p, self.cs
        wr, cpr, g0 = p["ipt"] * p["win_rows"], self.ctot // 8, cs[0] // 8
        per_row = p["win_cols"] * cpr
        d_r, d_rem = CHAIN // per_row, CHAIN % per_row
        d_c, d_g = d_rem // cpr, d_rem % cpr
        r0 = 0 if first else 2
        n = (wr - r0) * per_row
        lo, hi = max(r0, 1 - oh0), min(wr, self.H - oh0 + 1)
        nimg = min(p["ipt"], self.B - b0)
        nst = max(hi - lo, 0) if p["ipt"] == 1 else nimg * self.H
        c_lo = max(ow0 - 1, 0)
        ncols = min(ow0 + p["tw"] + 1, self.W) - c_lo
        for q in range(CHAIN):
            q1 = n
            r = r0 + q // per_row
            col, cg = (q % per_row) // cpr, q % cpr
            img = r // p["win_rows"]
            rr = r - img * p["win_rows"]
            while q < q1:
                b, ih, iw = b0 + img, oh0 - 1 + rr, ow0 - 1 + col
                inside = b < self.B and 0 <= ih < self.H and 0 <= iw < self.W
                slot = (base + r) % p["ring"]
                chans = slice(cg * 8, cg * 8 + 8)
                if inside:
                    second = cg >= g0
                    if self.v2:  # the raw row from its slot, as laid out
                        kk = self.k + (r - lo if p["ipt"] == 1
                                       else img * self.H + rr - 1)
                        assert self.raw[kk % p["raw_rows"]] == (b, ih, c_lo,
                                                                ncols), kk
                        rc = iw - c_lo
                        off = (ncols * cs[0] + rc * cs[1] + cg * 8 - cs[0]
                               if second else rc * cs[0] + cg * 8)
                        raw = self.raw_values(b, ih, c_lo, ncols)[
                            off:off + 8]
                    else:
                        piece = self.pieces[1 if second else 0]
                        c = cg * 8 - (cs[0] if second else 0)
                        raw = piece[b, ih, iw, c:c + 8]
                    want = torch.cat([x[b, ih, iw] for x in self.pieces])
                    assert torch.equal(raw, want[chans])
                    self.win[slot, col, chans] = self.q[b, ih, iw, chans]
                    key = (walk_id, b, ih, iw, cg)
                    self.quantized[key] = self.quantized.get(key, 0) + 1
                else:
                    self.win[slot, col, chans] = 0
                q += CHAIN
                cg += d_g
                col += d_c
                dr = d_r
                if cg >= cpr:
                    cg -= cpr
                    col += 1
                if col >= p["win_cols"]:
                    col -= p["win_cols"]
                    dr += 1
                r += dr
                rr += dr
                while rr >= p["win_rows"]:
                    rr -= p["win_rows"]
                    img += 1
        if self.v2:  # the fill's rows are free; worker 0 issues ahead
            assert nst == len(self.fills[self.filled])
            self.filled += 1
            self.k += nst
            self._issue_ahead()

    def raw_values(self, b, ih, c_lo, ncols):
        """A staged raw row as the copy lane lays it out: each piece's
        window columns in the image, one after the other."""
        return torch.cat([x[b, ih, c_lo:c_lo + ncols].reshape(-1)
                          for x in self.pieces])

    # -- v2's raw rows: each fill's staged rows, issued by worker 0 whole
    # fills at a time as soon as they fit beside the rows not consumed
    def _staged_fills(self, tiles):
        p, fills = self.p, []
        wr = p["ipt"] * p["win_rows"]
        for _, first, _, _, b0, oh0, ow0, _ in tiles:
            c_lo = max(ow0 - 1, 0)
            ncols = min(ow0 + p["tw"] + 1, self.W) - c_lo
            if p["ipt"] == 1:
                lo, hi = max(0 if first else 2, 1 - oh0), min(wr,
                                                              self.H - oh0 + 1)
                fills.append([(b0, oh0 - 1 + r, c_lo, ncols)
                              for r in range(lo, hi)])
            else:
                fills.append([(b0 + img, ih, c_lo, ncols)
                              for img in range(min(p["ipt"], self.B - b0))
                              for ih in range(self.H)])
        return fills

    def _issue_ahead(self):
        rr = self.p["raw_rows"]
        while (self.issued < len(self.fills) and self.k_iss
               + len(self.fills[self.issued]) <= self.k + rr):
            for row in self.fills[self.issued]:
                self.raw[self.k_iss % rr] = row
                self.k_iss += 1
            self.issued += 1

    # -- the consumer warpgroups
    def _consume(self, it, base, ns, b0, oh0, ow0):
        p = self.p
        n, kp = p["n"], p["kp"]
        panels = p["cin"] // kp
        per = p["th"] * p["tw"]
        m = torch.arange(128)
        img, ohl, owl = m // per, (m % per) // p["tw"], m % p["tw"]
        valid = ((m < p["ipt"] * per) & (b0 + img < self.B)
                 & (oh0 + ohl < self.H) & (ow0 + owl < self.W))
        r0 = torch.where(valid, img * p["win_rows"] + ohl, 0)
        c0 = torch.where(valid, owl, 0)
        mv = m[valid]
        for ns in range(ns, ns + p["npass"]):  # N tiles from one window
            acc = torch.zeros(128, n, dtype=torch.float64)
            for j in range(p["n_stages"]):
                tap, panel = divmod(j, panels)
                dh, dw = divmod(tap, 3)
                rows = self.win[(base + r0 + dh) % p["ring"], c0 + dw,
                                panel * kp:(panel + 1) * kp]
                acc += rows @ _stage_matrix(self.wst[ns, tap, panel], n,
                                            kp).T
            cols = ns * n + torch.arange(n)
            keep = cols < self.cout
            idx = ((b0 + img[mv])[:, None], (oh0 + ohl[mv])[:, None],
                   (ow0 + owl[mv])[:, None], cols[keep])
            assert (self.acc[idx] == -2.0**40).all(), "an output written twice"
            self.acc[idx] = acc[mv][:, keep]

    def run(self):
        p = self.p
        for block in range(self.grid):
            tiles = list(_walker(p, block, self.grid))
            self.win = torch.full((p["ring"], p["win_cols"], p["cin"]), 0.0,
                                  dtype=torch.float64)
            self.win[..., self.ctot:] = 0  # the ring starts zero
            self.win[..., :self.ctot] = float("nan")
            if self.v2:
                self.fills = self._staged_fills(tiles)
                self.raw = [None] * p["raw_rows"]
                self.k = self.k_iss = self.issued = self.filled = 0
                self._issue_ahead()
            wr = p["ipt"] * p["win_rows"]
            # fill(it + 1) runs beside consume(it) unless the kernel waits
            # for it: at a walk's start in a ring short of two windows
            done = 0
            for i, (it, first, base, ns, b0, oh0, ow0, walk) in \
                    enumerate(tiles):
                if done == i:
                    self._fill(first, base, b0, oh0, ow0, walk)
                    done += 1
                nxt = tiles[i + 1] if i + 1 < len(tiles) else None
                if nxt and not (nxt[1] and p["ring"] < 2 * wr):
                    self._fill(nxt[1], nxt[2], *nxt[4:])
                    done += 1
                self._consume(it, base, ns, b0, oh0, ow0)
        assert (self.acc > -2.0**40).all(), "an output no tile wrote"
        assert set(self.quantized.values()) == {1}, "quantized twice a walk"
        y = self.acc.to(torch.int32)
        out = y.to(torch.float32) * self.sw + self.bias
        return y, out


def _case(B, H, W, cs, cout, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    ctot = sum(cs)
    ps = [(0.5 * rng.randn(B, H, W, c)).astype(np.float32) for c in cs]
    A = (1.0 + 0.1 * rng.randn(B, ctot)).astype(np.float32)
    Brow = (0.1 * rng.randn(B, ctot)).astype(np.float32)
    absmax = np.array([np.abs(p).max() * 1.2 for p in ps], np.float32)
    k = (0.2 * rng.randn(3, 3, ctot, cout)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    pieces = [torch.from_numpy(p).to(dtype) for p in ps]
    return pieces, ps, A, Brow, absmax, k, b


def _walk_case(B, H, W, cs, cout, v2, seed, dtype=torch.float32, grid=None):
    pieces, ps, A, Brow, absmax, k, b = _case(B, H, W, cs, cout, seed, dtype)
    s = K7.act_scale(torch.from_numpy(absmax))
    kmat, sw = K7._fold_pack(torch.from_numpy(k), s, list(cs))
    ctot = sum(cs)
    kq = kmat.view(3, ctot, 3, cout).permute(2, 0, 1, 3)
    At, Bt = torch.from_numpy(A), torch.from_numpy(Brow)
    q = K7.chain_q(pieces, At, Bt, s).to(torch.float64)
    walk = _Walk(pieces, At, Bt, s, q, kq, sw, torch.from_numpy(b), v2, grid)
    y, out = walk.run()
    return walk, y, out, q, kq, (ps, A, Brow, absmax, k, b)


# (B, H, W, piece channels, Cout): row tiles that carry rows on, whole
# images two a tile, a segment split (few images), a ragged last row
# tile, the piece split inside a panel, channel padding (Ctot 96 -> 128),
# Cout masked in its N tile and past one N tile, column tiles
WALKS = [
    (2, 20, 9, (32,), 32), (3, 8, 8, (64, 64), 64), (1, 17, 6, (24, 40), 96),
    (3, 5, 7, (64, 32), 32), (2, 6, 10, (16, 16), 300), (1, 4, 130, (32,), 32),
]


@pytest.fixture
def sms(request, monkeypatch):
    """The plan for a card of ``request.param`` SMs: with few, the walks
    are long (rows carried on, several walks a block) at small shapes."""
    monkeypatch.setattr(K7, "_SMS", request.param)
    K7.qconv_launch_plan.cache_clear()
    yield request.param
    K7.qconv_launch_plan.cache_clear()


@pytest.mark.parametrize("sms", [SMS, 2], indirect=True)
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", WALKS, ids=lambda c: "x".join(
    str(v) if not isinstance(v, tuple) else "+".join(map(str, v)) for v in c))
def test_walk_matches_jax(case, v2, sms):
    B, H, W, cs, cout = case
    walk, y, out, q, kq, (ps, A, Brow, absmax, k, b) = _walk_case(
        B, H, W, cs, cout, v2, seed=B + H + W + cout)
    # the s32 sums exactly: the JAX package's int8 conv of the same values
    want_y = np.asarray(j_int8_conv(jnp.asarray(q.numpy().astype(np.int8)),
                                    jnp.asarray(kq.numpy()), (1, 1),
                                    ((1, 1), (1, 1))))
    np.testing.assert_array_equal(y.numpy(), want_y)
    want = jqc.qconv_reference([jnp.asarray(p) for p in ps], jnp.asarray(A),
                               jnp.asarray(Brow), jnp.asarray(absmax),
                               jnp.asarray(k), jnp.asarray(b), jnp.float32)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(out.numpy() - want) / np.linalg.norm(want)
    assert err <= QCONV_TOL


@pytest.mark.parametrize("sms", [2], indirect=True)
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_walk_matches_pallas_interpret(v2, sms, monkeypatch):
    """Against the Pallas kernel (both its bodies) in interpret mode, with
    few blocks, so each takes several walks through one ring."""
    B, H, W, cs, cout = 2, 16, 8, (64, 32), 64
    _, _, out, _, _, (ps, A, Brow, absmax, k, b) = _walk_case(
        B, H, W, cs, cout, v2, seed=5, grid=3)
    monkeypatch.setenv("INFODIFF_QCONV_V2", "1" if v2 else "0")
    want = jqc.qconv_fused([jnp.asarray(p) for p in ps], jnp.asarray(A),
                           jnp.asarray(Brow), jnp.asarray(absmax),
                           jnp.asarray(k), jnp.asarray(b), jnp.float32,
                           interpret=True)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(out.numpy() - want) / np.linalg.norm(want)
    assert err <= QCONV_TOL


@pytest.mark.parametrize("sms", [4], indirect=True)
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_walk_bf16_pieces_and_small_grid(v2, sms):
    """bf16 pieces (v2 stages half the bytes a row), walks of many row
    tiles carrying their halo rows on, taken by a grid of 2 blocks."""
    walk, y, _, q, kq, _ = _walk_case(3, 40, 5, (32, 32), 64, v2, seed=11,
                                      dtype=torch.bfloat16, grid=2)
    assert walk.p["row_tiles"] > 1 and walk.p["rps"] > 1
    want = np.asarray(j_int8_conv(jnp.asarray(q.numpy().astype(np.int8)),
                                  jnp.asarray(kq.numpy()), (1, 1),
                                  ((1, 1), (1, 1))))
    np.testing.assert_array_equal(y.numpy(), want)


@pytest.mark.parametrize("sms", [2], indirect=True)
@pytest.mark.parametrize("v2,limit", [(False, 38000), (True, 75000)],
                         ids=["v1", "v2"])
def test_walk_ring_short_of_two_windows(v2, limit, sms, monkeypatch):
    """Where two windows do not fit, the ring holds one window and a tile's
    new rows, and a walk's first fill waits for the tile before it."""
    monkeypatch.setattr(K7, "_SMEM_LIMIT", limit)
    K7.qconv_launch_plan.cache_clear()
    walk, y, _, q, kq, _ = _walk_case(2, 30, 9, (64,), 64, v2, seed=13)
    p = walk.p
    assert p["ring"] == p["win_rows"] + p["th"] and p["rps"] > 1
    want = np.asarray(j_int8_conv(jnp.asarray(q.numpy().astype(np.int8)),
                                  jnp.asarray(kq.numpy()), (1, 1),
                                  ((1, 1), (1, 1))))
    np.testing.assert_array_equal(y.numpy(), want)
