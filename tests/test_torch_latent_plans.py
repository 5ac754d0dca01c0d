"""The cluster core of K4 and K5 (``csrc/latent_common.cuh``) on the CPU:
its launch plan (``latent_launch_plan``) fits the card's shared memory and
keeps every cluster resident at every batch and a_dim the models run, and
a plain-torch walk over the plan, reading operands the way the kernel
addresses them, reproduces the plain versions: K4
(``latent_trajectory_reference``) on the DDIM, DDPM and reverse
coefficients with f32 and int8 (+ Wsc) W, and K5
(``latent_unet_forward_reference``) with per-row FiLM.

The walk follows the kernel: each rank of a cluster keeps its own copy of
the panel (the layer input [G, 5d] in 64-column chunks: hidden, then x
twice, K5's s in the second x buffer), multiplies it with its column units
of W one 64-row K tile at a time in the kernel's order (int8 W decoded
from ``latent_int8_tiles`` the way a thread's A fragments read it), takes
two-pass (mean, M2) over its columns, merges the ranks' partials by Chan's
formula, and copies its normalised slice into every rank's panel; the
owner of an eps slice updates its f32 x and copies it into every panel's
other x buffer. Clusters walk their row groups in rounds.

Everything in f32, the int8 stream too: the walk reads int8 W's bytes
and scales and the plain version takes the same int8 values as f32 W with
Wsc, both with unrounded product inputs. (With inputs rounded to bf16, as
the kernel rounds them, the walk's other summation order moves a few
values across a bf16 rounding boundary, one ulp of 4e-3 each, and the
trajectory drifts by ~1e-4: that is the card's 1e-2 bar's business, not
the walk's.)

Tolerance: 1e-5 of max abs; the walk sums in another order than one
matmul, and the statistics merge in another order than a mean.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.ops.cuda import latent_mlp as K5
from infodiffusion_tpu_torch.ops.cuda import latent_traj as K4

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
SMS = 132
TOL = 1e-5
BATCHES = (1, 2, 8, 64, 100, 128, 256)
DIMS = (32, 256, 1024)
W_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}
f32 = torch.float32


def _cdiv(a, b):
    return -(-a // b)


def _plans(d, active):
    """(kernel, dtype tag, B, plan) of every plan at a_dim ``d``; a plan
    that does not fit raises, and only f32 at d=1024 may."""
    for kernel in ("traj", "mlp"):
        for tag, dtype in W_DTYPES.items():
            if kernel == "mlp" and tag == "int8":
                with pytest.raises(ValueError):
                    K5.latent_launch_plan(8, d, dtype, kernel, SMS, active)
                continue
            for B in BATCHES:
                if tag == "f32" and d == 1024:
                    with pytest.raises(ValueError):
                        K5.latent_launch_plan(B, d, dtype, kernel, SMS,
                                              active)
                    continue
                yield kernel, tag, B, K5.latent_launch_plan(
                    B, d, dtype, kernel, SMS, active)


def _owned(per, total, rank):
    return range(rank * per, min(rank * per + per, total))


@pytest.mark.parametrize("active", [7, 8])
@pytest.mark.parametrize("d", DIMS)
def test_plan_fits_and_covers(d, active):
    for kernel, tag, B, p in _plans(d, active):
        where = (kernel, tag, B, d, active, p)
        assert p["smem"] <= SMEM_LIMIT, where
        assert 2 <= p["stages"] <= 16, where
        assert p["rows"] in ((8, 16) if tag == "f32" else (8, 16, 32, 64))
        assert 1 <= p["ranks"] <= 16 and p["threads"] == 160, where
        # all clusters resident in one wave: at most the card's active
        # clusters, each of `ranks` SMs
        assert 1 <= p["clusters"] <= active, where
        assert p["clusters"] * p["ranks"] <= SMS, where
        # every batch row in exactly one row group, every group walked by
        # exactly one cluster, one after another
        walked = [grp for c in range(p["clusters"])
                  for grp in range(c, p["groups"], p["clusters"])]
        assert sorted(walked) == list(range(p["groups"])), where
        assert p["rounds"] == _cdiv(p["groups"], p["clusters"]), where
        rows = [r for grp in walked
                for r in range(grp * p["rows"], (grp + 1) * p["rows"])
                if r < B]
        assert sorted(rows) == list(range(B)), where
        assert (p["groups"] - 1) * p["rows"] < B, where  # no empty group
        # every output column of every layer owned by exactly one rank
        units = [u for q in range(p["ranks"])
                 for u in _owned(p["units_per_rank"], p["units"], q)]
        assert sorted(units) == list(range(4 * d // 64)), where
        # rank u owns eps unit u
        assert p["eps_units"] == _cdiv(d, 64) <= p["ranks"], where
        assert p["k_tiles"] * 64 >= 5 * d and p["x_tiles"] * 64 >= d
    # the fewest row groups: at B=128, d=256 in bf16 four clusters of 32
    # rows, each reading W once a step
    if d == 256:
        for kernel in ("traj", "mlp"):
            p = K5.latent_launch_plan(128, 256, torch.bfloat16, kernel, SMS,
                                      active)
            assert (p["rows"], p["groups"], p["clusters"], p["ranks"]) == \
                (32, 4, 4, 16)


def test_plan_refuses():
    for d in (8, 20, 1040):
        with pytest.raises(ValueError):
            K5.latent_launch_plan(8, d, torch.bfloat16, "traj", SMS, 8)
    with pytest.raises(ValueError):  # the card holds no cluster
        K5.latent_launch_plan(8, 256, torch.bfloat16, "traj", SMS, 0)
    with pytest.raises(ValueError):
        K5.latent_launch_plan(8, 256, torch.int8, "mlp", SMS, 8)


# ------------------------------------------------------------ the walk


def _latent_packed(d, T, seed, tag):
    """The port's LatentUNet at a_dim ``d`` with xavier weights and small
    biases from a numpy seed, packed in f32 (tag "f32") or as the int8
    weight stream of the turbo tier (tag "int8")."""
    model = Diff(T=T, shape=(1, d, d), is_latent=True)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                bound = np.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                v = rng.uniform(-bound, bound, p.shape)
            elif name.endswith("bias"):
                v = 0.1 * rng.randn(*p.shape)
            else:
                v = 1.0 + 0.1 * rng.randn(*p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    if tag == "f32":
        return K5.pack_latent_unet_params(model.backbone, d)
    return K4.quantize_packed_weights(
        K5.pack_latent_unet_params(model.backbone, d, dtype=torch.bfloat16))


class _Walk:
    """The plan's shapes and the operands as the kernel reads them."""

    def __init__(self, plan, W, Wc=None):
        self.p = plan
        self.L, win, self.h = W.shape
        self.d = win - self.h
        self.kt_h, self.kt_x = plan["units"], plan["x_tiles"]
        if W.dtype == torch.int8:
            self.tiles = self._decode(K4.latent_int8_tiles(W))
        else:
            kt = plan["k_tiles"]
            Wp = torch.zeros(self.L, kt * 64, self.h)
            Wp[:, :win] = W.to(f32)
            self.tiles = Wp.view(self.L, kt, 64, self.h // 64, 64) \
                .permute(0, 3, 1, 2, 4)  # [L, unit, K tile, k, m]
        if Wc is not None:
            Wcp = torch.zeros(self.L, self.kt_x * 64, self.h)
            Wcp[:, :self.d] = Wc.to(f32)
            self.ctiles = Wcp.view(self.L, self.kt_x, 64, self.h // 64, 64) \
                .permute(0, 3, 1, 2, 4)

    @staticmethod
    def _decode(t):
        """[L, unit, K tile, m, byte] int8 as a thread's A fragments read
        it: bytes 16 t + 4 kk + jj of row m are k = 16 kk + (2t, 2t + 1,
        2t + 8, 2t + 9)[jj]; returns [L, unit, K tile, k, m] f32."""
        out = torch.zeros(t.shape, dtype=f32)
        tf = t.to(f32)
        for tt in range(4):
            for kk in range(4):
                for jj, off in enumerate((2 * tt, 2 * tt + 1, 2 * tt + 8,
                                          2 * tt + 9)):
                    out[..., 16 * kk + off, :] = tf[..., :, 16 * tt + 4 * kk
                                                    + jj]
        return out

    def units(self, rank, last):
        p = self.p
        if last:
            return [rank] if rank < p["eps_units"] else []
        per = p["units_per_rank"]
        return list(range(rank * per, min(rank * per + per, p["units"])))

    def chunk(self, t, layer0, xb):
        """The panel chunk K tile t reads (as latent_common.cuh Chunks)."""
        first_x = self.kt_h + xb * self.kt_x
        return first_x + t if layer0 else t if t < self.kt_h else \
            first_x + t - self.kt_h

    def product(self, panel, j, u, xb):
        """One rank's product over its unit u of layer j: [G, 64], the K
        tiles in the kernel's order."""
        nt = self.kt_x if j == 0 else self.kt_h + self.kt_x
        acc = torch.zeros(panel.shape[0], 64)
        for t in range(nt):
            c = self.chunk(t, j == 0, xb)
            acc = acc + panel[:, 64 * c:64 * c + 64] @ self.tiles[j, u, t]
        return acc

    def film_product(self, panel, j, u):
        acc = torch.zeros(panel.shape[0], 64)
        for t in range(self.kt_x):
            c = self.kt_h + self.kt_x + t
            acc = acc + panel[:, 64 * c:64 * c + 64] @ self.ctiles[j, u, t]
        return acc

    def layer_norm(self, z, gamma, beta):
        """{rank: z [G, 64 units]} -> {rank: hidden}: each rank's two-pass
        (mean, M2), merged by Chan's formula."""
        parts = {q: (v.mean(1), (v - v.mean(1, keepdim=True)).square()
                     .sum(1), v.shape[1]) for q, v in z.items()}
        mean = sum(c * m for m, _, c in parts.values()) / self.h
        M2 = sum(m2 + c * (m - mean).square() for m, m2, c in parts.values())
        rstd = torch.rsqrt(M2 / self.h + K5.EPS)
        out = {}
        for q, v in z.items():
            cols = [64 * u + i for u in self.units(q, False)
                    for i in range(64)]
            t = (v - mean[:, None]) * rstd[:, None] * gamma[cols] + beta[cols]
            out[q] = F.silu(t)
        return out

    def z_cols(self, j, u):
        return [64 * u + i for i in range(64)]


def _walk_traj(plan, xT, coef, W, c_all, noises, bias, gamma, beta,
               Wsc=None):
    w = _Walk(plan, W)
    B, d = xT.shape
    G, R, L, S = plan["rows"], plan["ranks"], w.L, coef.shape[0]
    nchunks = w.kt_h + 2 * w.kt_x
    out = torch.full((B, d), float("nan"))
    for c in range(plan["clusters"]):
        for grp in range(c, plan["groups"], plan["clusters"]):
            r0 = grp * G
            n = min(G, B - r0)
            x = torch.zeros(G, 64 * w.kt_x)
            x[:n, :d] = xT[r0:r0 + n]
            panels = [torch.zeros(G, 64 * nchunks) for _ in range(R)]
            for pn in panels:
                pn[:, 64 * w.kt_h:64 * (w.kt_h + w.kt_x)] = x
            xs = {q: x[:, [64 * u + i for u in w.units(q, True)
                           for i in range(64)]].clone() for q in range(R)}
            noise = torch.zeros(S, G, 64 * w.kt_x)
            noise[:, :n, :d] = noises[:, r0:r0 + n]
            for i in range(S):
                xb = i & 1
                for j in range(L):
                    last = j == L - 1
                    z = {}
                    for q in range(R):
                        vs = []
                        for u in w.units(q, last):
                            cols = w.z_cols(j, u)
                            v = w.product(panels[q], j, u, xb)
                            if Wsc is not None:
                                v = v * Wsc[j, cols]
                            v = v + bias[j, cols]
                            if not last:
                                v = v * c_all[i, j, cols]
                            vs.append(v)
                        z[q] = torch.cat(vs, 1) if vs else torch.zeros(G, 0)
                    if not last:
                        hid = w.layer_norm(z, gamma[j], beta[j])
                        for q, v in hid.items():
                            for k, u in enumerate(w.units(q, False)):
                                for pn in panels:
                                    pn[:, 64 * u:64 * u + 64] = \
                                        v[:, 64 * k:64 * k + 64]
                        continue
                    for q in range(R):
                        ecols = [64 * u + i for u in w.units(q, True)
                                 for i in range(64)]
                        if not ecols:
                            continue
                        xn = (coef[i, 0] * xs[q] + coef[i, 1] * z[q]
                              + coef[i, 2] * noise[i][:, ecols])
                        xn[:, torch.tensor(ecols) >= d] = 0.0
                        xs[q] = xn
                        if i == S - 1:
                            keep = [k for k, cc in enumerate(ecols) if cc < d]
                            out[r0:r0 + n, [ecols[k] for k in keep]] = \
                                xn[:n, keep]
                            continue
                        for k, u in enumerate(w.units(q, True)):
                            ch = w.kt_h + (xb ^ 1) * w.kt_x + u
                            for pn in panels:
                                pn[:, 64 * ch:64 * ch + 64] = \
                                    xn[:, 64 * k:64 * k + 64]
    return out


def _walk_mlp(plan, x, s, W, Wc, bias, bc, gamma, beta):
    w = _Walk(plan, W, Wc=Wc)
    B, d = x.shape
    G, R, L = plan["rows"], plan["ranks"], w.L
    nchunks = w.kt_h + 2 * w.kt_x
    out = torch.full((B, d), float("nan"))
    for c in range(plan["clusters"]):
        for grp in range(c, plan["groups"], plan["clusters"]):
            r0 = grp * G
            n = min(G, B - r0)
            xp = torch.zeros(G, 64 * w.kt_x)
            xp[:n, :d] = x[r0:r0 + n]
            sp = torch.zeros(G, 64 * w.kt_x)
            sp[:n, :d] = s[r0:r0 + n]
            panels = [torch.zeros(G, 64 * nchunks) for _ in range(R)]
            for pn in panels:
                pn[:, 64 * w.kt_h:64 * (w.kt_h + w.kt_x)] = xp
                pn[:, 64 * (w.kt_h + w.kt_x):] = sp
            for j in range(L):
                last = j == L - 1
                z = {}
                for q in range(R):
                    vs = []
                    for u in w.units(q, last):
                        cols = w.z_cols(j, u)
                        v = w.product(panels[q], j, u, 0) + bias[j, cols]
                        if not last:
                            v = v * (1.0 + (w.film_product(panels[q], j, u)
                                            + bc[j, cols]))
                        vs.append(v)
                    z[q] = torch.cat(vs, 1) if vs else torch.zeros(G, 0)
                if last:
                    for q in range(R):
                        for k, u in enumerate(w.units(q, True)):
                            cols = [64 * u + i for i in range(64)
                                    if 64 * u + i < d]
                            out[r0:r0 + n, cols] = \
                                z[q][:n, 64 * k:64 * k + len(cols)]
                    break
                hid = w.layer_norm(z, gamma[j], beta[j])
                for q, v in hid.items():
                    for k, u in enumerate(w.units(q, False)):
                        for pn in panels:
                            pn[:, 64 * u:64 * u + 64] = v[:, 64 * k:64 * k + 64]
    return out


def _max_abs_rel(got, want):
    assert torch.isfinite(got).all()
    return ((got - want).abs().max() / want.abs().max()).item()


# (d, B, active clusters): one rank's eps slice among two (d=32) and among
# four ranks (d=64); ragged row groups (f32: 16 rows) walked in rounds by
# one and by two clusters, and one group
WALKS = [(32, 40, 1), (64, 40, 2), (64, 3, 8)]
CONTRACTS = {"ddim": dict(deterministic=True),
             "ddpm": dict(deterministic=False),
             "reverse": dict(deterministic=True, reverse=True)}


@pytest.mark.parametrize("tag", ["f32", "int8"])
@pytest.mark.parametrize("contract", list(CONTRACTS))
@pytest.mark.parametrize("d,B,active", WALKS)
def test_walk_reproduces_trajectory(d, B, active, contract, tag):
    S = 20
    kw = CONTRACTS[contract]
    T = S + 2 if kw.get("reverse") else S
    packed = _latent_packed(d, T, seed=d + B, tag=tag)
    rng = np.random.RandomState(100 + d + B)
    xT = torch.from_numpy(rng.randn(B, d).astype(np.float32))
    noises = torch.from_numpy(rng.randn(S, B, d).astype(np.float32))
    args = K4.trajectory_inputs(packed, make_schedule(1e-4, 2e-2, T), xT,
                                noises=noises, **kw)
    W = args[2]
    plan = K5.latent_launch_plan(B, d, W.dtype, "traj", SMS, active)
    got = _walk_traj(plan, *args[:8], Wsc=args[8])
    # int8: the same values as f32 W with Wsc, inputs unrounded
    want = K4.latent_trajectory_reference(*args[:2], W.to(f32), *args[3:])
    assert _max_abs_rel(got, want) <= TOL


@pytest.mark.parametrize("d,B,active", WALKS)
def test_walk_reproduces_forward(d, B, active):
    packed = _latent_packed(d, 10, seed=7 + d, tag="f32")
    rng = np.random.RandomState(200 + d + B)
    x = torch.from_numpy(rng.randn(B, d).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 10, size=B))
    s = K5.silu_time_embedding(packed, t).contiguous()
    args = (x, s, packed["W"], packed["Wc"], packed["B"], packed["Bc"],
            packed["G"], packed["Be"])
    plan = K5.latent_launch_plan(B, d, torch.float32, "mlp", SMS, active)
    got = _walk_mlp(plan, *args)
    want = K5.latent_unet_forward_reference(*args)
    assert _max_abs_rel(got, want) <= TOL


def test_int8_tiles_layout():
    """latent_int8_tiles puts W[j, 64 T + k, 64 u + m] at tile (j, u, T),
    row m, the byte a thread's fragment load expects."""
    rng = np.random.RandomState(3)
    d = 32
    W = torch.from_numpy(rng.randint(-127, 128, size=(3, 5 * d, 4 * d))
                         .astype(np.int8))
    t = K4.latent_int8_tiles(W)
    kt = 4 * d // 64 + 1
    assert t.shape == (3, 4 * d // 64, kt, 64, 64)
    dec = _Walk._decode(t)
    Wp = torch.zeros(3, kt * 64, 4 * d)
    Wp[:, :5 * d] = W.float()
    want = Wp.view(3, kt, 64, 2, 64).permute(0, 3, 1, 2, 4)
    assert torch.equal(dec, want)
