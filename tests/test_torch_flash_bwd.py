"""K3b's bf16 body on the CPU: its launch plan (``flash_bwd_launch_plan``)
and the arithmetic of its first launch, whose row statistics come from one
online pass over k (``csrc/flash_bwd_wgmma.cuh``), emulated in plain torch
and held against the contracts' plain versions. Small sizes.
"""

import math

import numpy as np
import pytest
import torch

from infodiffusion_tpu_torch.ops.cuda import flash_attention as pfa

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
PLAN_NS = (64, 256, 1000, 16384)
PLAN_BATCHES = (1, 4, 64)
# the online delta against the two-pass one: f32 rounding of the rescaled
# partial sums, relative to max |delta|
DELTA_TOL = 1e-5


@pytest.mark.parametrize("C", pfa.CHANNELS)
def test_flash_bwd_launch_plan_fits_and_covers(C):
    for B in PLAN_BATCHES:
        for N in PLAN_NS:
            p = pfa.flash_bwd_launch_plan(B, N, C, torch.bfloat16)
            rows, cols = p["rows"], p["cols"]
            for launch, own in ((rows, rows["bq"]), (cols, cols["bk"])):
                assert launch["smem"] <= SMEM_LIMIT, (B, N, C, p)
                assert launch["blocks"] == B * -(-N // own), (B, N, C, p)
                assert launch["blocks"] * own >= B * N, (B, N, C, p)
                assert launch["threads"] == 128 * (launch["warpgroups"] + 1)
                assert launch["stages"] >= (1 if C == 512 else 2)
            # C >= 256: two warpgroups share 64 rows; else 64 a warpgroup
            assert rows["bq"] == cols["bk"] == (
                64 if C >= 256 else 64 * rows["warpgroups"])
            if C < 256 and B * -(-N // 128) >= pfa.SMS:
                assert rows["bq"] == 128
            # the statistics scratch holds every row and every q tile the
            # second launch bulk-copies
            assert p["stat_rows"] % pfa.STAT_ALIGN == 0
            assert p["stat_rows"] >= -(-N // cols["bq"]) * cols["bq"] >= N
    with pytest.raises(ValueError, match="bf16"):
        pfa.flash_bwd_launch_plan(1, 64, C, torch.float32)


def test_flash_bwd_launch_plan_refuses_other_widths():
    with pytest.raises(ValueError, match="bf16"):
        pfa.flash_bwd_launch_plan(1, 64, 96, torch.bfloat16)


def _online_stats(q, k, v, do, block_k, dense):
    """The first launch's pass 1 in plain torch: per row the running max m
    (base 2), l = sum exp2(s2 - m) and dl = sum exp2(s2 - m) dp, rescaled
    together each k tile; returns (lse2, delta)."""
    B, N, C = q.shape
    scale2 = C ** -0.5 * math.log2(math.e)
    m = torch.full((B, N, 1), -torch.inf)
    l = torch.zeros((B, N, 1))
    dl = torch.zeros((B, N, 1))
    for j in range(0, N, block_k):
        s2 = torch.einsum("bnc,bmc->bnm", q, k[:, j:j + block_k]) * scale2
        dp = torch.einsum("bnc,bmc->bnm", do, v[:, j:j + block_k])
        if dense:
            dp = dp.to(torch.bfloat16).float()
        m_new = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        e = torch.exp2(s2 - m_new)
        l = l * corr + e.sum(dim=-1, keepdim=True)
        dl = dl * corr + (e * dp).sum(dim=-1, keepdim=True)
        m = m_new
    return m + torch.log2(l), dl / l


def _two_pass_delta(q, k, v, do, dense):
    """delta = rowsum(w dp) as the contracts' plain versions
    (``flash_attention_bwd_reference``, ``attention_dense_bwd_reference``)
    form it, from the full row."""
    scale = q.shape[-1] ** -0.5
    w = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k) * scale, dim=-1)
    dp = torch.einsum("bnc,bmc->bnm", do, v)
    if dense:
        dp = dp.to(torch.bfloat16).float()
    return (w * dp).sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("dense", [False, True], ids=["flash", "dense"])
@pytest.mark.parametrize("B,N,C", [(2, 1024, 128), (2, 256, 64)])
def test_online_delta_matches_the_plain_versions(B, N, C, dense):
    rng = np.random.RandomState(N + C)
    # bf16 inputs, as the kernel takes them, computed on in f32
    q, k, v, do = (torch.from_numpy(rng.randn(B, N, C).astype(np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    block_k = pfa.flash_bwd_launch_plan(B, N, C, torch.bfloat16)["rows"]["bk"]
    lse2, delta = _online_stats(q, k, v, do, block_k, dense)
    want = _two_pass_delta(q, k, v, do, dense)
    err = (delta - want).abs().max() / want.abs().max()
    assert err <= DELTA_TOL, err
    # in f32 the two contracts are one function (dp is rounded to v's
    # dtype): the gradient from the online statistics, w = exp2(s2 - lse2),
    # is the plain version's, which takes delta from the full row
    if dense:
        lse2, delta = _online_stats(q, k, v, do, block_k, False)
    scale = C ** -0.5
    s2 = torch.einsum("bnc,bmc->bnm", q, k) * scale * math.log2(math.e)
    ds = torch.exp2(s2 - lse2) * (
        torch.einsum("bnc,bmc->bnm", do, v) - delta) * scale
    plain = (pfa.attention_dense_bwd_reference if dense
             else pfa.flash_attention_bwd_reference)
    dq_want = plain(q, k, v, do)[0]
    dq = torch.einsum("bnm,bmc->bnc", ds, k)
    err = (dq - dq_want).abs().max() / dq_want.abs().max()
    assert err <= DELTA_TOL, err
