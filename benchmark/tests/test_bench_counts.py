"""The frozen FLOP and byte counts: the flagship's numbers as the port's
FLOP tool reported them, hand-worked values for one small shape, and the
count against the port's plain path at a tiny size."""

from __future__ import annotations

import pytest
import torch

from benchmark.counts import adagn, flops
from benchmark.reference.model import skeleton_plan

INFODIFF = {"model": "infodiff", "input_size": 64, "a_dim": 256, "T": 1000,
            "sampling_steps": 100,
            "arch": {"ch": 64, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 2,
                     "attn": [2]}}
VANILLA = dict(INFODIFF, model="vanilla",
               arch=dict(INFODIFF["arch"], ch_mult=[1, 2, 4, 8]))


def test_flagship_counts_as_frozen():
    # the port's tools/flops_report.py (PR 17): 14.753476 GFLOP a forward
    # sample, 78.473818 a train image at batch 128
    assert flops.forward_gflop(INFODIFF) == pytest.approx(14.753476, abs=5e-7)
    assert flops.train_gflop(INFODIFF, 128) == pytest.approx(78.473818,
                                                             abs=5e-7)


def test_valid_pairs_by_hand():
    # 4 pixels, 3 taps, padding 1: 2 + 3 + 3 + 2
    assert flops.valid_pairs(4) == 10
    # stride 2 over 4 pixels: outputs 0, 1 -> taps 2 + 3
    assert flops.valid_pairs(4, stride=2) == 5


def test_small_skeleton_by_hand():
    # one level, one block, no attention, ch 32, 4x4, 3 -> 3 channels,
    # unconditioned (the encoder's block: conv1 and conv2)
    arch = {"ch": 32, "ch_mult": [1], "num_res_blocks": 1, "attn": []}
    plan = skeleton_plan(32, [1], 1, [])
    assert [p[0] for p in plan] == ["down", "middle", "middle", "up", "up"]
    # the first middle block attends, whatever ``attn`` says
    assert [p[4] for p in plan] == [False, True, False, False, False]
    m = flops.skeleton_macs(arch, 4, 3, 3, 0, 0)
    taps = 10 * 10
    assert m["head"] == 3 * 32 * taps
    # down 32->32 (2 convs), two middle (2 each), two up 64->32 (conv1
    # 64->32, conv2 32->32, shortcut 64->32 over 16 pixels), tail 32->3
    convs = (2 + 2 + 2) * 32 * 32 * taps + 2 * (64 * 32 + 32 * 32) * taps
    assert m["conv"] == convs + 32 * 3 * taps
    # two shortcuts 64 -> 32 over 16 pixels, the middle attention's four
    # projections 32 -> 32 over 16 tokens, its two products 16 x 16 x 32
    assert m["dense"] == 2 * 64 * 32 * 16 + 4 * 32 * 32 * 16
    assert m["attn"] == 2 * 16 * 16 * 32


def test_adagn_bytes_by_hand():
    # C=64 at 8x8, batch 2, one FiLM, training
    site = (64, 8, 1)
    n = 2 * 8 * 8 * 64
    fwd = 2 * n * 2 + 2 * 64 * 4 + 2 * 2 * 64 * 2 + 2 * 32 * 2 * 4
    assert adagn.forward_bytes(site, 2, True) == fwd
    bwd = 3 * n * 2 + 2 * 32 * 2 * 4 + 64 * 4 + 2 * 64 * 2 + 2 * 64 * 4 \
        + 2 * 2 * 64 * 2
    assert adagn.backward_bytes(site, 2) == bwd


def test_adagn_sites_are_the_ports_launches():
    # the port launches K1 73 times a forward and 124 times a train step
    # (InfoDiff, encoder included; PERF.md's launch counts)
    assert len(adagn.sites(INFODIFF, False)) == 73
    assert len(adagn.sites(INFODIFF, True)) == 124
    assert len(adagn.sites(VANILLA, True)) == 73


TINY = {"model": "infodiff", "input_size": 16, "a_dim": 32, "T": 50,
        "sampling_steps": 5,
        "arch": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 2,
                 "attn": [1]}}


@pytest.mark.parametrize("model", ["infodiff", "vanilla"])
def test_counts_match_the_ports_plain_path(model):
    """At a tiny size, the arithmetic against FlopCounterMode over the
    port's plain forward and train step (the port's FLOP tool's own
    count, valid taps)."""
    from infodiffusion_tpu_torch.config import Config
    from infodiffusion_tpu_torch.models.wrappers import build_model
    from infodiffusion_tpu_torch.tools import flops_report as FR

    cfg = dict(TINY, model=model)
    pc = Config(model="diff" if model == "infodiff" else "vanilla",
                dataset="celeba", a_dim=32, diffusion_steps=50,
                ch_mult="1,2", attn="1", unets_channels=32,
                encoder_channels=32, input_size=16, input_channels=3)
    torch.manual_seed(0)
    net = build_model(pc, dtype=torch.float32, device="cpu")
    if model == "infodiff":
        fwd = FR.forward_counts(batch=4, size=16, model=net, a_dim=32)
        assert fwd["valid_taps"]["total"] == pytest.approx(
            flops.forward_gflop(cfg), rel=1e-12)
        train = FR.train_step_counts(batch=4, size=16, model=net, a_dim=32)
        assert train["valid_taps"]["total"] == pytest.approx(
            flops.train_gflop(cfg, 4), rel=1e-12)
    else:
        from torch.utils.flop_counter import FlopCounterMode  # noqa: F401

        x = torch.zeros(4, 16, 16, 3)
        t = torch.zeros(4, dtype=torch.long)

        def run():
            with torch.no_grad():
                net(x, t)

        got = FR.count(run, 4)["valid_taps"]["total"]
        assert got == pytest.approx(flops.forward_gflop(cfg), rel=1e-12)
