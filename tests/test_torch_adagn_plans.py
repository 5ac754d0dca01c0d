"""K1's launch plan (``ops/cuda/adagn.adagn_launch_plan``, the arithmetic
of ``csrc/adagn_common.cuh`` make_plan) at every GroupNorm site of every
path ``chip_smoke.py`` drives, forward and backward, f32 and bf16, at the
paths' batches, on a modelled card of 132 SMs: each site gets a plan that
fits a block's 227 KB of shared memory and a cluster of 16, the plan covers
every row once, and every site of a 64px (or smaller) model is resident in
bf16 (x read from HBM once; x and dy for the backward). The sites are
collected by hooks on one training forward of each model on the meta
device (shapes only, nothing computed) by ``tools/adagn_rate.gn_sites``,
as ``chip_smoke.py`` finds them on the card."""

import dataclasses

import pytest
import torch

from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.wrappers import VAE, InfoDiff, build_model
from infodiffusion_tpu_torch.ops.cuda.adagn import (
    MAX_C,
    adagn_launch_plan,
    adagn_threads,
)
from infodiffusion_tpu_torch.tools.adagn_rate import gn_sites

SMS, ACTIVE = 132, 7          # an H100 SXM; clusters of 16 it co-schedules
SMEM_LIMIT = 232448
META = torch.device("meta")


def _cfg(model, dataset="celeba", a_dim=256, size=None):
    cfg = Config(model=model, dataset=dataset, a_dim=a_dim,
                 diffusion_steps=1000).with_dataset_config()
    return dataclasses.replace(cfg, input_size=size) if size else cfg


def _model(path):
    """(model, cfg) of a path: the flagship InfoDiff at 64, 128 and 512px
    as the training runs build it, the others as ``build_model`` does."""
    kind, size = path
    if kind == "infodiff":
        cfg = _cfg("diff", size=size)
        return InfoDiff(T=1000, a_dim=256, shape=(3, size, size),
                        unets_channels=64, encoder_channels=64,
                        mmd_weight=0.1, epochs=50).to(META), cfg
    cfg = {"vanilla": _cfg("vanilla", size=size), "vae": _cfg("vae"),
           "mnist": _cfg("diff", "mnist", 32),
           "chairs": _cfg("diff", "chairs", 32)}[kind]
    return build_model(cfg, device=META), cfg


def _sites(path):
    """(HW, C, K) of every GroupNorm site one training forward hits."""
    model, cfg = _model(path)
    c, h, w = cfg.shape
    x = torch.zeros(1, h, w, c, device=META)
    z = lambda *s: torch.zeros(*s, device=META)  # noqa: E731
    t = torch.zeros(1, dtype=torch.long, device=META)
    if isinstance(model, VAE):
        return gn_sites(model, lambda: model(
            x, deterministic=True, reparam_eps=z(1, cfg.a_dim)))
    if isinstance(model, InfoDiff):
        return gn_sites(model, lambda: model.loss_fn(
            x, deterministic=True, t=t, eps=z(*x.shape),
            reparam_eps=z(1, cfg.a_dim), prior_samples=z(1, cfg.a_dim)))
    return gn_sites(model, lambda: model.loss_fn(
        x, deterministic=True, t=t, eps=z(*x.shape)))


# every path chip_smoke.py drives: (model, image size) and its batches
# (generation, training, card against CPU)
PATHS = {
    ("infodiff", 64): (1, 2, 128),
    ("infodiff", 128): (2, 64),
    ("infodiff", 512): (1, 4, 8),
    ("vanilla", 64): (2, 32, 64),
    ("vae", 64): (2, 64, 128),
    ("vanilla", 256): (4,),
    ("vanilla", 512): (2,),
    ("mnist", 32): (2, 64),
    ("chairs", 64): (64,),
}


@pytest.fixture(scope="module")
def sites():
    return {path: _sites(path) for path in PATHS}


def _check(plan, B, HW, C, dtype, backward):
    vpr = C // (8 if dtype == torch.bfloat16 else 4)
    assert plan["threads"] == adagn_threads(C, dtype) <= 256
    assert plan["threads"] % vpr == 0
    assert plan["lanes"] == plan["threads"] // vpr
    rows = plan["rows"]
    if plan["body"] == "resident":
        r = plan["ranks"]
        assert r in (1, 2, 4, 8, 16) and plan["splits"] == 1
        assert plan["smem"] <= SMEM_LIMIT
        assert r * rows >= HW > (r - 1) * rows  # every row once, no rank idle
        e = torch.finfo(dtype).bits // 8
        assert plan["smem"] > rows * C * e * (2 if backward else 1)
        assert plan["blocks"] == B * r
        assert plan["smem"] <= (233472 - 1024 * plan["per_sm"]) // plan[
            "per_sm"]
    else:
        assert plan["body"] == "stream" and plan["ranks"] == 1
        assert rows % plan["lanes"] == 0
        assert plan["splits"] * rows >= HW > (plan["splits"] - 1) * rows
        assert plan["smem"] <= 48 * 1024
        assert plan["splits"] <= 65535


@pytest.mark.parametrize("path", list(PATHS), ids=lambda p: f"{p[0]}{p[1]}")
@pytest.mark.parametrize("backward", [False, True])
def test_every_site_has_a_plan(sites, path, backward):
    assert sites[path], path
    for HW, C, K in sites[path]:
        for B in PATHS[path]:
            for dtype in (torch.float32, torch.bfloat16):
                plan = adagn_launch_plan(B, HW, C, K, dtype, SMS, ACTIVE,
                                         backward=backward)
                _check(plan, B, HW, C, dtype, backward)


@pytest.mark.parametrize("path", [p for p in PATHS if p[1] <= 64],
                         ids=lambda p: f"{p[0]}{p[1]}")
def test_every_64px_bf16_site_is_resident(sites, path):
    for HW, C, K in sites[path]:
        for backward in (False, True):
            plan = adagn_launch_plan(PATHS[path][-1], HW, C, K,
                                     torch.bfloat16, SMS, ACTIVE,
                                     backward=backward)
            assert plan["body"] == "resident", (path, HW, C, K, backward)


def test_flagship_plans():
    """The flagship's largest 64px elements: 4096 x 64 bf16 (512 KB) on 16
    ranks at four blocks an SM; 4096 x 192 bf16 (1.5 MB) on 16 at two;
    4096 x 192 f32 (3 MB) and the backward of 4096 x 192 bf16 (x and dy,
    3 MB) on 16 at one; the 512px level 0 streams at about 16 blocks an
    SM."""
    def plan(*shape, backward=False):
        return adagn_launch_plan(*shape, SMS, ACTIVE, backward=backward)

    p = plan(128, 4096, 64, 2, torch.bfloat16)
    assert (p["body"], p["ranks"], p["rows"], p["per_sm"]) == (
        "resident", 16, 256, 4)
    assert p["smem"] <= 57344
    p = plan(128, 4096, 192, 0, torch.bfloat16)
    assert (p["body"], p["ranks"], p["per_sm"]) == ("resident", 16, 2)
    for p in (plan(128, 4096, 192, 0, torch.float32),
              plan(128, 4096, 192, 0, torch.bfloat16, backward=True)):
        assert (p["body"], p["ranks"], p["per_sm"]) == ("resident", 16, 1)
        assert 115712 < p["smem"] <= SMEM_LIMIT
    p = plan(128, 64, 128, 0, torch.bfloat16)
    assert (p["body"], p["ranks"], p["per_sm"]) == ("resident", 1, 4)
    p = plan(4, 262144, 64, 2, torch.bfloat16)
    assert p["body"] == "stream"
    assert 8 * SMS <= p["blocks"] <= 32 * SMS


def test_no_cluster_of_16_without_the_card():
    """Where the card co-schedules no cluster of 16 the plan takes 8 ranks
    at most, and streams what they cannot hold."""
    p = adagn_launch_plan(128, 4096, 192, 0, torch.float32, SMS, 0)
    assert p["body"] == "stream"
    p = adagn_launch_plan(128, 4096, 64, 0, torch.bfloat16, SMS, 0)
    assert (p["body"], p["ranks"], p["per_sm"]) == ("resident", 8, 3)


@pytest.mark.parametrize("C", [32, 96, 192, 384, 640, 1024])
def test_threads_hold_whole_vectors_of_a_row(C):
    for dtype in (torch.float32, torch.bfloat16):
        vpr = C // (8 if dtype == torch.bfloat16 else 4)
        t = adagn_threads(C, dtype)
        assert t % vpr == 0 and vpr <= t <= 256
        if (32 * vpr) // __import__("math").gcd(vpr, 32) <= 256:
            assert t % 32 == 0


@pytest.mark.parametrize("C,G,HW", [(48, 16, 64), (2048, 32, 4), (64, 32, 0),
                                    (64, 24, 64)])
def test_plan_refuses_what_the_kernel_does_not_take(C, G, HW):
    assert C % 32 or C > MAX_C or HW < 1 or C % G
    with pytest.raises(ValueError, match="adagn kernel"):
        adagn_launch_plan(2, HW, C, 0, torch.float32, SMS, ACTIVE, groups=G)
