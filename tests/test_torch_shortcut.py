"""K6, the fused residual + 1x1 shortcut epilogue, held against the JAX
package: the plain version against ``fused_shortcut_add`` in interpret
mode (1 and 2 pieces, f32 and bf16), the route through ``ShortcutDense``
with the gate forced on the CPU (an up block's pieces reach the kernel's
plain version unconcatenated), and the ``autograd.Function``'s gradient
against autograd of the plain version.

Tolerances: the plain version against the Pallas kernel to 1e-5 of max abs
in f32 (summation order) and 1e-2 in bf16 (the output's one rounding);
blocks and models to FORWARD_TOL (tests/torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.nn.blocks import ResBlock as JResBlock
from infodiffusion_tpu.ops.pallas.shortcut_fused import fused_shortcut_add
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.nn.blocks import ResBlock
from infodiffusion_tpu_torch.ops.cuda import shortcut_fused as K6
from torch_parity import (
    FORWARD_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    rngs,
    tensor,
)

torch.set_num_threads(2)

PLAIN_TOL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("cs,n", [((16,), 32), ((64, 32), 32)])
def test_plain_matches_pallas(cs, n, tag):
    jdt, tdt = DTYPES[tag]
    rng = np.random.RandomState(len(cs) + n)
    B, H, W = 2, 16, 16  # M = 512 rows: the Pallas kernel tiles them
    h = rng.randn(B, H, W, n).astype(np.float32)
    pieces = [rng.randn(B, H, W, c).astype(np.float32) for c in cs]
    kernel = (rng.randn(sum(cs), n) / np.sqrt(sum(cs))).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    want = fused_shortcut_add(
        jnp.asarray(h, jdt), [jnp.asarray(p, jdt) for p in pieces],
        jnp.asarray(kernel), jnp.asarray(bias), interpret=True)
    got = K6.shortcut_fused_reference(
        tensor(h).to(tdt), [tensor(p).to(tdt) for p in pieces],
        tensor(kernel.T), tensor(bias))
    assert got.dtype == tdt
    assert_close(got.float(), np.asarray(want, np.float32), PLAIN_TOL[tag],
                 f"K6 plain {tag}")


def test_gate_and_routes(monkeypatch):
    assert K6.fused_shortcut_supported([64], 32)
    assert K6.fused_shortcut_supported([512, 512], 512)
    assert not K6.fused_shortcut_supported([64], 36)
    assert not K6.fused_shortcut_supported([64, 12], 32)
    assert not K6.fused_shortcut_supported([8, 8, 8], 32)
    x = torch.zeros(1)
    for var in ("INFODIFF_ENABLE_FUSED_SHORTCUT",
                "INFODIFF_FORCE_FUSED_SHORTCUT", "INFODIFF_DISABLE_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    assert not K6.use_fused_shortcut(x)
    monkeypatch.setenv("INFODIFF_ENABLE_FUSED_SHORTCUT", "1")
    assert not K6.use_fused_shortcut(x)  # a CPU tensor: the default route
    monkeypatch.setenv("INFODIFF_FORCE_FUSED_SHORTCUT", "1")
    assert K6.use_fused_shortcut(x)
    monkeypatch.setenv("INFODIFF_DISABLE_PALLAS", "1")
    assert not K6.use_fused_shortcut(x)
    # the kernel's wrapper takes CUDA tensors only: it never runs plain
    with pytest.raises(ValueError, match="CUDA"):
        K6.shortcut_fused_cuda(torch.zeros(4, 8), [torch.zeros(4, 8)],
                               torch.zeros(8, 8), torch.zeros(8))


@pytest.mark.parametrize("up", [False, True])
def test_resblock_on_the_fused_route(up, monkeypatch):
    """A ResBlock whose channel count changes, as a down block (one piece)
    and as an up block (the pieces (h, skip)), with the K6 route forced:
    equal to the JAX block, and the plain K6 ran on the pieces."""
    rng = np.random.RandomState(11)
    temb = rng.randn(2, 16).astype(np.float32)
    xs = ([rng.randn(2, 8, 8, 32).astype(np.float32),
           rng.randn(2, 8, 8, 64).astype(np.float32)] if up
          else [rng.randn(2, 8, 8, 32).astype(np.float32)])
    jm = JResBlock(out_ch=64)
    jx = tuple(jnp.asarray(x) for x in xs) if up else jnp.asarray(xs[0])
    params = randomize(jax.jit(lambda: jm.init(rngs(), jx, temb))()["params"],
                       seed=12)
    want = jm.apply({"params": params}, jx, temb)
    pm = port(ResBlock(sum(x.shape[-1] for x in xs), 64, 16,
                       skip_concat=up), params)
    seen = []
    plain = K6.shortcut_fused_reference

    def counting(h, pieces, weight, bias):
        seen.append([p.shape[-1] for p in pieces])
        return plain(h, pieces, weight, bias)

    monkeypatch.setattr(K6, "shortcut_fused_reference", counting)
    monkeypatch.setenv("INFODIFF_FORCE_FUSED_SHORTCUT", "1")
    arg = tuple(_nchw(x) for x in xs) if up else _nchw(xs[0])
    got = pm(arg, tensor(temb)).permute(0, 2, 3, 1)
    assert seen == [[x.shape[-1] for x in xs]]
    assert_close(got, want, FORWARD_TOL, "ResBlock, K6 route")


def test_function_gradient_matches_autograd():
    g = torch.Generator().manual_seed(13)
    h = torch.randn(2, 4, 4, 16, generator=g)
    pieces = [torch.randn(2, 4, 4, c, generator=g) for c in (24, 8)]
    weight = torch.randn(16, 32, generator=g) / 6
    bias = torch.randn(16, generator=g)
    w = torch.randn(2, 4, 4, 16, generator=g)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True)
                  for t in (h, *pieces, weight, bias)]
        out = fn(leaves[0], leaves[1:3], leaves[3], leaves[4])
        return torch.autograd.grad((out * w).sum(), leaves)

    got = grads(K6.fused_shortcut_add)
    want = grads(K6.shortcut_fused_reference)
    for name, a, b in zip(("h", "p0", "p1", "weight", "bias"), got, want):
        assert_close(a, b.numpy(), 1e-5, f"d{name}")


def test_vanilla_model_gradients_on_both_routes(monkeypatch):
    """The vanilla Diff's loss and every parameter gradient agree between
    the default route and the K6 route (f32, injected draws)."""
    kw = dict(T=10, shape=(3, 16, 16), unets_channels=32, ch_mult=(1, 2),
              attn=(1,), num_res_blocks=1)
    rng = np.random.RandomState(14)
    x = tensor(rng.randn(2, 16, 16, 3).astype(np.float32))
    eps = tensor(rng.randn(2, 16, 16, 3).astype(np.float32))
    t = torch.tensor([2, 7])
    jm = JDiff(**kw)
    params = randomize(init_variables(
        jm, np.zeros((1, 16, 16, 3), np.float32),
        np.zeros(1, np.int32))["params"], seed=15)
    model = port(Diff(**kw), params)
    out = {}
    for route in ("default", "k6"):
        if route == "k6":
            monkeypatch.setenv("INFODIFF_FORCE_FUSED_SHORTCUT", "1")
        model.zero_grad()
        loss, _ = model.loss_fn(x, deterministic=True, t=t, eps=eps)
        loss.backward()
        out[route] = (loss.item(), {n: p.grad.clone()
                                    for n, p in model.named_parameters()})
    assert abs(out["k6"][0] - out["default"][0]) <= 1e-6 * out["default"][0]
    # leaves that are analytically zero (a conv bias under a GroupNorm)
    # hold f32 noise: each leaf's error is over its max abs, floored at
    # 1e-4 of the largest leaf's
    want = out["default"][1]
    floor = 1e-4 * max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        err = (out["k6"][1][name] - g).abs().max().item()
        assert err <= FORWARD_TOL * max(g.abs().max().item(), floor), name
