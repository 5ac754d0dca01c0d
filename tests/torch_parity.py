"""Helpers for the torch port's parity tests against the JAX package.

Both sides get the same numbers: inputs and params are made with numpy from
a seed, the JAX param tree is moved into the port with
``interop.from_jax_params`` (``load_state_dict(strict=True)``), and errors
are measured as max |got - want| over max |want|.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

from infodiffusion_tpu_torch.interop import from_jax_params

# The bars the JAX package held against the torch reference, f32 on the CPU
# (ROADMAP.md): single ops and forwards agree to 5e-4 of the output's max
# abs (f32 reassociation only); whole trajectories to 2e-3 (the same
# rounding differences, compounded over the steps).
OP_TOL = 5e-4
FORWARD_TOL = 5e-4
TRAJECTORY_TOL = 2e-3


def rngs():
    return {"params": jr.PRNGKey(0), "noise": jr.PRNGKey(1),
            "reparam": jr.PRNGKey(2), "dropout": jr.PRNGKey(3)}


def init_variables(model, *args, **kwargs):
    """Flax variables of ``model`` for example inputs (numpy arrays)."""
    args = [jnp.asarray(a) for a in args]
    return jax.jit(lambda: model.init(rngs(), *args, **kwargs))()


def randomize(tree: Mapping, seed: int) -> dict:
    """The same tree with every leaf redrawn from a numpy seed: kernels at
    1/sqrt(fan_in) scale, norm scales around 1, biases around 0, so no
    parameter sits at an init value that could hide a wiring fault."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            value = node[key]
            if isinstance(value, Mapping):
                out[key] = walk(value)
                continue
            shape = np.shape(value)
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.randn(*shape) / np.sqrt(fan_in)
            elif key == "scale":
                arr = 1.0 + 0.1 * rng.randn(*shape)
            else:
                arr = 0.1 * rng.randn(*shape)
            out[key] = arr.astype(np.float32)
        return out

    return walk(tree)


def port(module: torch.nn.Module, tree: Mapping) -> torch.nn.Module:
    return from_jax_params(tree, module).eval()


def tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def assert_close(got, want, tol: float, what: str = "") -> None:
    err = rel_err(got, want)
    assert err <= tol, f"{what}: relative max error {err:.3g} > {tol:.3g}"


# The int8 tiers: a port forward fed JAX's quant collection differs from
# JAX's where an f32 rounding difference lands a value on a .5 boundary and
# flips one int8 unit. From a flip on, every later quantized input rounds a
# slightly different tensor, and int8 rounding turns an error e of a tensor
# into ~sqrt(e * step): one flip carries a tiny UNet's output 2e-2 - 5e-2
# (relative L2) off JAX's (the int8 and int8x forwards of
# tests/test_torch_int8x.py's model over six seeds: 0 or 1.9e-2 - 4.9e-2).
# :func:`int8_flipped` grants that bar only where it finds such a flip.
CASCADE_TOL = 0.1
# what a rounding flip is: every quantizer input up to the first s8
# difference within FLIP_INPUT_TOL of JAX's (max abs over max abs), and
# there at most FLIP_MAX units, each +-1, each with its input x within
# FLIP_ULPS f32 ulps (of the tensor's max abs) of s times the .5 boundary
# between the two values, on both sides
FLIP_INPUT_TOL = 1e-5
FLIP_MAX = 4
FLIP_ULPS = 1


@contextlib.contextmanager
def _quantizer_calls(module, record):
    """Record each call of ``module``'s ``quantize_act`` and
    ``quantize_x_pieces`` (the JAX package's or the port's quant module)
    in ``record``, in call order, as a list of (x f32, scale f32, q int8)
    numpy triples, one a piece."""
    act, pieces = module.quantize_act, module.quantize_x_pieces

    def spy_act(x, absmax):
        q, s = act(x, absmax)
        record.append([(np.array(x, np.float32), np.array(s, np.float32),
                        np.array(q))])
        return q, s

    def spy_pieces(ps, absmax):
        qs, s = pieces(ps, absmax)
        record.append([(np.array(p, np.float32), np.array(s[i], np.float32),
                        np.array(q)) for i, (p, q) in enumerate(zip(ps, qs))])
        return qs, s

    module.quantize_act, module.quantize_x_pieces = spy_act, spy_pieces
    try:
        yield
    finally:
        module.quantize_act, module.quantize_x_pieces = act, pieces


def _as_jax(arr, shape):
    """A port array in the JAX layout ``shape``: as it is, or NCHW moved to
    NHWC (the port's block views are NCHW); None if neither fits."""
    if arr.shape == shape:
        return arr
    if arr.ndim == 4 and arr.transpose(0, 2, 3, 1).shape == shape:
        return arr.transpose(0, 2, 3, 1)
    return None


def int8_flipped(model: torch.nn.Module, jmodel, jvars, args) -> bool:
    """Whether an int8 unit flipped, for a rounding reason, between the
    port's forward of ``model`` (its quant state installed) and JAX's
    ``jmodel.apply(jvars, *args)`` on the same numpy ``args`` (int32 arrays
    go in as longs). Both forwards' quantizer calls are compared in order:
    False when every s8 value is equal; True when the first difference is
    a rounding flip (see ``FLIP_*``: inputs that agree, a few +-1 units at
    values on a .5 boundary); an AssertionError naming the call otherwise
    (inputs that disagree before any flip, or a difference that rounding
    does not explain), since that is a fault of the port."""
    from infodiffusion_tpu.ops import quant as jq
    from infodiffusion_tpu_torch.ops import quant as pq

    want, got = [], []
    with _quantizer_calls(jq, want):
        jmodel.apply(jvars, *args)
    with _quantizer_calls(pq, got), torch.no_grad():
        model(*(tensor(v).long() if v.dtype == np.int32 else tensor(v)
                for v in args))
    assert len(got) == len(want), (
        f"{len(got)} quantizer calls in the port's forward, JAX {len(want)}")
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"call {k}: {len(g)} pieces, JAX {len(w)}"
        for i, ((gx, gs, gq), (wx, ws, wq)) in enumerate(zip(g, w)):
            where = f"quantizer call {k} piece {i}"
            gx, gq = _as_jax(gx, wx.shape), _as_jax(gq, wq.shape)
            assert gx is not None, f"{where}: shape {g[i][0].shape}, JAX " \
                f"{wx.shape}"
            err = rel_err(gx, wx)
            assert err <= FLIP_INPUT_TOL, (
                f"{where}: input {err:.3g} off JAX's before any flip")
            assert np.array_equal(gs, ws), f"{where}: scale {gs} != {ws}"
            diff = gq != wq
            if not diff.any():
                continue
            units = gq[diff].astype(np.int32) - wq[diff].astype(np.int32)
            boundary = (gq[diff].astype(np.float32)
                        + wq[diff].astype(np.float32)) / 2
            # how far each side's input lies from the boundary, in ulps of
            # the tensor's max abs (the scale of its f32 rounding)
            ulps = max(np.max(np.abs(x[diff] - boundary * s))
                       / np.spacing(np.max(np.abs(x)))
                       for x, s in ((gx, gs), (wx, ws)))
            assert (diff.sum() <= FLIP_MAX and np.all(np.abs(units) == 1)
                    and ulps <= FLIP_ULPS), (
                f"{where}: {int(diff.sum())} s8 values differ from JAX's "
                f"(units {sorted(set(units.tolist()))}, up to {ulps:.3g} "
                f"ulps from a .5 boundary): not a rounding flip")
            return True
    return False
