"""Helpers for the torch port's parity tests against the JAX package.

Both sides get the same numbers: inputs and params are made with numpy from
a seed, the JAX param tree is moved into the port with
``interop.from_jax_params`` (``load_state_dict(strict=True)``), and errors
are measured as max |got - want| over max |want|.
"""

from __future__ import annotations

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
