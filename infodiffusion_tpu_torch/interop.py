"""Move a Flax param tree into the port's modules.

The port's modules carry the Flax module names (``unet.downblock_0.norm1``,
``backbone.layer_3.linear`` ...), so the walk is mechanical. Three layout
rules cover every parameter:

- conv ``kernel`` [kh, kw, I, O] -> ``weight`` [O, I, kh, kw];
- Dense ``kernel`` [I, O] -> ``weight`` [O, I];
- norm ``scale`` -> ``weight``; every ``bias`` stays ``bias``.

A reference ``.pth`` checkpoint can later be loaded by composing
``infodiffusion_tpu/interop.py``'s key map with this function.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _convert(name: str, value) -> tuple:
    arr = np.asarray(value, dtype=np.float32)
    if name == "kernel" and arr.ndim == 4:
        return "weight", arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 2:
        return "weight", arr.T
    if name == "scale":
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise ValueError(f"no layout rule for a param {name!r} of shape "
                     f"{arr.shape}")


def to_state_dict(tree: Mapping) -> dict:
    """The port's ``state_dict`` names and layouts for ``tree`` (nested
    mappings of arrays, e.g. a Flax ``variables['params']`` subtree or a
    gradient tree of the same shape), as f32 tensors."""
    state = {}

    def walk(prefix: str, node: Mapping) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value)
            else:
                name, arr = _convert(key, value)
                state[prefix + name] = torch.tensor(arr)

    walk("", tree)
    return state


def from_jax_params(tree: Mapping, module: torch.nn.Module) -> torch.nn.Module:
    """Fill ``module``'s parameters from ``tree`` with
    ``load_state_dict(strict=True)``: every parameter on both sides must
    match by name and shape. Returns ``module``."""
    module.load_state_dict(to_state_dict(tree), strict=True)
    return module
