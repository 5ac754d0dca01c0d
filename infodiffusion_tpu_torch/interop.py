"""Move weights between the port's modules, Flax param trees and the
reference's torch checkpoints.

The port's modules carry the Flax module names (``unet.downblock_0.norm1``,
``backbone.layer_3.linear`` ...), so the walk from a Flax tree is
mechanical. Four layout rules cover every parameter:

- conv ``kernel`` [kh, kw, I, O] -> ``weight`` [O, I, kh, kw];
- 1-D conv ``kernel`` [k, I, O] -> ``weight`` [O, I, k];
- Dense ``kernel`` [I, O] -> ``weight`` [O, I];
- norm ``scale`` -> ``weight``; every ``bias`` stays ``bias``.

``from_jax_quant`` carries the int8 tier's calibrated quant collection
the same way.

The reference's ``torch.save(model.state_dict())`` checkpoints
(``model-{epoch}.pth``) name parameters after its own module tree
(models.py, modules.py). ``reference_key_map(model)`` gives, for every
name of the port's ``state_dict``, the reference's key and one of two
layouts ("same" where the tensors agree as they are):

- ``"conv1x1"``: the reference's 1x1 conv [O, I, 1, 1] is the port's Dense
  [O, I] (the ResBlock shortcuts and the attention projections);
- ``"fc_a_rows"``: the VAE Decoder's ``fc_a``, whose output the reference
  reshapes to NCHW and the port to NHWC, so its rows are permuted.

The reference's ModuleLists are reproduced index for index, with
``num_res_blocks`` read from the model (the down path puts a DownSample
after every ``num_res_blocks`` blocks, the up path an UpSample after every
``num_res_blocks + 1``; models.py:16-46). The frozen sinusoid table
(``timembedding.0.weight``) is recomputed, not loaded, and the
AuxResBlock's dead ``crossattn.*`` parameters (modules.py:300) are not
built: both are ignored on load and left out on export.
``load_torch_state_dict``, ``export_torch_state_dict`` and
``load_torch_checkpoint`` move the weights.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch


def _convert(name: str, value) -> tuple:
    arr = np.asarray(value, dtype=np.float32)
    if name == "kernel" and arr.ndim == 4:
        return "weight", arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 3:
        return "weight", arr.transpose(2, 1, 0)
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


def flax_param_tree(module: torch.nn.Module, leaf) -> dict:
    """The Flax params tree of ``module`` (the layout rules run backwards),
    each leaf ``leaf(shape)`` for its Flax shape: the tree's structure
    without tracing the Flax model's init."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, key = name.split(".")
        shape = tuple(p.shape)
        if key == "weight":
            key, shape = (("scale", shape) if len(shape) == 1 else
                          ("kernel", shape[2:] + shape[1::-1]))
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[key] = leaf(shape)
    return tree


def from_jax_quant(tree: Mapping, module: torch.nn.Module) -> torch.nn.Module:
    """Carry a Flax ``variables['quant']`` tree (the turbo tier's calibrated
    ``act_absmax`` entries, int8x's ``x_absmax`` and the ``fused_qconv``
    markers) into ``module``'s quant state, as :func:`from_jax_params`
    carries params. Strict: the tree's ``act_absmax`` entries are exactly
    the module's quantized convs (as ``INFODIFF_SUBPIXEL_UPSAMPLE`` now
    sets them), an ``x_absmax`` tree has one under every ResBlock's ``xq``,
    every marker lands on a norm that can hold one, and every shape
    matches. The module's earlier quant state is dropped. Returns
    ``module``."""
    from infodiffusion_tpu_torch.ops import quant as q8

    flat = {}

    def walk(prefix: str, node: Mapping) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value)
            else:
                flat[prefix + key] = np.asarray(value, dtype=np.float32)

    walk("", tree)
    sites = q8.quant_sites(module)
    want = {k for k in sites if k.endswith("act_absmax")}
    if any(k.endswith("x_absmax") for k in flat):  # the int8x tier
        want |= {k for k in sites if k.endswith("x_absmax")}
    missing = sorted(want - set(flat))
    unexpected = sorted(set(flat) - set(sites))
    if missing or unexpected:
        raise ValueError(f"quant tree does not match the module: missing "
                         f"{missing}, unexpected {unexpected}")
    for name, arr in flat.items():
        if arr.shape != sites[name]:
            raise ValueError(f"{name}: shape {arr.shape}, the module's site "
                             f"has {sites[name]}")
    q8.load_quant_state(module, {k: torch.tensor(v) for k, v in flat.items()})
    return module


# ---------------------------------------------------------------------------
# the reference's torch checkpoints
# ---------------------------------------------------------------------------

# the ResBlocks' convs and norms in the reference's Sequentials; the
# EncoderResBlock's conv1 / conv2 sit in the same slots
# (reference: modules.py:206-366)
_CONV_NAMES = {"conv1": "block1.2", "conv2": "block2.3", "conv3": "block3.3"}
_NORM_NAMES = {"norm1": "block1.0", "norm2": "block2.0", "norm3": "block3.0"}
# keys the reference saves and the port does not build
_DEAD_KEYS = ("crossattn", "timembedding.0")


def _skeleton_index(name: str, levels: int, nrb: int) -> str:
    """The reference's ModuleList entry of one of the skeleton's modules:
    ``downblock_N`` / ``middleblock_N`` / ``upblock_N`` (one running
    counter) or ``down_i`` / ``up_i`` (level i), ``head``, ``tail_norm``,
    ``tail_conv`` (reference: models.py:16-46)."""
    fixed = {"head": "head", "tail_norm": "tail.0", "tail_conv": "tail.2"}
    if name in fixed:
        return fixed[name]
    kind, n = re.fullmatch(r"(downblock|middleblock|upblock|down|up)_(\d+)",
                           name).groups()
    n = int(n)
    first_middle = levels * nrb
    if kind == "downblock":
        return f"downblocks.{(n // nrb) * (nrb + 1) + n % nrb}"
    if kind == "down":
        return f"downblocks.{n * (nrb + 1) + nrb}"
    if kind == "middleblock":
        return f"middleblocks.{n - first_middle}"
    if kind == "upblock":
        pos = n - first_middle - 2
        return f"upblocks.{(pos // (nrb + 1)) * (nrb + 2) + pos % (nrb + 1)}"
    # up_i is made for i = levels-1 .. 1, each after its level's blocks
    return f"upblocks.{(levels - 1 - n) * (nrb + 2) + nrb + 1}"


def _unet_entry(parts, skeleton, bottleneck: bool, decoder: bool):
    """(reference key, layout) of one name below a UNet-carrying module
    (the backbone, the Encoder or the Decoder), ``parts`` split on '.'."""
    head, leaf = parts[0], parts[-1]
    if head == "time_embedding":
        idx = {"dense0": 1, "dense1": 3}[parts[1]]
        return f"time_embedding.timembedding.{idx}.{leaf}", "same"
    if head == "fc_a":
        if decoder:
            return f"fc_a.{leaf}", "fc_a_rows"
        # the bottleneck's fc_a is Sequential(SiLU, Linear)
        return f"{'fc_a.1' if bottleneck else 'fc_a'}.{leaf}", "same"
    if head in ("fc_mu", "fc_var"):
        return f"{head}.{leaf}", "same"
    if head != "unet":
        raise KeyError(".".join(parts))
    mod = _skeleton_index(parts[1], skeleton.levels, skeleton.num_res_blocks)
    rest = parts[2:-1]
    if not rest:  # head, tail_norm, tail_conv
        return f"{mod}.{leaf}", "same"
    name = rest[0]
    if rest == ["conv"]:  # DownSample / UpSample
        return f"{mod}.main.{leaf}", "same"
    if name in _CONV_NAMES:
        return f"{mod}.{_CONV_NAMES[name]}.{leaf}", "same"
    if name in _NORM_NAMES:
        return f"{mod}.{_NORM_NAMES[name]}.{leaf}", "same"
    if name in ("temb_proj", "aemb_proj"):  # Sequential(SiLU, Linear)
        return f"{mod}.{name}.1.{leaf}", "same"
    # the 1x1 convs: the shortcut and the attention projections
    conv1x1 = "conv1x1" if leaf == "weight" else "same"
    if name == "shortcut":
        return f"{mod}.shortcut.{leaf}", conv1x1
    if name == "attn":
        layout = "same" if rest[1] == "group_norm" else conv1x1
        return f"{mod}.attn.{rest[1]}.{leaf}", layout
    raise KeyError(".".join(parts))


def _latent_entry(parts):
    """(reference key, layout) of one LatentUNet name: ``time_embed_k`` is
    entry 2k of Sequential(Linear, SiLU, Linear), ``layer_i`` is
    ``layers.i``."""
    m = re.fullmatch(r"time_embed_(\d)", parts[0])
    if m:
        return f"time_embed.{2 * int(m.group(1))}.{parts[-1]}", "same"
    m = re.fullmatch(r"layer_(\d+)", parts[0])
    if m:
        return f"layers.{m.group(1)}.{'.'.join(parts[1:])}", "same"
    raise KeyError(".".join(parts))


def reference_key_map(model: torch.nn.Module) -> Dict[str, Tuple[str, str]]:
    """Each name of ``model.state_dict()`` -> (the reference checkpoint's
    key, layout): an ``InfoDiff`` (either backbone), a ``Diff`` (the UNet
    or the LatentUNet) or a ``VAE``."""
    from infodiffusion_tpu_torch.models.latent_unet import LatentUNet
    from infodiffusion_tpu_torch.models.unet import BottleneckAuxUNet

    out = {}
    for name in model.state_dict():
        top, *parts = name.split(".")
        sub = getattr(model, top)
        if isinstance(sub, LatentUNet):
            key, layout = _latent_entry(parts)
        else:
            key, layout = _unet_entry(
                parts, sub.unet, isinstance(sub, BottleneckAuxUNet),
                decoder=top == "decoder")
        out[name] = (f"{top}.{key}", layout)
    return out


def _fc_a_rows(shape) -> torch.Tensor:
    """The Decoder's fc_a row order: port row (h, w, c) is reference row
    (c, h, w)."""
    c, h, w = shape
    rows = torch.arange(c * h * w).reshape(c, h, w)
    return rows.permute(1, 2, 0).reshape(-1)


def _to_port(layout: str, t: torch.Tensor, model) -> torch.Tensor:
    if layout == "conv1x1":
        return t[:, :, 0, 0]
    if layout == "fc_a_rows":
        return t[_fc_a_rows(model.decoder.shape)]
    return t


def _to_reference(layout: str, t: torch.Tensor, model) -> torch.Tensor:
    if layout == "conv1x1":
        return t[:, :, None, None]
    if layout == "fc_a_rows":
        out = torch.empty_like(t)
        out[_fc_a_rows(model.decoder.shape)] = t
        return out
    return t


def _cpu_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def load_torch_state_dict(model: torch.nn.Module, state_dict: Mapping,
                          strict: bool = False) -> torch.nn.Module:
    """Fill ``model``'s parameters from a reference ``state_dict``
    (tensors or numpy arrays). A key the port needs and the checkpoint
    lacks always raises; ``strict=True`` also raises on keys left over,
    except the dead ``crossattn.*`` and ``timembedding.0`` entries
    (``strict=False`` is the reference's own eval-time load, run.py:233).
    The loaded values are copies: nothing aliases the source's storage.
    Returns ``model``."""
    kmap = reference_key_map(model)
    missing = sorted(key for key, _ in kmap.values() if key not in state_dict)
    if missing:
        raise KeyError(f"the torch checkpoint lacks {len(missing)} keys: "
                       f"{missing[:8]}")
    if strict:
        used = {key for key, _ in kmap.values()}
        extra = sorted(k for k in state_dict if k not in used
                       and not any(d in k for d in _DEAD_KEYS))
        if extra:
            raise KeyError(f"unused torch keys: {extra[:8]}")
    own = model.state_dict()
    new = {}
    for name, (key, layout) in kmap.items():
        t = _to_port(layout, _cpu_tensor(state_dict[key]), model)
        if t.shape != own[name].shape:
            raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} "
                             f"against the port's {name} "
                             f"{tuple(own[name].shape)}")
        new[name] = t
    # load_state_dict copies into the parameters' own storage
    model.load_state_dict(new, strict=True)
    return model


def export_torch_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters as a reference-shaped ``state_dict`` of CPU
    tensors (no dead keys), loadable by the reference's run.py."""
    kmap = reference_key_map(model)
    out = {}
    for name, value in model.state_dict().items():
        key, layout = kmap[name]
        t = _to_reference(layout, value.detach().cpu(), model)
        out[key] = t.clone(memory_format=torch.contiguous_format)
    return out


def load_torch_checkpoint(model: torch.nn.Module, path: str,
                          strict: bool = False) -> torch.nn.Module:
    """Load a reference ``model-{epoch}.pth`` into ``model``."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return load_torch_state_dict(model, state_dict, strict=strict)
