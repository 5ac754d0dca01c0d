"""Sequence-parallel attention routing under ``--sp``
(JAX counterpart: ``infodiffusion_tpu/parallel/sp.py``).

When an SP context is configured (``--sp N``, or ``sp_scope``),
``ops.attention.single_head_attention`` runs as ring attention over the
``seq`` group once the token count reaches ``INFODIFF_SP_MIN_TOKENS``
(default 1024: the attention grid at 128px and beyond). ``sp_route`` is
consulted before the flash route. A token count that does not divide the
group runs dense, with a warning. The context is process-global, so the
model code calls the same op either way.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

import torch.distributed as dist

from infodiffusion_tpu_torch.parallel.mesh import SEQ_AXIS

_STATE = {"group": None, "min_tokens": None}


def _default_min_tokens() -> int:
    return int(os.environ.get("INFODIFF_SP_MIN_TOKENS", "1024"))


def _group_of(mesh_or_group):
    if mesh_or_group is None:
        return None
    if hasattr(mesh_or_group, "get_group"):  # a DeviceMesh
        return mesh_or_group.get_group(SEQ_AXIS)
    return mesh_or_group


def configure_sp(mesh_or_group, min_tokens: Optional[int] = None) -> None:
    """Set (a ``seq`` DeviceMesh or a process group) or clear (None) the
    SP context."""
    _STATE["group"] = _group_of(mesh_or_group)
    _STATE["min_tokens"] = min_tokens


@contextlib.contextmanager
def sp_scope(mesh_or_group, min_tokens: Optional[int] = None):
    prev = dict(_STATE)
    configure_sp(mesh_or_group, min_tokens)
    try:
        yield
    finally:
        _STATE.update(prev)


def sp_route(n_tokens: int):
    """The ``seq`` group when ring attention should take an
    ``n_tokens`` attention, else None."""
    group = _STATE["group"]
    if group is None:
        return None
    mt = _STATE["min_tokens"]
    if mt is None:
        mt = _default_min_tokens()
    if n_tokens < mt:
        return None
    size = dist.get_world_size(group)
    if n_tokens % size:
        warnings.warn(
            f"sequence-parallel attention skipped: {n_tokens} tokens do "
            f"not divide the {size}-way '{SEQ_AXIS}' group — falling back "
            "to dense attention", stacklevel=3)
        return None
    return group
