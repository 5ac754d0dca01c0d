"""The device mesh (JAX counterpart: ``infodiffusion_tpu/parallel/mesh.py``).

A ``(data, model)`` ``DeviceMesh`` over the ranks of the process group:
batches split over ``data`` (global-batch semantics: the MMD couples the
whole batch, so the loss is written over the global batch and the
``[B, a_dim]`` latents are gathered, ``parallel/batch.py``), weights
over ``model`` under ``--tp``. One rank is one device, so the mesh spans
the whole world: ``--mesh_devices`` must equal the world size. Rank
``r`` sits at data index ``r // tp`` and model index ``r % tp``, the JAX
mesh's device order (``devices.reshape(n // tp, tp)``).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from infodiffusion_tpu_torch.parallel import multihost

DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"
SEQ_AXIS = "seq"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1):
    """The ``(data, model)`` DeviceMesh over the world's ``n_devices``
    ranks (default: all). Raises, as the JAX mesh does, when the mesh wants
    more devices than the world has or ``--tp`` does not divide it, and
    also when it wants fewer (a rank outside the mesh would have no work)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = multihost.world_size()
    n = world if n_devices is None else n_devices
    if n < 1 or n > world:
        raise ValueError(f"mesh wants {n} devices but only {world} are "
                         f"available (--mesh_devices)")
    if n != world:
        raise ValueError(f"--mesh_devices {n} must equal the world size "
                         f"{world}: the port runs one process a device")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"tensor-parallel size {model_parallel} (--tp) must "
                         f"divide the mesh device count {n}")
    return init_device_mesh(_device_type(), (n // model_parallel,
                                             model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def make_1d_mesh(n: int, axis: str):
    """A one-axis mesh over all ``n`` ranks (the ``stage`` and ``seq``
    layouts own every device)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = multihost.world_size()
    if n != world:
        raise ValueError(f"'{axis}' mesh wants {n} devices but the world "
                         f"has {world}")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis`` (None when it is absent
    or one wide)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def shard_batch(mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch (its data index's block)."""
    rows = multihost.local_row_indices(axis_size(mesh, DATA_AXIS),
                                       axis_index(mesh, DATA_AXIS),
                                       batch.shape[0])
    return batch[int(rows[0]):int(rows[-1]) + 1]


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Broadcast every tensor from rank ``src`` in place (parameters made
    from one seed agree already; this makes it so whatever made them)."""
    if multihost.world_size() > 1:
        for t in tensors:
            dist.broadcast(t.data, src)
