"""Process-group start, per-rank rows of the global batch, and the
collectives the runner needs across processes
(JAX counterpart: ``infodiffusion_tpu/parallel/multihost.py``).

The JAX package runs one Python process per host, each driving all of its
local chips; a process there owns several devices, and multi-host means
several such processes. The port runs **one process per device**
(``torchrun`` starts one per GPU, each pinned to ``LOCAL_RANK``), so every
run with more than one device is a multi-process run, on one node or many:

1. ``maybe_initialize`` starts ``torch.distributed`` when ``--multihost``,
   ``INFODIFF_MULTIHOST=1`` or torchrun's environment (``RANK``,
   ``WORLD_SIZE``, ``MASTER_ADDR``) asks for it: NCCL on the card, gloo on
   the CPU under ``INFODIFF_FORCE_CPU=1``;
2. every rank draws the same shuffled order and flips from ``--r_seed``
   and assembles only its ``local_row_indices`` of each global batch; over
   the ranks of one data row of the mesh the union is the global batch;
3. the train step reduces the gradients over the data group itself
   (``parallel/layout.py``), where XLA inserts the all-reduce in JAX.

``agree_on_preemption`` and ``process_allgather`` are collectives: every
rank calls them at the same points.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def wants_distributed(multihost: bool = False) -> bool:
    """Whether this run is asked to join a process group."""
    return bool(
        multihost
        or os.environ.get("INFODIFF_MULTIHOST") == "1"
        or all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    )


def backend() -> str:
    """NCCL for the card; gloo for the CPU (``INFODIFF_FORCE_CPU=1``)."""
    return "gloo" if os.environ.get("INFODIFF_FORCE_CPU") else "nccl"


def maybe_initialize(multihost: bool = False) -> bool:
    """Start the default process group when asked (see
    :func:`wants_distributed`); a no-op when one is up already or none is
    asked for. Under NCCL each rank first takes the card ``LOCAL_RANK``
    names, and a rank that sees no card raises. Returns whether a group is
    up."""
    if dist.is_initialized():
        return True
    if not wants_distributed(multihost):
        return False
    kind = backend()
    if kind == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this rank sees no CUDA device; the port's ranks run on "
                "the card (INFODIFF_FORCE_CPU=1 runs them on the CPU over "
                "gloo)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(kind, timeout=TIMEOUT)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def local_row_indices(data_width: int, data_index: int,
                      global_batch: int) -> np.ndarray:
    """The rows of a ``global_batch``-row batch that data index
    ``data_index`` of a ``data_width``-wide data axis owns: one contiguous
    block each, in rank order, as JAX's ``P('data')`` sharding places them.
    Over the data indices these partition ``range(global_batch)``."""
    if data_width < 1 or not 0 <= data_index < data_width:
        raise ValueError(f"data index {data_index} of a {data_width}-wide "
                         f"data axis")
    if global_batch % data_width:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"the {data_width}-wide data axis")
    n = global_batch // data_width
    return np.arange(data_index * n, (data_index + 1) * n)


def _collective_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_allgather(x) -> np.ndarray:
    """Every rank's array, stacked on a new leading axis in rank order;
    the array itself (no new axis) in a one-process run."""
    x = np.asarray(x)
    if world_size() == 1:
        return x
    t = torch.as_tensor(x).to(_collective_device())
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def agree_on_preemption(local_flag: bool) -> bool:
    """True iff any rank saw the preemption signal: an ``all_reduce(MAX)``
    of the flag, which every rank calls at the same step boundaries (a rank
    that left the loop on its own flag would leave the others in the next
    gradient all-reduce)."""
    if world_size() == 1:
        return bool(local_flag)
    flag = torch.tensor([1 if local_flag else 0], dtype=torch.int32,
                        device=_collective_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def require_single_process(what: str) -> None:
    """The eval and scoring modes fetch whole arrays and write artifact
    files from one process; training is the multi-process path."""
    if world_size() > 1:
        raise RuntimeError(
            f"{what} runs in one process: launch it without torchrun or "
            f"--multihost (training is the multi-process path)")
