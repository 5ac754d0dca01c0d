"""A train state laid out over the ``(data, model)`` mesh, and what the
train step does across ranks (JAX counterparts: ``parallel/mesh.py``'s
replicated state, ``parallel/fsdp.py``'s ``place_state`` and
``parallel/tp.py``'s ``shard_state_tp``).

Each parameter has a data axis (FSDP) and a model axis (TP), either None
(``fsdp.fsdp_dim``, ``tp.tp_dims``). At rest a rank holds its piece of
every parameter, Adam moment and EMA: the model-axis chunk of its model
index, and of that the data-axis chunk of its data index. Around the
forward and backward the data-axis pieces are all-gathered
(``unshard``) and split again after (``reshard``); the model-axis pieces
stay split and compute split (``tp.TPShard``).

The step (``train.step.make_train_step(..., layout=)``):

1. the loss over this rank's rows with global-batch semantics
   (``parallel/batch.py``): every rank of the data group computes the
   one-process loss, and its gradient is its rows' share;
2. the shares summed over the data group: reduce-scattered where the
   parameter splits over data, all-reduced in one flat bucket elsewhere;
3. the global norm for the clip, each parameter's squared norm summed over
   the groups it splits over (a whole parameter counts once);
4. clip, AdamW and the EMA on the pieces, elementwise as in one process.

At one rank every piece is the whole tensor and no collective changes a
value, so the step is the one-process step bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from infodiffusion_tpu_torch.parallel import tp as tp_mod
from infodiffusion_tpu_torch.parallel.batch import BatchRows
from infodiffusion_tpu_torch.parallel.fsdp import FSDP_MIN_SIZE, fsdp_dim
from infodiffusion_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from infodiffusion_tpu_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class Placement:
    data: Optional[int] = None   # torch axis split over 'data'
    model: Optional[int] = None  # torch axis split over 'model'


def _chunk(t: torch.Tensor, dim: Optional[int], n: int, i: int):
    return t if dim is None or n == 1 else t.chunk(n, dim)[i].contiguous()


def _all_gather(t: torch.Tensor, dim: Optional[int], group, n: int):
    if dim is None or n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


class Layout:
    """The placements of a model's parameters over ``mesh`` and the
    collectives of its train step. ``kind`` names it: 'dp', 'fsdp', 'tp'
    or 'tp+fsdp'."""

    def __init__(self, mesh, placements: Dict[str, Placement], kind: str):
        self.mesh = mesh
        self.placements = placements
        self.kind = kind
        self.data_width = axis_size(mesh, DATA_AXIS)
        self.data_index = axis_index(mesh, DATA_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.model_width = axis_size(mesh, MODEL_AXIS)
        self.model_index = axis_index(mesh, MODEL_AXIS)
        self.model_group = axis_group(mesh, MODEL_AXIS)

    # ------------------------------------------------------------ build

    @classmethod
    def for_model(cls, model: torch.nn.Module, mesh, *, fsdp: bool = False,
                  fsdp_min_size: int = FSDP_MIN_SIZE,
                  tp_min_size: int = tp_mod.TP_MIN_SIZE) -> "Layout":
        """JAX's rules on ``model``'s (whole) parameters: replicated (DP);
        ``fsdp``; tensor parallel where the mesh's model axis is wider than
        one, with ``fsdp`` on top."""
        ndp, ntp = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
        placements = {}
        for name, p in model.named_parameters():
            shape = tuple(p.shape)
            if ntp > 1:
                d, m = tp_mod.tp_dims(name, shape, ntp, ndp, tp_min_size,
                                      fsdp, fsdp_min_size)
            else:
                d, m = (fsdp_dim(name, shape, ndp, fsdp_min_size)
                        if fsdp else None), None
            placements[name] = Placement(d, m)
        kind = ("tp+fsdp" if ntp > 1 and fsdp else "tp" if ntp > 1
                else "fsdp" if fsdp else "dp")
        return cls(mesh, placements, kind)

    # ------------------------------------------------------------ pieces

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole tensor of parameter ``name``."""
        pl = self.placements[name]
        t = _chunk(full, pl.model, self.model_width, self.model_index)
        return _chunk(t, pl.data, self.data_width, self.data_index)

    def whole(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's piece (a collective)."""
        pl = self.placements[name]
        t = _all_gather(piece, pl.data, self.data_group, self.data_width)
        return _all_gather(t, pl.model, self.model_group, self.model_width)

    @torch.no_grad()
    def shard_state(self, model: torch.nn.Module,
                    state: TrainState) -> TrainState:
        """Lay out a whole, replicated ``state`` of ``model``: every
        parameter, moment and EMA becomes this rank's piece, and the
        modules with split output channels compute split."""
        for i, (name, p) in enumerate(state.params.items()):
            p.data = self.local(name, p.data)
            state.opt_state.mu[i] = self.local(name, state.opt_state.mu[i])
            state.opt_state.nu[i] = self.local(name, state.opt_state.nu[i])
            if state.ema_params is not None:
                state.ema_params[name] = self.local(
                    name, state.ema_params[name])
        if self.model_width > 1:
            tp_mod.install(model, {k: pl.model is not None
                                   for k, pl in self.placements.items()},
                           self.model_group)
        return state

    @torch.no_grad()
    def whole_state(self, state: TrainState) -> TrainState:
        """A copy of ``state`` with whole tensors, on every rank (a
        collective; what a checkpoint holds)."""
        names = list(state.params)
        return TrainState(
            step=state.step, seed=state.seed,
            params={n: self.whole(n, p.data) for n, p in state.params.items()},
            opt_state=type(state.opt_state)(
                count=state.opt_state.count,
                mu=[self.whole(n, t) for n, t in zip(names,
                                                     state.opt_state.mu)],
                nu=[self.whole(n, t) for n, t in zip(names,
                                                     state.opt_state.nu)]),
            ema_params=(None if state.ema_params is None else
                        {n: self.whole(n, t)
                         for n, t in state.ema_params.items()}))

    def unshard(self, state: TrainState) -> None:
        """Gather the data-axis pieces of the parameters for the forward."""
        for name, p in state.params.items():
            pl = self.placements[name]
            if pl.data is not None and self.data_width > 1:
                p.data = _all_gather(p.data, pl.data, self.data_group,
                                     self.data_width)

    def reshard(self, state: TrainState) -> None:
        for name, p in state.params.items():
            pl = self.placements[name]
            if pl.data is not None and self.data_width > 1:
                p.data = _chunk(p.data, pl.data, self.data_width,
                                self.data_index)

    def state_bytes(self, state: TrainState) -> int:
        """Bytes this rank holds of the parameters, the moments and the
        EMA."""
        ts = list(state.params.values()) + state.opt_state.mu + \
            state.opt_state.nu + list((state.ema_params or {}).values())
        return sum(t.numel() * t.element_size() for t in ts)

    # ------------------------------------------------------------ the step

    def rows(self, local_batch: int) -> BatchRows:
        return BatchRows(self.data_group, self.data_index, self.data_width,
                         local_batch * self.data_width)

    @torch.no_grad()
    def reduce_grads(self, state: TrainState,
                     grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's gradient shares summed over the data group, cut to
        the rank's piece where the parameter splits over data."""
        if self.data_width == 1:
            return grads
        out = list(grads)
        bucket = []
        for i, name in enumerate(state.params):
            dim = self.placements[name].data
            if dim is None:
                bucket.append(i)
                continue
            g = grads[i].movedim(dim, 0).contiguous()
            piece = torch.empty((g.shape[0] // self.data_width,)
                                + tuple(g.shape[1:]), dtype=g.dtype,
                                device=g.device)
            dist.reduce_scatter(piece, list(g.chunk(self.data_width)),
                                group=self.data_group)
            out[i] = piece.movedim(0, dim)
        if bucket:
            from torch._utils import (
                _flatten_dense_tensors,
                _unflatten_dense_tensors,
            )

            ts = [grads[i] for i in bucket]
            flat = _flatten_dense_tensors(ts)
            dist.all_reduce(flat, group=self.data_group)
            for i, t in zip(bucket, _unflatten_dense_tensors(flat, ts)):
                out[i] = t
        return out

    @torch.no_grad()
    def global_norm(self, state: TrainState,
                    grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from the pieces: each
        parameter's squared norm summed over the groups it splits over.
        Equals ``train.state.global_norm`` of the whole gradient."""
        norms = list(torch._foreach_norm([g.to(torch.float32)
                                          for g in grads]))
        for axis, group, width in ((DATA_AXIS, self.data_group,
                                    self.data_width),
                                   (MODEL_AXIS, self.model_group,
                                    self.model_width)):
            if width == 1:
                continue
            idx = [i for i, n in enumerate(state.params)
                   if getattr(self.placements[n], axis) is not None]
            if not idx:
                continue
            sq = torch.stack([norms[i] for i in idx]).square()
            dist.all_reduce(sq, group=group)
            for j, i in enumerate(idx):
                norms[i] = sq[j].sqrt()
        return torch.linalg.vector_norm(torch.stack(norms))


def describe(layout: Optional[Layout]) -> str:
    if layout is None:
        return "one process"
    split = {"data": sum(p.data is not None
                         for p in layout.placements.values()),
             "model": sum(p.model is not None
                          for p in layout.placements.values())}
    return (f"{layout.kind}: data {layout.data_width} x model "
            f"{layout.model_width}; parameters split over data "
            f"{split['data']}, over model {split['model']} of "
            f"{len(layout.placements)}")

