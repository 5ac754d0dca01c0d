"""Global-batch semantics on one rank's rows, and the autograd-aware
collectives they rest on.

The JAX train step is written over the global batch and XLA splits it;
here each rank holds its block of rows, so the places where the loss sees
the batch as a whole are made explicit (``batch_scope``):

- every draw (``t``, ``eps``, ``reparam_eps``, dropout bits) is made for
  the **global** batch from the step's generators and the rank keeps its
  rows (``draw_rows``), so N ranks draw what one process draws;
- a mean over the batch is the global mean (``batch_mean``), a sum the
  global sum (``batch_sum``);
- the MMD's target latents are gathered (``gather_batch``) and the MMD is
  taken against the global prior draws.

Every rank then computes the same loss value. Each collective's backward
hands the rank the cotangent of **its own** rows (a gather's backward is
the rank's slice, an all-reduce's the cotangent itself), since every rank
computes that cotangent in full; the rank's gradient is its rows' share,
and the sum over the data group is the one-process gradient
(``parallel/layout.py``).

Outside a ``batch_scope`` (or one data rank wide) every helper is the
plain one-process op, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist


def _world(group) -> int:
    return dist.get_world_size(group)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (equal sizes); backward: this rank's slice
    of the cotangent (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        parts = [torch.empty_like(x) for _ in range(_world(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum); backward: the cotangent itself."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    """Identity; backward: the all-reduced (summed) cotangent. The input of
    a layer whose outputs are split over ranks (tensor parallelism)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in group-rank order,
    for a consumer every rank computes alike."""
    if group is None or _world(group) == 1:
        return x
    return _Gather.apply(x, group, dim)


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or _world(group) == 1:
        return x
    return _SumReplicated.apply(x, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    if group is None or _world(group) == 1:
        return x
    return _SumGrad.apply(x, group)


class BatchRows:
    """Rows ``[lo, hi)`` of a ``total``-row global batch, held by data
    index ``index`` of the ``width``-wide data ``group``."""

    def __init__(self, group, index: int, width: int, total: int):
        if total % width:
            raise ValueError(f"global batch {total} does not divide over "
                             f"{width} data ranks")
        self.group, self.index, self.width, self.total = (
            group, index, width, total)
        n = total // width
        self.lo, self.hi = index * n, (index + 1) * n

    def draw(self, fn: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
        if n != self.hi - self.lo:
            raise ValueError(f"{n} rows here, {self.hi - self.lo} expected")
        return fn(self.total)[self.lo:self.hi]

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return sum_replicated(t.sum(), self.group) / (t.numel() * self.width)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return sum_replicated(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather(t, self.group, 0)


_ACTIVE: Optional[BatchRows] = None


@contextlib.contextmanager
def batch_scope(rows: Optional[BatchRows]):
    """Make ``rows`` the batch that the loss functions see as global
    (None, or a one-wide data axis: the plain one-process ops)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rows if rows is not None and rows.width > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def draw_rows(fn: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """``fn(n)``, or this rank's rows of ``fn(global batch)``."""
    return fn(n) if _ACTIVE is None else _ACTIVE.draw(fn, n)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    return t.mean() if _ACTIVE is None else _ACTIVE.mean(t)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` is a sum over this rank's rows; the sum over the global batch."""
    return t if _ACTIVE is None else _ACTIVE.sum(t)


def gather_batch(t: torch.Tensor) -> torch.Tensor:
    return t if _ACTIVE is None else _ACTIVE.gather(t)
