"""Train state, optimizer and LR schedule
(JAX counterpart: ``infodiffusion_tpu/train/state.py``).

The optimizer is ``optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine, weight_decay=1e-5))`` written out with optax's
semantics, which differ from ``torch.optim.AdamW`` and
``clip_grad_norm_`` in three places:

- the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``
  (torch divides by ``norm + 1e-6``);
- every parameter is updated, a zero gradient included (``fc_mu`` and
  ``fc_var`` take no part in the flagship's loss, and AdamW still decays
  them; torch skips parameters whose ``.grad`` is None);
- the first update uses ``schedule(0)``.

The update runs in place on the model's parameters and the f32 moments
(``torch._foreach_*``), where the JAX package returns new trees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch


def warmup_cosine_schedule(base_lr: float, epochs: int, steps_per_epoch: int,
                           multiplier: float = 2.0) -> Callable[[int], float]:
    """The reference's per-epoch LR staircase on the global step: base in
    epoch 0, ``multiplier * base`` in epoch 1, then
    ``multiplier * base * (1 + cos(pi * (epoch - 2) / epochs)) / 2``."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        if epoch <= 1:
            return base_lr * ((multiplier - 1.0) * epoch + 1.0)
        t = epoch - 2
        return multiplier * base_lr * 0.5 * (1.0 + math.cos(math.pi * t / epochs))

    return schedule


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClipAdamW:
    """Global-norm clip, then AdamW (b1 0.9, b2 0.999, eps 1e-8) with a
    step schedule and decoupled weight decay, as optax chains them."""

    def __init__(self, schedule: Callable[[int], float],
                 weight_decay: float = 1e-5, clip_norm: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32)
                         for p in params.values()]
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: List[torch.Tensor], state: AdamWState,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip ``grads`` (one per parameter, in ``params`` order), apply
        one AdamW step to ``params`` in place, and return the pre-clip
        global norm. ``norm`` is that norm when the caller computed it (the
        parameters are split over ranks: ``parallel/layout.py``)."""
        p = list(params.values())
        g = [x.to(torch.float32) for x in grads]
        if norm is None:
            norm = global_norm(g)
        # optax: t if norm < max_norm else (t / norm) * max_norm
        clipped = norm >= self.clip_norm
        g = torch._foreach_div(g, torch.where(clipped, norm, 1.0))
        g = torch._foreach_mul(g, torch.where(clipped, self.clip_norm, 1.0))
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        f32 = torch.float32
        c1 = 1.0 - torch.tensor(b1, dtype=f32) ** state.count
        c2 = 1.0 - torch.tensor(b2, dtype=f32) ** state.count
        mu_hat = torch._foreach_div(state.mu, c1.item())
        nu_hat = torch._foreach_div(state.nu, c2.item())
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(u, [x.to(f32) for x in p], alpha=self.weight_decay)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, [x.to(y.dtype) for x, y in zip(u, p)])
        return norm


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (f32)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([t.to(torch.float32) for t in tensors])))


def make_optimizer(learning_rate: float, epochs: int, steps_per_epoch: int,
                   weight_decay: float = 1e-5,
                   clip_norm: float = 1.0) -> ClipAdamW:
    """clip(1.0) -> AdamW(warmup-cosine, wd 1e-5)."""
    return ClipAdamW(
        warmup_cosine_schedule(learning_rate, epochs, steps_per_epoch),
        weight_decay=weight_decay, clip_norm=clip_norm)


@dataclasses.dataclass
class TrainState:
    """What a step needs: the parameters (the model's own tensors, by
    name), the optimizer state, the step counter and the root seed of the
    per-step draws, and the optional EMA of the parameters."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: AdamWState
    seed: int
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model: torch.nn.Module, seed: int, tx: ClipAdamW,
                       ema: bool = False) -> TrainState:
    """The state of ``model``'s parameters (every submodule, the encoder
    included, exists from construction)."""
    params = dict(model.named_parameters())
    return TrainState(
        step=0, params=params, opt_state=tx.init(params), seed=seed,
        ema_params=({n: p.detach().clone() for n, p in params.items()}
                    if ema else None),
    )
