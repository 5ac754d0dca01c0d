"""The train step (JAX counterpart: ``infodiffusion_tpu/train/step.py``).

One step: the loss with its draws, the backward (through the kernels'
``autograd.Function``s on the card), the clip, AdamW and the optional EMA.
The draws of step ``s`` come from three generators seeded from
``(seed, s)`` (``step_rngs``), as the JAX step folds its key with the
step, so training is reproducible from (seed, step); the bits differ
from JAX's by design. ``loss_and_grads`` is the step's first half on its
own, so a test can run it with injected draws and ``deterministic=True``.
The step updates the state in place and returns it, where the jitted JAX
step returns a new one. Its three phases are the spans ``train.forward``,
``train.backward`` and ``train.optimizer`` (``tracing.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from infodiffusion_tpu_torch import tracing
from infodiffusion_tpu_torch.models.wrappers import Rngs
from infodiffusion_tpu_torch.parallel.batch import batch_scope
from infodiffusion_tpu_torch.train.state import ClipAdamW, TrainState


def step_rngs(seed: int, step: int, device) -> Rngs:
    """The 'noise', 'reparam' and 'dropout' generators of one step."""
    seeds = np.random.SeedSequence([seed, step]).generate_state(3)
    return Rngs(*(torch.Generator(device=device).manual_seed(int(s))
                  for s in seeds))


def loss_and_grads(model, batch: torch.Tensor, curr_epoch=0,
                   seed_step: Optional[Tuple[int, int]] = None,
                   reduce: Optional[Callable[[List], List]] = None,
                   **loss_kwargs) -> Tuple[torch.Tensor, Dict, List]:
    """(loss, aux, grads) of ``model.loss_fn(batch, curr_epoch,
    **loss_kwargs)``; ``grads`` holds one tensor per parameter in
    ``model.named_parameters()`` order, zeros where the parameter takes no
    part in the loss (as JAX's gradient has them). ``seed_step`` (seed,
    step) draws with ``step_rngs``; ``reduce`` maps the gradients (the
    layout's sum over ranks) inside the backward's span."""
    params = list(model.parameters())
    with tracing.span("train.forward"):
        if seed_step is not None:
            loss_kwargs["rngs"] = step_rngs(*seed_step, batch.device)
        loss, aux = model.loss_fn(batch, curr_epoch, **loss_kwargs)
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if reduce is not None:
            grads = reduce(grads)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(model, tx: ClipAdamW, ema_decay: float = 0.0,
                    layout=None) -> Callable:
    """Returns ``step_fn(state, batch, curr_epoch) -> (state, metrics)``;
    metrics hold ``loss``, ``grad_norm`` (the global norm before the clip)
    and the loss's aux terms, as device tensors (no host sync).

    With a ``layout`` (``parallel/layout.py``) the state is this rank's
    pieces and ``batch`` its rows of the global batch: the loss is the
    global batch's, the gradient shares are summed over the data group and
    the norm is the whole gradient's, so the N-rank step repeats the
    one-process step."""

    def step_fn(state: TrainState, batch: torch.Tensor, curr_epoch=0):
        seed_step = (state.seed, state.step)
        if layout is None:
            loss, aux, grads = loss_and_grads(model, batch, curr_epoch,
                                              seed_step, deterministic=False)
        else:
            layout.unshard(state)
            try:
                with batch_scope(layout.rows(batch.shape[0])):
                    loss, aux, grads = loss_and_grads(
                        model, batch, curr_epoch, seed_step,
                        lambda g: layout.reduce_grads(state, g),
                        deterministic=False)
            finally:
                layout.reshard(state)
        with tracing.span("train.optimizer"):
            norm = (None if layout is None
                    else layout.global_norm(state, grads))
            grad_norm = tx.update(state.params, grads, state.opt_state,
                                  norm=norm)
            del grads
            if ema_decay > 0.0 and state.ema_params is not None:
                update_ema(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm, **aux}

    return step_fn


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), in place."""
    e = list(ema.values())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in ema], alpha=1.0 - decay)


def make_eval_encode_step(model, pick_mu: bool = False) -> Callable:
    """Deterministic encode (``sample=False``): ``encode(x)`` returns mu
    when ``pick_mu`` (the KLD rows of the regularizer table), else a."""

    @torch.no_grad()
    def encode(x: torch.Tensor) -> torch.Tensor:
        a, _aq, mu, _lv = model.encode(x, sample=False)
        return mu if pick_mu else a

    return encode
