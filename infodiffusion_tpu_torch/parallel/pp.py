"""GPipe over the LatentUNet's middle layers under ``--pp``
(JAX counterpart: ``infodiffusion_tpu/parallel/pp.py``).

The latent denoiser's layers 1 .. 8 are homogeneous (each maps
``[h, x]`` with the same structure), so S stages take L/S of them each.
The image UNet is not split: its skips couple the stages.

The schedule is GPipe's fill-drain, by hand with point-to-point sends
between neighbouring stages (rank ``d * S + s`` is stage ``s`` of
pipeline ``d``, the JAX dp x pp mesh's order):

- every stage computes the time embedding and layer 0 on its rows (the
  JAX executor runs them replicated too);
- forward: microbatch by microbatch, stage s receives ``h`` from s - 1,
  runs its layers with ``x``, the time embedding and the dropout draws of
  those rows, and sends ``h`` on; the last stage gathers the M outputs and
  broadcasts them over the pipeline, and every stage runs the last layer
  and the loss (the JAX executor's ``psum`` over stages);
- backward: in reverse microbatch order each stage takes its output's
  cotangent from s + 1 (the last stage from the loss), backpropagates its
  layers and sends the input's cotangent to s - 1; then the shares of the
  time embedding and of layer 0 go back through them;
- the gradient shares are summed over all ranks: over the stages (each
  holds its layers', the last layer's is kept on the last stage only) and
  over the data replicas (each holds its rows' share, ``parallel/batch``).

The parameters and the optimizer state are replicated on every rank
(the latent prior is small); the AdamW step is the one-process step.
Dropout: every layer's draws are made for the whole batch, in the
sequential model's order, from the step's dropout generator, so the
pipelined step equals the one-process step with dropout on as well;
``deterministic_dropout_off`` turns dropout off, as in JAX.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from infodiffusion_tpu_torch.diffusion.schedule import q_sample
from infodiffusion_tpu_torch.models.latent_unet import NUM_LAYERS
from infodiffusion_tpu_torch.parallel.batch import BatchRows, batch_mean, batch_scope
from infodiffusion_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    STAGE_AXIS,
    axis_group,
    axis_index,
    axis_size,
    make_1d_mesh,
)


def make_stage_mesh(n_stages: int):
    return make_1d_mesh(n_stages, STAGE_AXIS)


def make_dp_stage_mesh(n_data: int, n_stages: int):
    """``(data, stage)``: ``n_data`` pipelines of ``n_stages`` stages,
    a pipeline's stages on adjacent ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_data * n_stages != world:
        raise ValueError(f"dp x pp mesh wants {n_data * n_stages} devices "
                         f"({n_data} x {n_stages}) but the world has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (n_data, n_stages),
                            mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


def microbatch_count(pp: int) -> int:
    m = int(os.environ.get("INFODIFF_PP_MICROBATCHES", str(pp)))
    if m < 1:
        raise ValueError(f"--pp microbatch count must be >= 1, got {m} "
                         f"(INFODIFF_PP_MICROBATCHES)")
    return m


class Pipeline:
    """This rank's place in a ``stage`` (or ``(data, stage)``) mesh."""

    def __init__(self, mesh, microbatches: int):
        self.S = axis_size(mesh, STAGE_AXIS)
        self.s = axis_index(mesh, STAGE_AXIS)
        self.dp = axis_size(mesh, DATA_AXIS)
        self.d = axis_index(mesh, DATA_AXIS)
        self.stage_group = mesh.get_group(STAGE_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.M = int(microbatches)
        rank = dist.get_rank()
        self.prev, self.next = rank - 1, rank + 1
        self.last = rank - self.s + self.S - 1  # the global rank of stage S-1
        L = NUM_LAYERS - 2
        if L % self.S:
            raise ValueError(f"{L} middle layers do not split over {self.S} "
                             f"pipeline stages")
        lps = L // self.S
        self.layers = range(1 + self.s * lps, 1 + (self.s + 1) * lps)

    def check(self, global_batch: int) -> None:
        if global_batch % self.M:
            raise ValueError(f"batch size {global_batch} must be divisible "
                             f"by the microbatch count {self.M} (--pp "
                             f"pipelining)")
        if (global_batch // self.M) % self.dp:
            raise ValueError(f"microbatch size {global_batch // self.M} must "
                             f"divide over the {self.dp}-wide data axis of "
                             f"the dp x pp mesh (batch {global_batch}, "
                             f"{self.M} microbatches)")

    def rows(self, local_batch: int) -> BatchRows:
        return BatchRows(self.data_group, self.d, self.dp,
                         local_batch * self.dp)


def _params(module) -> List[torch.Tensor]:
    return list(module.parameters())


def _pp_run(bb, pipe: Pipeline, x: torch.Tensor, t: torch.Tensor,
            uniforms, with_grad: bool, eps: Optional[torch.Tensor] = None):
    """The pipelined forward of LatentUNet ``bb`` on this rank's rows
    ``x`` [b, d] (with the loss against ``eps`` and the backward when
    ``with_grad``). Returns (out, loss, grads by parameter)."""
    b = x.shape[0]
    if b % pipe.M:
        raise ValueError(f"{b} rows do not split into {pipe.M} microbatches")
    mb = b // pipe.M
    u = (lambda i, sl: None) if uniforms is None else (
        lambda i, sl: uniforms[i][sl])
    sls = [slice(m * mb, (m + 1) * mb) for m in range(pipe.M)]
    temb = bb.time_embed(t)
    h0 = bb.layer(0, None, x, temb, uniforms=u(0, slice(None)))
    temb_in = temb.detach().requires_grad_(with_grad)
    h0_in = h0.detach().requires_grad_(with_grad)
    width, dtype = h0.shape[1], h0.dtype
    saved = []
    for m, sl in enumerate(sls):
        if pipe.s == 0:
            h_in = h0_in[sl]
        else:
            h_in = torch.empty((mb, width), dtype=dtype, device=x.device)
            dist.recv(h_in, pipe.prev)
            h_in.requires_grad_(with_grad)
        h = h_in
        for i in pipe.layers:
            h = bb.layer(i, h, x[sl], temb_in[sl], uniforms=u(i, sl))
        if pipe.s < pipe.S - 1:
            dist.send(h.detach().contiguous(), pipe.next)
        saved.append((h_in, h))
    if pipe.s == pipe.S - 1:
        mid = torch.cat([h.detach() for _, h in saved])
    else:
        mid = torch.empty((b, width), dtype=dtype, device=x.device)
    dist.broadcast(mid, pipe.last, group=pipe.stage_group)
    mid.requires_grad_(with_grad)
    out = bb.layer(NUM_LAYERS - 1, mid, x, temb_in)
    if not with_grad:
        return out, None, None
    f32 = torch.float32
    with batch_scope(pipe.rows(b)):
        loss = batch_mean((out.to(f32) - eps.to(f32)).square())
    grads = {}
    last = getattr(bb, f"layer_{NUM_LAYERS - 1}")
    g = torch.autograd.grad(loss, _params(last) + [mid])
    if pipe.s == pipe.S - 1:  # counted once over the stages
        for p, gp in zip(_params(last), g[:-1]):
            grads[p] = gp
    g_mid = g[-1]
    mine = [p for i in pipe.layers for p in _params(getattr(bb,
                                                            f"layer_{i}"))]
    g_temb = torch.zeros_like(temb_in)
    g_h0 = torch.zeros_like(h0_in)
    for m in reversed(range(pipe.M)):
        h_in, h = saved[m]
        if pipe.s == pipe.S - 1:
            g_out = g_mid[sls[m]]
        else:
            g_out = torch.empty_like(h)
            dist.recv(g_out, pipe.next)
        src = h_in if pipe.s > 0 else h0_in
        gs = torch.autograd.grad(h, mine + [temb_in, src], g_out,
                                 allow_unused=True)
        for p, gp in zip(mine, gs):
            if gp is not None:
                grads[p] = grads[p] + gp if p in grads else gp
        if gs[-2] is not None:
            g_temb = g_temb + gs[-2]
        if pipe.s > 0:
            dist.send(gs[-1].contiguous(), pipe.prev)
        else:
            g_h0 = g_h0 + gs[-1]
    prefix = (_params(bb.time_embed_0) + _params(bb.time_embed_1)
              + _params(bb.layer_0))
    gs = torch.autograd.grad([temb, h0], prefix, [g_temb, g_h0],
                             allow_unused=True)
    for p, gp in zip(prefix, gs):
        if gp is not None:
            grads[p] = grads[p] + gp if p in grads else gp
    return out, loss.detach(), grads


def latent_pp_forward(bb, x: torch.Tensor, t: torch.Tensor, mesh,
                      microbatches: int) -> torch.Tensor:
    """The LatentUNet ``bb``'s forward (dropout off) on this rank's rows,
    layers 1 .. 8 pipelined over the mesh's ``stage`` axis; the output on
    every stage."""
    pipe = Pipeline(mesh, microbatches)
    with torch.no_grad():
        return _pp_run(bb, pipe, x, t, None, with_grad=False)[0]


def pp_loss_and_grads(model, pipe: Pipeline, x: torch.Tensor,
                      t: torch.Tensor, eps: torch.Tensor, uniforms=None):
    """The latent Diff's eps-MSE on this rank's rows (pre-drawn ``t``,
    ``eps`` and dropout ``uniforms``, each [b, ...] or None), and its
    gradient summed over every rank: (loss, [grad per parameter in
    ``model.parameters()`` order])."""
    x_tilde = q_sample(model.sched(x.device), x, t, eps)
    _, loss, by_param = _pp_run(model.backbone, pipe, x_tilde, t, uniforms,
                                with_grad=True, eps=eps)
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [by_param.get(p, torch.zeros_like(p)) for p in model.parameters()]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat)
    return loss, list(_unflatten_dense_tensors(flat, grads))


def step_draws(model, rngs, x: torch.Tensor, pipe: Pipeline,
               dropout_on: bool):
    """This rank's rows of the step's draws for the global batch, in the
    one-process order: ``t`` and ``eps`` from 'noise', then each dropout
    layer's uniforms from 'dropout'."""
    b = x.shape[0]
    rows = pipe.rows(b)
    B, sl = rows.total, slice(rows.lo, rows.hi)
    t = torch.randint(0, model.T, (B,), generator=rngs.noise,
                      device=x.device)[sl]
    eps = torch.randn((B,) + tuple(x.shape[1:]), generator=rngs.noise,
                      device=x.device, dtype=x.dtype)[sl]
    uniforms = None
    if dropout_on:
        width = model.backbone.layer_0.linear.weight.shape[0]
        uniforms = [torch.empty((B, width), dtype=torch.float32,
                                device=x.device).uniform_(
                                    generator=rngs.dropout)[sl]
                    for _ in range(NUM_LAYERS - 1)]
    return t, eps, uniforms


def make_pp_train_step(model, tx, mesh, microbatches: int,
                       ema_decay: float = 0.0,
                       deterministic_dropout_off: bool = False) -> Callable:
    """The ``--pp`` train step of the latent Diff: ``step_fn(state,
    batch, curr_epoch) -> (state, metrics)``, ``batch`` this rank's rows
    (its data index's block), the state replicated; metrics as
    ``train.step.make_train_step``'s."""
    from infodiffusion_tpu_torch.train.step import step_rngs, update_ema

    pipe = Pipeline(mesh, microbatches)

    def step_fn(state, batch, curr_epoch=0):
        del curr_epoch  # the latent loss has no capacity annealing
        pipe.check(batch.shape[0] * pipe.dp)
        rngs = step_rngs(state.seed, state.step, batch.device)
        t, eps, uniforms = step_draws(model, rngs, batch, pipe,
                                      not deterministic_dropout_off)
        loss, grads = pp_loss_and_grads(model, pipe, batch, t, eps, uniforms)
        grad_norm = tx.update(state.params, grads, state.opt_state)
        if ema_decay > 0.0 and state.ema_params is not None:
            update_ema(state.ema_params, state.params, ema_decay)
        state.step += 1
        return state, {"loss": loss, "grad_norm": grad_norm, "denoise": loss}

    step_fn.pipeline = pipe
    return step_fn
