"""Rank functions for the multi-process tests of the port's parallel
layouts (``parallel/launch.spawn`` runs them, one process a rank, over
gloo on the CPU). This module imports no jax: the JAX references are
computed in the test process.

Each function returns what the test compares, on rank 0 (the other ranks
return their own small facts). The one-process references come from the
same constructors (``tiny_infodiff``, ``tiny_batch``) in the test process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.wrappers import InfoDiff
from infodiffusion_tpu_torch.parallel import multihost
from infodiffusion_tpu_torch.parallel.layout import Layout
from infodiffusion_tpu_torch.parallel.mesh import make_mesh, shard_batch
from infodiffusion_tpu_torch.train.checkpoint import save_checkpoint
from infodiffusion_tpu_torch.train.state import create_train_state, make_optimizer
from infodiffusion_tpu_torch.train.step import make_train_step

# the InfoDiff of the step tests: 8x8, one channel, ch 32, ch_mult (1, 2),
# attention at level 1; the MMD on (kld 0) unless asked
MODEL_KW = dict(T=8, a_dim=4, shape=(1, 8, 8), unets_channels=32,
                encoder_channels=32, mmd_weight=0.1, epochs=3, attn=(1,),
                ch_mult=(1, 2))
BATCH = 8
STEPS = 2
LR = 1e-4
EMA = 0.9
SEED = 3

# (name, tensor-parallel width, fsdp) per world size
LAYOUTS = {2: (("dp", 1, False), ("fsdp", 1, True), ("tp", 2, False),
               ("tp+fsdp", 2, True)),
           4: (("dp", 1, False), ("fsdp", 1, True), ("tp", 2, False),
               ("tp+fsdp", 2, True))}


def tiny_infodiff(kld_weight: float = 0.0) -> InfoDiff:
    torch.manual_seed(0)
    model = InfoDiff(**MODEL_KW, kld_weight=kld_weight)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-zero biases, so no gradient is trivially 0
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.05, generator=g)
    return model


def tiny_batch() -> torch.Tensor:
    rs = np.random.RandomState(2)
    return torch.from_numpy(rs.randn(BATCH, 8, 8, 1).astype(np.float32))


def one_process(kld_weight: float = 0.0):
    """The reference: STEPS one-process steps on the whole batch."""
    model = tiny_infodiff(kld_weight).train()
    tx = make_optimizer(LR, 3, 4)
    state = create_train_state(model, SEED, tx, ema=True)
    step = make_train_step(model, tx, ema_decay=EMA)
    x = tiny_batch()
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, x, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": {k: v.detach().clone() for k, v in state.params.items()},
            "ema": {k: v.clone() for k, v in state.ema_params.items()}}


def battery(workdir: str, kld_weight: float = 0.0):
    """``train_layouts``, ``sampling_case`` and the runner's collectives
    (``process_allgather``, ``agree_on_preemption``) in one run of the
    ranks."""
    out = train_layouts(workdir, kld_weight)
    out["sampling"] = sampling_case()
    rank = multihost.rank()
    out["allgather"] = multihost.process_allgather(np.array([rank, 2 * rank]))
    out["preempt"] = (multihost.agree_on_preemption(False),
                      multihost.agree_on_preemption(rank == 1))
    return out


def train_layouts(workdir: str, kld_weight: float = 0.0):
    """Every layout of this world size (``LAYOUTS``): STEPS steps, then the
    metrics, the whole parameters and EMA, the rank's state bytes, the
    placements, and (FSDP) a checkpoint written in ``workdir``."""
    torch.set_num_threads(2)
    world = multihost.world_size()
    out = {}
    for name, tp, fsdp in LAYOUTS[world]:
        model = tiny_infodiff(kld_weight).train()
        tx = make_optimizer(LR, 3, 4)
        state = create_train_state(model, SEED, tx, ema=True)
        mesh = make_mesh(world, model_parallel=tp)
        layout = Layout.for_model(model, mesh, fsdp=fsdp)
        state = layout.shard_state(model, state)
        step = make_train_step(model, tx, ema_decay=EMA, layout=layout)
        x = shard_batch(mesh, tiny_batch())
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, x, 0)
            metrics.append({k: float(v) for k, v in m.items()})
        whole = layout.whole_state(state)
        ckpt = None
        if name == "fsdp":
            ckpt = os.path.join(workdir, f"ckpt-{world}")
            save_checkpoint(ckpt, STEPS, state, layout=layout)
        out[name] = {
            "kind": layout.kind, "rows": int(x.shape[0]),
            "metrics": metrics, "bytes": layout.state_bytes(state),
            "placements": {k: (p.data, p.model)
                           for k, p in layout.placements.items()},
            "params": whole.params, "ema": whole.ema_params,
            "mu": whole.opt_state.mu, "ckpt": ckpt,
        }
    return out


# ---------------------------------------------------------------------------
# --pp: GPipe over the LatentUNet's middle layers
# ---------------------------------------------------------------------------

LATENT_D = 8
LATENT_BATCH = 8


def tiny_latent(state_dict=None):
    """The latent prior of the --pp tests (a_dim 8, T 16), with
    ``state_dict``'s weights when given."""
    from infodiffusion_tpu_torch.models.wrappers import Diff

    torch.manual_seed(0)
    model = Diff(T=16, shape=(1, LATENT_D, LATENT_D), is_latent=True)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def latent_batch() -> torch.Tensor:
    rs = np.random.RandomState(6)
    return torch.from_numpy(rs.randn(LATENT_BATCH, LATENT_D).astype(np.float32))


def latent_one_process(dropout_off: bool, state_dict=None):
    """STEPS one-process latent steps (dropout on unless ``dropout_off``)."""
    from infodiffusion_tpu_torch.train.step import loss_and_grads, step_rngs

    model = tiny_latent(state_dict).train()
    tx = make_optimizer(LR, 3, 4)
    state = create_train_state(model, SEED, tx, ema=True)
    x = latent_batch()
    metrics = []
    for _ in range(STEPS):
        rngs = step_rngs(state.seed, state.step, x.device)
        loss, aux, grads = loss_and_grads(model, x, 0,
                                          deterministic=dropout_off, rngs=rngs)
        norm = tx.update(state.params, grads, state.opt_state)
        from infodiffusion_tpu_torch.train.step import update_ema
        update_ema(state.ema_params, state.params, EMA)
        state.step += 1
        metrics.append({"loss": float(loss), "grad_norm": float(norm)})
    return {"metrics": metrics,
            "params": {k: v.detach().clone() for k, v in state.params.items()}}


def pp_steps(n_stages: int, microbatches: int, dropout_off: bool,
             state_dict=None):
    """STEPS pipelined steps over ``n_stages`` stages (the rest of the world
    as data replicas); the metrics and the parameters after."""
    from infodiffusion_tpu_torch.parallel.pp import (
        make_dp_stage_mesh,
        make_pp_train_step,
    )

    torch.set_num_threads(2)
    world = multihost.world_size()
    model = tiny_latent(state_dict).train()
    tx = make_optimizer(LR, 3, 4)
    state = create_train_state(model, SEED, tx, ema=True)
    mesh = make_dp_stage_mesh(world // n_stages, n_stages)
    step = make_pp_train_step(model, tx, mesh, microbatches, ema_decay=EMA,
                              deterministic_dropout_off=dropout_off)
    pipe = step.pipeline
    x = latent_batch()
    n = LATENT_BATCH // pipe.dp
    x = x[pipe.d * n:(pipe.d + 1) * n]
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, x, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "stage": pipe.s, "data": pipe.d,
            "layers": list(pipe.layers),
            "params": {k: v.detach().clone() for k, v in state.params.items()}}


# ---------------------------------------------------------------------------
# --sp: ring attention
# ---------------------------------------------------------------------------


def ring_inputs(B: int, N: int, C: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(B, N, C).astype(np.float32))
            for _ in range(4)]  # q, k, v and the output's cotangent


def ring_case(B: int, N: int, C: int, seed: int = 0,
              dtype=torch.float32):
    """Ring attention over the whole world on ``ring_inputs`` (cast to
    ``dtype``): the output and the q, k, v gradients (every rank holds them
    whole)."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, do = (x.to(dtype) for x in ring_inputs(B, N, C, seed))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = ring_attention(q, k, v, dist.group.WORLD)
    out.backward(do)
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def ring_battery(shape, min_tokens: int):
    """``ring_case`` in f32 and bf16 at ``shape``, and ``sp_unet_grads``."""
    torch.set_num_threads(2)
    return {"f32": ring_case(*shape), "bf16": ring_case(
        *shape, dtype=torch.bfloat16), "unet": sp_unet_grads(min_tokens)}


def deep_unet():
    """The vanilla UNet of JAX's deep-attention-level regression: ch 32,
    ch_mult (1, 2, 2), attention at level 2 (also the middle blocks'
    resolution), 16x16 inputs: 16 tokens there."""
    from infodiffusion_tpu_torch.models.unet import UNet

    torch.manual_seed(4)
    model = UNet(T=8, ch=32, ch_mult=(1, 2, 2), attn=(2,), num_res_blocks=1,
                 out_ch=1)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(2, 16, 16, 1).astype(np.float32))
    return model, x, torch.full((2,), 3, dtype=torch.long)


def unet_grads(model, x, t):
    loss = model(x, t).square().mean()
    params = list(model.parameters())
    return {n: g for (n, _), g in zip(model.named_parameters(),
                                      torch.autograd.grad(loss, params))}


def sp_unet_grads(min_tokens: int):
    """The deep UNet's parameter gradients with ring attention over the
    whole world from ``min_tokens`` tokens; every rank's."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel.sp import sp_scope

    from infodiffusion_tpu_torch.parallel.ring_attention import ring_attention

    torch.set_num_threads(2)
    model, x, t = deep_unet()
    with sp_scope(dist.group.WORLD, min_tokens=min_tokens):
        grads = unet_grads(model, x, t)
    return {"grads": grads, "ring_calls": ring_attention.calls}


# ---------------------------------------------------------------------------
# sampling split over the data ranks
# ---------------------------------------------------------------------------

SAMPLE_CFG = dict(model="diff", mode="eval", prior="regular", a_dim=4,
                  dataset="mnist", diffusion_steps=8, input_size=8,
                  input_channels=1)
# (name, batch, DDIM steps or None for the full DDPM grid)
SAMPLE_CASES = (("ddpm", 4, None), ("ddim", 4, 4), ("indivisible", 3, 4))


def sample_all(group=None):
    """Every SAMPLE_CASES batch, from generators seeded 11 + case index."""
    from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess

    model = tiny_infodiff().eval()
    cfg = Config(**SAMPLE_CFG)
    process = DiffusionProcess(cfg, model, group=group, shape=(1, 8, 8))
    out = {}
    for i, (name, n, steps) in enumerate(SAMPLE_CASES):
        gen = torch.Generator().manual_seed(11 + i)
        out[name] = process.sampling(gen, sampling_number=n,
                                     num_steps=steps)
    return out


def sampling_case():
    import warnings

    import torch.distributed as dist

    torch.set_num_threads(2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = sample_all(dist.group.WORLD)
    out["warnings"] = [str(w.message) for w in caught]
    return out


def pp_battery(state_dict, x, t, eps, configs):
    """For each (stages, microbatches) of ``configs`` over this world: the
    pipelined forward of ``x`` at ``t`` (this rank's rows), the loss and
    its gradient against ``eps`` (dropout off), and STEPS train steps with
    dropout off and on."""
    from infodiffusion_tpu_torch.parallel.pp import (
        Pipeline,
        latent_pp_forward,
        make_dp_stage_mesh,
        pp_loss_and_grads,
    )

    torch.set_num_threads(2)
    world = multihost.world_size()
    out = {}
    for S, M in configs:
        model = tiny_latent(state_dict).train()
        mesh = make_dp_stage_mesh(world // S, S)
        pipe = Pipeline(mesh, M)
        n = x.shape[0] // pipe.dp
        rows = slice(pipe.d * n, (pipe.d + 1) * n)
        fwd = latent_pp_forward(model.backbone, x[rows], t[rows], mesh, M)
        loss, grads = pp_loss_and_grads(model, pipe, x[rows], t[rows],
                                        eps[rows])
        out[(S, M)] = {
            "d": pipe.d, "s": pipe.s, "fwd": fwd, "loss": float(loss),
            "grads": {k: g for (k, _), g in zip(model.named_parameters(),
                                                grads)},
            "steps": {off: pp_steps(S, M, off, state_dict)
                      for off in (True, False)}}
    return out
