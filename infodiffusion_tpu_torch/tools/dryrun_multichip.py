"""A dry run of every parallel layout on N ranks (the port's twin of the
JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m infodiffusion_tpu_torch.tools.dryrun_multichip --n 2

Spawns N ranks (``parallel/launch.py``): N cards over NCCL where this
machine has N, else N CPU processes over gloo. On a small InfoDiff (the
JAX dry run's: T 8, a_dim 8, 16x16, ch 32, MMD and KLD on) and a small
latent prior it checks, against one process:

- data parallel: the losses of ``--steps`` steps, step for step (within
  1e-4, the JAX dry run's bar);
- FSDP (every parameter of at least 256 elements split): the loss
  (1e-3), each split parameter's piece 1/N of it, and the per-rank state
  bytes (parameters, moments, EMA) below 0.6 of data parallel's;
- TP + FSDP on an (N/2, 2) mesh where N is even: the loss (1e-3);
- GPipe over N stages, and (N >= 4) N/2 pipelines of 2 stages: the forward
  (1e-5) and the gradients (1e-4) of the latent prior's loss;
- ring attention over the N ranks: forward (1e-5) and gradients (1e-4)
  against dense attention;
- DDIM-4 sampling split over the N ranks against one process (1e-5: the
  model runs on fewer rows a rank, which may change the conv's summation
  order).

Prints one line a check and, last, a JSON summary; exits non-zero when a
check fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

DP_TOL, LAYOUT_TOL, FWD_TOL, GRAD_TOL = 1e-4, 1e-3, 1e-5, 1e-4
MIN_SIZE = 256  # the JAX dry run's min_size for FSDP and TP


def _infodiff():
    from infodiffusion_tpu_torch.models.wrappers import InfoDiff

    torch.manual_seed(0)
    return InfoDiff(T=8, a_dim=8, shape=(1, 16, 16), unets_channels=32,
                    encoder_channels=32, mmd_weight=0.1, kld_weight=0.01,
                    epochs=2).train()


def _batch(n: int, device) -> torch.Tensor:
    rs = np.random.RandomState(0)
    return torch.from_numpy(rs.randn(2 * n, 16, 16, 1).astype(np.float32)
                            ).to(device)


def _run(model, device, steps, mesh=None, layout_kw=None):
    """(losses, layout, state) of ``steps`` steps, on a layout when
    ``mesh`` is given."""
    from infodiffusion_tpu_torch.parallel.layout import Layout
    from infodiffusion_tpu_torch.parallel.mesh import shard_batch
    from infodiffusion_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )
    from infodiffusion_tpu_torch.train.step import make_train_step

    import torch.distributed as dist

    model = model.to(device)
    tx = make_optimizer(1e-4, 2, 4)
    state = create_train_state(model, 0, tx, ema=True)
    x = _batch(dist.get_world_size(), device)
    layout = None
    if mesh is not None:
        layout = Layout.for_model(model, mesh, **(layout_kw or {}))
        state = layout.shard_state(model, state)
        x = shard_batch(mesh, x)
    step = make_train_step(model, tx, ema_decay=0.9, layout=layout)
    losses = []
    for i in range(steps):
        state, m = step(state, x, i)
        losses.append(float(m["loss"]))
    return losses, layout, state


def _pp(device, n_data, n_stages):
    """Max errors of the pipelined forward and gradients against the
    sequential latent prior on the same weights and draws."""
    from infodiffusion_tpu_torch.models.wrappers import Diff
    from infodiffusion_tpu_torch.parallel.pp import (
        Pipeline,
        latent_pp_forward,
        make_dp_stage_mesh,
        pp_loss_and_grads,
    )

    torch.manual_seed(1)
    model = Diff(T=16, shape=(1, 8, 8), is_latent=True).to(device)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(16, 8, generator=g).to(device)
    t = torch.randint(0, 16, (16,), generator=g).to(device)
    eps = torch.randn(16, 8, generator=g).to(device)
    want_out = model(x, t)
    want_loss, _ = model.loss_fn(x, t=t, eps=eps, deterministic=True)
    want = torch.autograd.grad(want_loss, list(model.parameters()))
    mesh = make_dp_stage_mesh(n_data, n_stages)
    pipe = Pipeline(mesh, 2 * n_stages)
    rows = slice(pipe.d * 16 // n_data, (pipe.d + 1) * 16 // n_data)
    out = latent_pp_forward(model.backbone, x[rows], t[rows], mesh,
                            pipe.M)
    loss, grads = pp_loss_and_grads(model, pipe, x[rows], t[rows], eps[rows])
    return ((out - want_out[rows]).abs().max().item(),
            abs(loss.item() - want_loss.item()),
            max((a - b).abs().max().item() for a, b in zip(grads, want)))


def _ring(device):
    import torch.distributed as dist

    from infodiffusion_tpu_torch.ops.attention import single_head_attention
    from infodiffusion_tpu_torch.parallel.ring_attention import ring_attention

    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 64, 16, generator=g).to(device)
                   for _ in range(4))
    grads = []
    for fn in (lambda *a: ring_attention(*a, dist.group.WORLD),
               single_head_attention):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*qkv)
        out.backward(do)
        grads.append((out.detach(), *[x.grad for x in qkv]))
    errs = [(a - b).abs().max().item() for a, b in zip(*grads)]
    return errs[0], max(errs[1:])


def _ddim(device):
    import torch.distributed as dist

    from infodiffusion_tpu_torch.config import Config
    from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess

    cfg = Config(model="diff", mode="eval", prior="regular", a_dim=8,
                 dataset="mnist", diffusion_steps=8, input_size=16,
                 input_channels=1)
    model = _infodiff().to(device).eval()
    n = 2 * dist.get_world_size()
    out = []
    for group in (dist.group.WORLD, None):
        gen = torch.Generator(device=device).manual_seed(5)
        out.append(DiffusionProcess(cfg, model, shape=(1, 16, 16),
                                    group=group).sampling(
            gen, sampling_number=n, num_steps=4))
    return (out[0] - out[1]).abs().max().item()


def _rank(steps: int):
    """Every check on this rank; returns {check: (value, bar, ok)}."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    torch.set_num_threads(2)
    res = {}
    ref, _, _ = _run(_infodiff(), device, steps)
    dp, dp_layout, dp_state = _run(_infodiff(), device, steps,
                                   make_mesh(world))
    res["dp losses, max diff over steps"] = (
        max(abs(a - b) for a, b in zip(ref, dp)), DP_TOL)
    fs, fs_layout, fs_state = _run(
        _infodiff(), device, 1, make_mesh(world),
        {"fsdp": True, "fsdp_min_size": MIN_SIZE})
    res["fsdp loss"] = (abs(fs[0] - ref[0]), LAYOUT_TOL)
    whole = dict(_infodiff().named_parameters())
    bad = [n for n, pl in fs_layout.placements.items() if pl.data is not None
           and fs_state.params[n].numel() * world != whole[n].numel()]
    res["fsdp pieces not 1/N"] = (len(bad), 0)
    frac = fs_layout.state_bytes(fs_state) / dp_layout.state_bytes(dp_state)
    res["fsdp state bytes / dp"] = (frac, 0.6)
    if world % 2 == 0:
        tp, _, _ = _run(_infodiff(), device, 1,
                        make_mesh(world, model_parallel=2),
                        {"fsdp": True, "fsdp_min_size": MIN_SIZE,
                         "tp_min_size": MIN_SIZE})
        res["tp+fsdp loss"] = (abs(tp[0] - ref[0]), LAYOUT_TOL)
    layouts = [(1, world)] if 8 % world == 0 else []
    if world >= 4 and world % 2 == 0:
        layouts.append((world // 2, 2))
    for n_data, n_stages in layouts:
        fwd, loss, grad = _pp(device, n_data, n_stages)
        tag = f"pp {n_data}x{n_stages}"
        res[f"{tag} forward"] = (fwd, FWD_TOL)
        res[f"{tag} loss"] = (loss, FWD_TOL)
        res[f"{tag} gradients"] = (grad, GRAD_TOL)
    fwd, grad = _ring(device)
    res["sp ring forward"] = (fwd, FWD_TOL)
    res["sp ring gradients"] = (grad, GRAD_TOL)
    res["sharded ddim-4"] = (_ddim(device), FWD_TOL)
    return {k: (float(v), bar, v <= bar) for k, (v, bar) in res.items()}


def dryrun_multichip(n: int, steps: int = 10, timeout: float = 600.0,
                     workdir: str | None = None) -> dict:
    """Run every check on ``n`` ranks; returns rank 0's results and
    raises AssertionError when one fails."""
    from infodiffusion_tpu_torch.parallel.launch import spawn

    nccl = torch.cuda.is_available() and torch.cuda.device_count() >= n
    with tempfile.TemporaryDirectory(dir=workdir) as work:
        results = spawn("infodiffusion_tpu_torch.tools.dryrun_multichip:_rank",
                        n, {"steps": steps},
                        workdir=work, timeout=timeout,
                        backend="nccl" if nccl else "gloo")
    res = results[0]
    for r in results[1:]:
        if {k: v[2] for k, v in r.items()} != {k: v[2]
                                              for k, v in res.items()}:
            raise AssertionError("the ranks' verdicts differ")
    failed = [k for k, (_, _, ok) in res.items() if not ok]
    if failed:
        raise AssertionError(f"dry run failed: {failed}: "
                             f"{ {k: res[k] for k in failed} }")
    return {"ranks": n, "backend": "nccl" if nccl else "gloo", "checks": res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2, help="ranks")
    ap.add_argument("--steps", type=int, default=10,
                    help="data-parallel steps compared with one process")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    try:
        out = dryrun_multichip(args.n, args.steps, args.timeout)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    for k, (v, bar, ok) in out["checks"].items():
        print(f"[dryrun {out['ranks']} ranks, {out['backend']}] {k}: "
              f"{v:.3e} (bar {bar:g}) {'ok' if ok else 'FAILED'}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
