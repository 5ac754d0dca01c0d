#!/usr/bin/env python3
"""Drive the torch port's generation and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port (``infodiffusion_tpu_torch``) still starts
on the card. Phases, each printing one line or a few, any failure raising:

1. device: a CUDA card, or exit non-zero (there is no CPU path); the card's
   name and power limit from nvidia-smi; TF32 off for the f32 phases.
2. build: the hand-written kernels in ``infodiffusion_tpu_torch/csrc``
   compiled with nvcc for sm_90a (build time, registers, spills).
3. kernels: K1 (adagn), K2 (attention) and K4 (latent trajectory) each
   against its plain PyTorch version on the card, at the shapes of the
   flagship CelebA-64 InfoDiff (AuxiliaryUNet ch 64, ch_mult (1,2,2,2),
   attention at level 2, a_dim 256, T 1000), with errors and CUDA-event
   times of both.
4. the slice, flagship size, bf16, random weights from a numpy seed:
   ``LatentDiffusionProcess.sampling`` (the full T=1000 latent trajectory,
   K4) then ``InfoDiffusionPipeline.generate(steps=100)`` (K1 and K2 in the
   UNet); checks shape, finiteness and that every kernel's launch count
   moved.
5. card against CPU: the same slice in f32 at batch 2 (T=1000 latents,
   then DDIM-10) with the same weights and draws, kernels on the card
   against the plain versions on the CPU.
6. training kernels: the K1 backward at every GroupNorm site of one
   training forward (backbone and Encoder; 64px at B=128 and 128px at
   B=64), K3a (flash forward) at N=1024 B=64 and K3b (flash backward) at
   N=1024 B=64, N=256 B=128 and N=64 B=128, each against its plain
   version in f32 and bf16, with errors and CUDA-event times of both.
7. the training slice, bf16, dropout on, random weights from a numpy
   seed: ``create_train_state`` and ``make_train_step`` on the flagship
   InfoDiff (AuxiliaryUNet + Encoder, mmd 0.1, epochs 50) at 64px B=128
   (1 warm-up step, 5 timed) and at 128px B=64 (1 + 3): imgs/s, loss,
   grad norm, peak memory; checks a finite loss, that every parameter in
   the loss has a non-zero gradient and moved, and the launch counts.
8. card against CPU, training: f32, 128px, B=2, the same weights and
   injected draws, ``deterministic=True``: the loss and every gradient
   leaf, then every parameter after one optimizer step on each device
   from the same (the CPU's) gradients.

The line before the last is one JSON object with each kernel's launches
(summed over the counted runs of the main paths, and per path), error and
bf16 times; the last is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import time

import numpy as np
import torch

from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import LatentDiffusionProcess
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff
from infodiffusion_tpu_torch.nn.attention import _GN
from infodiffusion_tpu_torch.nn.blocks import _GNParams
from infodiffusion_tpu_torch.ops.cuda import latent_traj as K4
from infodiffusion_tpu_torch.ops.cuda.adagn import (
    adagn_bwd_cuda,
    adagn_bwd_reference,
    adagn_cuda,
    adagn_reference,
)
from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)
from infodiffusion_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_reference,
    flash_attention_cuda,
)
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.library import library
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import (
    loss_and_grads,
    make_train_step,
    step_rngs,
)

A_DIM, T, SIZE = 256, 1000, 64
# bench.py's flagship DDIM-100 batch; the kernels are checked at the
# shapes the end-to-end run gives them
BATCH = 128
# the training runs: (image size, batch, timed steps), bench.py's train
# mode at 64px and at 128px
TRAIN_RUNS = ((64, 128, 5), (128, 64, 3))
LR = 1e-4  # bench.py's learning rate (the first step's, sched(0))
# parameters outside the loss at mmd 0.1, kld 0: zero gradient, and the
# 1e-4 x 1e-5 decay does not move an f32 value
NO_GRAD_PARAMS = {f"encoder.{m}.{p}" for m in ("fc_mu", "fc_var")
                  for p in ("weight", "bias")}
# the kernels of the generation path
GENERATION_KERNELS = ("adagn", "attention", "latent_traj")
# per-leaf comparisons take each leaf's max abs, floored at this share of
# the largest leaf's: some leaves are zero up to f32 noise (the key
# projection's bias under the softmax)
NOISE_FLOOR = 1e-4
# max |kernel - plain| / max |plain|: f32 differs by summation order only;
# bf16 by one rounding of the output (K1) or of the softmax weights (K2);
# K4 compounds the same over 1000 steps
TOL = {"f32": 1e-4, "bf16": 2e-2, "traj_f32": 1e-4, "traj_bf16": 1e-2,
       "slice": 2e-3}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

KERNELS = {
    "adagn": dict(fn=adagn_cuda, route="cuda",
                  source="infodiffusion_tpu_torch/csrc/adagn.cu",
                  replaces="infodiffusion_tpu/ops/pallas/adagn.py:90"),
    "attention": dict(fn=attention_cuda, route="cuda",
                      source="infodiffusion_tpu_torch/csrc/attention.cu",
                      replaces="infodiffusion_tpu/ops/pallas/attention.py:49"),
    "latent_traj": dict(fn=K4.latent_trajectory_cuda, route="cuda",
                        source="infodiffusion_tpu_torch/csrc/latent_traj.cu",
                        replaces="infodiffusion_tpu/ops/pallas/"
                                 "latent_traj.py:390"),
    "adagn_bwd": dict(fn=adagn_bwd_cuda, route="cuda",
                      source="infodiffusion_tpu_torch/csrc/adagn_bwd.cu",
                      replaces="XLA autodiff of "
                               "infodiffusion_tpu/ops/norm.py:293 (adagn)"),
    "flash_attention": dict(
        fn=flash_attention_cuda, route="cuda",
        source="infodiffusion_tpu_torch/csrc/flash_attention.cu",
        replaces="infodiffusion_tpu/ops/pallas/flash_attention.py:274"),
    "flash_attention_bwd": dict(
        fn=flash_attention_bwd_cuda, route="cuda",
        source="infodiffusion_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="infodiffusion_tpu/ops/pallas/flash_attention.py:315"),
}


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max abs error / max |want|), in f64 on the host."""
    got = got.detach().double().cpu()
    want = want.detach().double().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values")
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel, plain, reps: int):
    """Kernel and plain times taken in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def init_weights_(model: torch.nn.Module, seed: int,
                  bias_std: float = 0.0) -> torch.nn.Module:
    """Xavier-uniform weights (the tail conv included, so eps is not ~0),
    unit norm scales and biases of std ``bias_std``, all from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                receptive = int(np.prod(p.shape[2:]))
                fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(
                    (bias_std * rng.randn(*p.shape)).astype(np.float32)))
            else:
                p.fill_(1.0)
    return model


def flagship(dtype, device, seed=0):
    cfg = Config(model="diff", dataset="celeba", a_dim=A_DIM,
                 diffusion_steps=T, deterministic=True).with_dataset_config()
    img = InfoDiff(T=T, a_dim=A_DIM, shape=cfg.shape,
                   unets_channels=cfg.unets_channels, dtype=dtype)
    lat = Diff(T=T, shape=cfg.latent_shape, dtype=dtype)
    init_weights_(img, seed)
    init_weights_(lat, seed + 1)
    return cfg, img.to(device).eval(), lat.to(device).eval()


def train_model(dtype, device, size, seed=0, bias_std=0.0):
    """The flagship InfoDiff as bench.py's train mode builds it (mmd 0.1,
    kld 0, epochs 50) for ``size``-pixel images."""
    model = InfoDiff(T=T, a_dim=A_DIM, shape=(3, size, size),
                     unets_channels=64, encoder_channels=64, mmd_weight=0.1,
                     epochs=50, dtype=dtype)
    return init_weights_(model, seed, bias_std).to(device)


def zero_draws(n, size, device):
    """Injected draws for a deterministic loss at batch ``n``."""
    return dict(t=torch.zeros(n, dtype=torch.long, device=device),
                eps=torch.zeros(n, size, size, 3, device=device),
                reparam_eps=torch.zeros(n, A_DIM, device=device),
                prior_samples=torch.zeros(n, A_DIM, device=device))


# ------------------------------------------------------------------ phases


def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for cuDNN convs and matmuls")
    return smi


def build() -> None:
    t0 = time.perf_counter()
    lib = library()
    lines = lib.build_log.splitlines()
    regs = [int(w) for line in lines if "Used" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills = [line.strip() for line in lines
              if any(int(n) for n in re.findall(r"(\d+) bytes spill", line))]
    print(f"[build] nvcc {lib.build_seconds:.1f} s (load "
          f"{time.perf_counter() - t0:.1f} s); {len(regs)} kernels, max "
          f"{max(regs) if regs else '?'} registers; spills: "
          f"{spills if spills else 'none'}")


def adagn_sites(model, run):
    """(HW, C, K) of every GroupNorm site that ``run()``, one forward of
    ``model``, hits."""
    sites = set()

    def hook(mod, args, kwargs):
        x = args[0]
        if isinstance(mod, _GN):  # NHWC
            hw, c = x.shape[1] * x.shape[2], x.shape[3]
        else:                     # NCHW
            hw, c = x.shape[2] * x.shape[3], x.shape[1]
        sites.add((hw, c, len(kwargs.get("films", ()))))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, (_GN, _GNParams))]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return sorted(sites)


def check_adagn(sites, device, reps, results):
    g = torch.Generator(device=device).manual_seed(1)
    B = BATCH
    for tag, dtype in DTYPES.items():
        ms = plain_ms = 0.0
        for hw, c, k in sites:
            x = (torch.randn(B, hw, c, generator=g, device=device) * 2 + 0.5
                 ).to(dtype)
            gamma = 1 + 0.1 * torch.randn(c, generator=g, device=device)
            beta = 0.1 * torch.randn(c, generator=g, device=device)
            films = [tuple(torch.randn(B, c, generator=g, device=device)
                           .to(dtype) for _ in range(2)) for _ in range(k)]
            args = (x, 32, gamma, beta, films)
            got = adagn_cuda(*args)
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, adagn_reference(*args))
            km, pm = paired_ms(lambda: adagn_cuda(*args),
                               lambda: adagn_reference(*args), reps)
            ms, plain_ms = ms + km, plain_ms + pm
            print(f"[K1 adagn] {tag} B={B} HW={hw} C={c} K={k}: rel err "
                  f"{rel_e:.2e} (abs {abs_e:.2e}); {km:.4f} ms vs plain "
                  f"{pm:.4f} ms")
            results.record("adagn", tag, abs_e, rel_e, TOL[tag])
        print(f"[K1 adagn] {tag}: all {len(sites)} sites, one call each: "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        results.time("adagn", tag, ms, plain_ms)


def check_attention(device, reps, results):
    g = torch.Generator(device=device).manual_seed(2)
    for tag, dtype in DTYPES.items():
        ms = plain_ms = 0.0
        for n in (256, 64):
            q, k, v = (torch.randn(BATCH, n, 128, generator=g,
                                   device=device).to(dtype) for _ in range(3))
            got = attention_cuda(q, k, v)
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, attention_reference(q, k, v))
            km, pm = paired_ms(lambda: attention_cuda(q, k, v),
                               lambda: attention_reference(q, k, v), reps)
            ms, plain_ms = ms + km, plain_ms + pm
            print(f"[K2 attention] {tag} B={BATCH} N={n} C=128: rel "
                  f"err {rel_e:.2e} (abs {abs_e:.2e}); {km:.4f} ms vs plain "
                  f"{pm:.4f} ms")
            results.record("attention", tag, abs_e, rel_e, TOL[tag])
        results.time("attention", tag, ms, plain_ms)


def check_latent_traj(lat_models, device, reps, results):
    g = torch.Generator(device=device).manual_seed(3)
    sched = make_schedule(1e-5, 1e-2, T, device)
    for tag, model in lat_models.items():
        packed = pack_latent_unet_params(model.backbone, A_DIM,
                                         dtype=DTYPES[tag])
        xT = torch.randn(BATCH, A_DIM, generator=g, device=device)
        args = K4.trajectory_inputs(packed, sched, xT, g, deterministic=True)
        got = K4.latent_trajectory_cuda(*args)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, K4.latent_trajectory_reference(*args))
        km, pm = paired_ms(lambda: K4.latent_trajectory_cuda(*args),
                           lambda: K4.latent_trajectory_reference(*args), reps)
        print(f"[K4 latent_traj] {tag} weights, B={BATCH} d={A_DIM} "
              f"S={T}: rel err {rel_e:.2e} (abs {abs_e:.2e}); {km:.2f} ms "
              f"vs plain {pm:.2f} ms")
        results.record("latent_traj", tag, abs_e, rel_e, TOL["traj_" + tag])
        results.time("latent_traj", tag, km, pm)


# ------------------------------------------------------- training phases


def train_sites(device):
    """{size: (batch, sites)}: the (HW, C, K) of every GroupNorm site one
    training forward (backbone and Encoder) hits, per training run."""
    out = {}
    for size, batch, _ in TRAIN_RUNS:
        model = train_model(torch.float32, device, size)
        x = torch.zeros(1, size, size, 3, device=device)
        draws = zero_draws(1, size, device)
        out[size] = (batch, adagn_sites(model, lambda: model.loss_fn(
            x, deterministic=True, **draws)))
        del model
    return out


def check_adagn_bwd(sites_by_size, device, reps, results):
    g = torch.Generator(device=device).manual_seed(4)
    names = ("dx", "dgamma", "dbeta")
    for tag, dtype in DTYPES.items():
        ms = plain_ms = 0.0
        n = 0
        for size, (B, sites) in sites_by_size.items():
            for hw, c, k in sites:
                x = (torch.randn(B, hw, c, generator=g, device=device) * 2
                     + 0.5).to(dtype)
                dy = torch.randn(B, hw, c, generator=g, device=device).to(dtype)
                gamma = 1 + 0.1 * torch.randn(c, generator=g, device=device)
                beta = 0.1 * torch.randn(c, generator=g, device=device)
                films = [tuple(torch.randn(B, c, generator=g, device=device)
                               .to(dtype) for _ in range(2)) for _ in range(k)]
                _, stats = adagn_cuda(x, 32, gamma, beta, films,
                                      return_stats=True)
                args = (x, dy, 32, gamma, beta, films)
                got = adagn_bwd_cuda(*args, stats)
                torch.cuda.synchronize()
                want = adagn_bwd_reference(*args)
                outs = list(zip(names, got[:3], want[:3])) + [
                    (f"d{w}{j}", a, b) for j, (gp, wp) in
                    enumerate(zip(got[3], want[3]))
                    for w, a, b in zip("sb", gp, wp)]
                worst = 0.0
                for what, a, b in outs:
                    abs_e, rel_e = rel_err(a, b)
                    results.record("adagn_bwd", f"{tag} {what}", abs_e, rel_e,
                                   TOL[tag])
                    worst = max(worst, rel_e)
                km, pm = paired_ms(lambda: adagn_bwd_cuda(*args, stats),
                                   lambda: adagn_bwd_reference(*args), reps)
                ms, plain_ms, n = ms + km, plain_ms + pm, n + 1
                print(f"[K1 bwd] {tag} {size}px B={B} HW={hw} C={c} K={k}: "
                      f"worst rel err {worst:.2e} over dx, dgamma, dbeta, "
                      f"dfilms; {km:.4f} ms vs plain {pm:.4f} ms")
                del x, dy, stats, got, want
        print(f"[K1 bwd] {tag}: all {n} training sites, one call each: "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        results.time("adagn_bwd", tag, ms, plain_ms)


def check_flash(device, reps, results):
    g = torch.Generator(device=device).manual_seed(5)
    for tag, dtype in DTYPES.items():
        B, N = 64, 1024
        q, k, v = (torch.randn(B, N, 128, generator=g, device=device)
                   .to(dtype) for _ in range(3))
        got = flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, attention_reference(q, k, v))
        results.record("flash_attention", tag, abs_e, rel_e, TOL[tag])
        km, pm = paired_ms(lambda: flash_attention_cuda(q, k, v),
                           lambda: attention_reference(q, k, v), reps)
        results.time("flash_attention", tag, km, pm)
        gflop = 4 * B * N * N * 128 / 1e9
        print(f"[K3a flash fwd] {tag} B={B} N={N} C=128: rel err {rel_e:.2e} "
              f"(abs {abs_e:.2e}); {km:.4f} ms vs plain {pm:.4f} ms "
              f"({gflop / km:.1f} TFLOP/s counting 4BN^2C)")
        ms = plain_ms = 0.0
        for B, N in ((64, 1024), (128, 256), (128, 64)):
            q, k, v, do = (torch.randn(B, N, 128, generator=g, device=device)
                           .to(dtype) for _ in range(4))
            got = flash_attention_bwd_cuda(q, k, v, do)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, do)
            errs = []
            for what, a, b in zip(("dq", "dk", "dv"), got, want):
                abs_e, rel_e = rel_err(a, b)
                results.record("flash_attention_bwd", f"{tag} {what}", abs_e,
                               rel_e, TOL[tag])
                errs.append(f"{what} {rel_e:.2e}")
            km, pm = paired_ms(
                lambda: flash_attention_bwd_cuda(q, k, v, do),
                lambda: flash_attention_bwd_reference(q, k, v, do), reps)
            ms, plain_ms = ms + km, plain_ms + pm
            print(f"[K3b flash bwd] {tag} B={B} N={N} C=128: rel err "
                  f"{', '.join(errs)}; {km:.4f} ms vs plain {pm:.4f} ms")
        results.time("flash_attention_bwd", tag, ms, plain_ms)


def leaf_errors(got: dict, want: dict):
    """Per-leaf max |got - want| over the leaf's max abs, floored at
    NOISE_FLOOR of the largest leaf's; leaves exactly zero in ``want`` must
    be exactly zero in ``got``. Returns {name: relative error}."""
    floor = NOISE_FLOOR * max(w.abs().max().item() for w in want.values())
    errs = {}
    for name, w in want.items():
        a = got[name].double().cpu()
        w = w.double().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite values")
        if not w.any():
            if a.any():
                raise AssertionError(f"{name}: zero on the CPU, not on the "
                                     f"card")
            errs[name] = 0.0
            continue
        errs[name] = ((a - w).abs().max() / max(w.abs().max().item(), floor)
                      ).item()
    return errs


def train_run(size, batch, steps, device, smi):
    """Drive ``make_train_step`` at ``size`` px; returns the launch counts
    of the timed steps."""
    model = train_model(torch.bfloat16, device, size)
    tx = make_optimizer(LR, 50, 1000)  # bench.py's train mode
    state = create_train_state(model, seed=0, tx=tx)
    step = make_train_step(model, tx)
    x = torch.from_numpy(np.random.RandomState(size).randn(
        batch, size, size, 3).astype(np.float32)).to(device)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, _ = step(state, x, 0)  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, x, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{size}px: non-finite metrics {metrics}")
    moved = {n for n, p in state.params.items() if not torch.equal(p, before[n])}
    if set(state.params) - moved != NO_GRAD_PARAMS:
        raise AssertionError(f"{size}px: parameters that did not move: "
                             f"{sorted(set(state.params) - moved)}")
    del before
    _, _, grads = loss_and_grads(model, x, 0, deterministic=False,
                                 rngs=step_rngs(0, state.step, device))
    zero = {n for (n, _), gr in zip(model.named_parameters(), grads)
            if not gr.any()}
    if zero != NO_GRAD_PARAMS:
        raise AssertionError(f"{size}px: zero gradients: {sorted(zero)}")
    del grads
    needed = ["adagn", "adagn_bwd", "attention", "flash_attention_bwd"]
    if size >= 128:
        needed.append("flash_attention")
    idle = [name for name in needed if launches[name] == 0]
    if idle:
        raise AssertionError(f"{size}px: kernels not launched: {idle}")
    print(f"[train bf16] {size}px B={batch}: {steps} steps {dt:.3f} s = "
          f"{batch * steps / dt:.2f} imgs/s (host clock, synchronised; "
          f"{smi}); loss {metrics['loss']:.5f}, grad_norm "
          f"{metrics['grad_norm']:.5f}, mmd {metrics['mmd']:.5f}; peak "
          f"memory {peak / 2**30:.2f} GiB; all {len(state.params)} "
          f"parameters but {len(NO_GRAD_PARAMS)} (fc_mu, fc_var) have a "
          f"non-zero gradient and moved; launches {launches}")
    return launches


def train_card_vs_cpu(device):
    n, size = 2, 128
    rng = np.random.RandomState(50)
    x = torch.from_numpy(rng.randn(n, size, size, 3).astype(np.float32))
    draws = dict(
        t=torch.tensor([3, 700]),
        eps=torch.from_numpy(rng.randn(n, size, size, 3).astype(np.float32)),
        reparam_eps=torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32)),
        prior_samples=torch.from_numpy(
            rng.randn(n, A_DIM).astype(np.float32)),
    )
    outs = {}
    for dev in (torch.device("cpu"), device):
        model = train_model(torch.float32, dev, size, seed=60, bias_std=0.1)
        loss, _, grads = loss_and_grads(
            model, x.to(dev), 0, deterministic=True,
            **{k: v.to(dev) for k, v in draws.items()})
        names = [name for name, _ in model.named_parameters()]
        grads = dict(zip(names, grads))
        # both devices step from the CPU's gradients: AdamW's first step
        # moves each element by about lr whatever its gradient's size, so
        # an element whose gradient is noise would step either way
        source = outs["cpu"][1] if outs else grads
        step_grads = [source[k].to(dev) for k in names]
        tx = make_optimizer(LR, 50, 1000)
        params = dict(model.named_parameters())
        tx.update(params, step_grads, tx.init(params))
        outs[dev.type] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                          {k: p.detach().cpu() for k, p in params.items()})
        del model, grads, params, step_grads
    (loss_g, grads_g, params_g), (loss_c, grads_c, params_c) = (
        outs["cuda"], outs["cpu"])
    _, loss_e = rel_err(loss_g, loss_c)
    g_errs = leaf_errors(grads_g, grads_c)
    p_errs = leaf_errors(params_g, params_c)
    worst = max(loss_e, max(g_errs.values()), max(p_errs.values()))
    g_name = max(g_errs, key=g_errs.get)
    p_name = max(p_errs, key=p_errs.get)
    print(f"[train card vs CPU] f32 {size}px B={n}, injected draws: loss rel "
          f"err {loss_e:.2e}; worst of {len(g_errs)} gradient leaves "
          f"{g_errs[g_name]:.2e} ({g_name}); "
          f"{sum(not grads_c[k].any() for k in grads_c)} leaves exactly zero "
          f"on both; worst parameter after one AdamW step from the same "
          f"gradients {p_errs[p_name]:.2e} ({p_name}) (bar "
          f"{TOL['slice']:.0e} per leaf)")
    if not worst <= TOL["slice"]:
        raise AssertionError(f"train card vs CPU: {worst:.3e} over "
                             f"{TOL['slice']:.0e}")

class Results:
    """Per-kernel errors and times; a check over its bar raises at once."""

    def __init__(self):
        self.err = {name: [0.0, 0.0] for name in KERNELS}
        self.ms = {}

    def record(self, name, tag, abs_e, rel_e, tol):
        if not rel_e <= tol:
            raise AssertionError(
                f"{name} {tag}: relative error {rel_e:.3e} over {tol:.1e}")
        e = self.err[name]
        e[0], e[1] = max(e[0], abs_e), max(e[1], rel_e)

    def time(self, name, tag, ms, plain_ms):
        self.ms[(name, tag)] = (ms, plain_ms)


def run_slice(cfg, img, lat, n, latent_gen, image_gen, *, steps,
              lat_noises=None, lat_xT=None, img_xT=None):
    latents = LatentDiffusionProcess(cfg, lat).sampling(
        latent_gen, sampling_number=n, xT=lat_xT, noises=lat_noises)
    pipe = InfoDiffusionPipeline(cfg, img)
    if img_xT is None:
        images = pipe.generate(n, a=latents, steps=steps,
                               generator=image_gen)
    else:
        images = pipe.process.sampling(xT=img_xT, a=latents,
                                       num_steps=steps).float()
    return latents, images


def end_to_end(device, smi):
    cfg, img, lat = flagship(torch.bfloat16, device)
    gen = torch.Generator(device=device)
    # warm-up (cuDNN plans, the first launches) outside the counted run
    run_slice(cfg, img, lat, BATCH, gen.manual_seed(10), None, steps=2)
    torch.cuda.synchronize()
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    t0 = time.perf_counter()
    latents = LatentDiffusionProcess(cfg, lat).sampling(
        gen.manual_seed(11), sampling_number=BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = InfoDiffusionPipeline(cfg, img).generate(
        BATCH, a=latents, steps=100, generator=gen.manual_seed(12))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    if tuple(images.shape) != (BATCH, SIZE, SIZE, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if tuple(latents.shape) != (BATCH, A_DIM):
        raise AssertionError(f"latents {tuple(latents.shape)}")
    if not (torch.isfinite(images).all() and torch.isfinite(latents).all()):
        raise AssertionError("non-finite output")
    idle = [name for name in GENERATION_KERNELS if launches[name] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    print(f"[slice bf16] B={BATCH}: latents (T={T}) {t1 - t0:.3f} s = "
          f"{BATCH / (t1 - t0):.2f} latents/s; DDIM-100 64px "
          f"{t2 - t1:.3f} s = {BATCH / (t2 - t1):.2f} samples/s "
          f"(host clock, synchronised; {smi}); images std "
          f"{images.std().item():.3f}; launches {launches}")
    return launches


def card_vs_cpu(device):
    n = 2
    rng = np.random.RandomState(20)
    lat_xT = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    noises = torch.from_numpy(rng.randn(T, n, A_DIM).astype(np.float32))
    img_xT = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    outs = {}
    for dev in (device, torch.device("cpu")):
        cfg, img, lat = flagship(torch.float32, dev, seed=30)
        outs[dev.type] = run_slice(
            cfg, img, lat, n, None, None, steps=10, lat_xT=lat_xT.to(dev),
            lat_noises=noises.to(dev), img_xT=img_xT.to(dev))
    errs = []
    for what, got, want in zip(("latents", "images"), outs["cuda"],
                               outs["cpu"]):
        abs_e, rel_e = rel_err(got, want)
        errs.append(f"{what} rel err {rel_e:.2e} (abs {abs_e:.2e})")
        if not rel_e <= TOL["slice"]:
            raise AssertionError(f"card vs CPU {what}: {rel_e:.3e} over "
                                 f"{TOL['slice']:.0e}")
    print(f"[card vs CPU] f32 B={n}, latents T={T} then DDIM-10: "
          f"{'; '.join(errs)} (bar {TOL['slice']:.0e})")


def main() -> None:
    smi = check_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build()
    results = Results()
    _, img32, _ = flagship(torch.float32, device)
    check_adagn(adagn_sites(img32, lambda: img32(
        torch.zeros(1, SIZE, SIZE, 3, device=device),
        torch.zeros(1, dtype=torch.long, device=device),
        torch.zeros(1, A_DIM, device=device))), device, 10, results)
    del img32
    check_attention(device, 10, results)
    lat_models = {tag: flagship(dtype, device)[2]
                  for tag, dtype in DTYPES.items()}
    check_latent_traj(lat_models, device, 1, results)
    del lat_models
    torch.cuda.empty_cache()
    by_path = {"generation": end_to_end(device, smi)}
    card_vs_cpu(device)
    check_adagn_bwd(train_sites(device), device, 5, results)
    check_flash(device, 5, results)
    torch.cuda.empty_cache()
    for size, batch, steps in TRAIN_RUNS:
        by_path[f"train_{size}px"] = train_run(size, batch, steps, device, smi)
        torch.cuda.empty_cache()
    train_card_vs_cpu(device)
    kernels = []
    for name, spec in KERNELS.items():
        ms, plain_ms = results.ms[(name, "bf16")]
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": results.err[name][0],
            "max_rel_err": results.err[name][1],
            "ms": ms, "plain_ms": plain_ms, "timed_dtype": "bf16",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
