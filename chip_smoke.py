#!/usr/bin/env python3
"""Drive the torch port's generation path once on one NVIDIA GPU.

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

The line before the last is one JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``. Imports
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
from infodiffusion_tpu_torch.ops.cuda.adagn import adagn_cuda, adagn_reference
from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
)
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.library import library
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline

A_DIM, T, SIZE = 256, 1000, 64
# bench.py's flagship DDIM-100 batch; the kernels are checked at the
# shapes the end-to-end run gives them
BATCH = 128
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


def init_weights_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Xavier-uniform weights (the tail conv included, so eps is not ~0),
    unit norm scales and zero biases, all from a numpy seed."""
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
                p.zero_()
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


def adagn_sites(model, device):
    """(HW, C, K) of every GroupNorm site one UNet forward hits."""
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
        model(torch.zeros(1, SIZE, SIZE, 3, device=device),
              torch.zeros(1, dtype=torch.long, device=device),
              torch.zeros(1, A_DIM, device=device))
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
    idle = [name for name, n in launches.items() if n == 0]
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
    check_adagn(adagn_sites(img32, device), device, 10, results)
    del img32
    check_attention(device, 10, results)
    lat_models = {tag: flagship(dtype, device)[2]
                  for tag, dtype in DTYPES.items()}
    check_latent_traj(lat_models, device, 1, results)
    del lat_models
    torch.cuda.empty_cache()
    launches = end_to_end(device, smi)
    card_vs_cpu(device)
    kernels = []
    for name, spec in KERNELS.items():
        ms, plain_ms = results.ms[(name, "bf16")]
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[name],
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
