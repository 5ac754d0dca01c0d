"""Training rate of one model at the CelebA-64 widths: imgs/s of
``make_train_step`` and, with ``--profile``, one step's device time by
kernel (torch.profiler).

    python -m infodiffusion_tpu_torch.tools.train_rate --model vae \\
        [--batch 64] [--steps 10] [--repeats 3] [--profile]

Each repeat times ``steps`` steps after one warm-up step, on the host clock
synchronised on both ends. The weights are the model's initializers' (torch
seed 0), the images a numpy draw (seed 0), the learning rate and schedule
``bench.py``'s train mode's. Prints one JSON line per repeat and one for
the profile. ``--device cpu`` runs the kernels' plain versions. The file
also runs as a script (``python path/to/train_rate.py``), which times the
package that ``PYTHONPATH`` names: another checkout's, with the same steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import resolve_device
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import make_train_step

MODELS = ("diff", "vanilla", "vae")  # the InfoDiff, the vanilla Diff, the VAE


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_step(run, device: torch.device, top: int = 8) -> dict:
    """Device and wall ms of one ``run()`` (after a warm-up), the kernels
    that took the most device time, from torch.profiler's device events,
    and the device ms of K1's family (the kernels named for adagn, forward
    and backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    stats = [(e.self_device_time_total / 1e3, e.key)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    busy = sum(ms for ms, _ in stats)
    return {"device_ms": busy, "wall_ms": wall,
            "idle": 1 - busy / wall if wall > 0 else None,
            "adagn_ms": sum(ms for ms, key in stats if "adagn" in key),
            "kernels": [[key[:80], ms] for ms, key in
                        sorted(stats, reverse=True)[:top] if ms > 0]}


def main(model: str = "vae", device=None, batch: int = 64, steps: int = 10,
         repeats: int = 3, profile: bool = False, size: int = 64) -> list:
    """Time ``repeats`` runs of ``steps`` training steps of ``model`` at
    ``size`` pixels and batch ``batch``; print and return one dict a repeat
    (and, with ``profile``, one more for a profiled step)."""
    device = resolve_device(device)
    if profile and device.type != "cuda":
        raise ValueError("--profile reads the card's device time")
    cfg = dataclasses.replace(Config(
        model=model, dataset="celeba", a_dim=256,
        diffusion_steps=1000).with_dataset_config(), input_size=size)
    torch.manual_seed(0)
    net = build_model(cfg, dtype=torch.bfloat16, device=device).train()
    tx = make_optimizer(1e-4, 50, 1000)
    state = create_train_state(net, seed=0, tx=tx)
    step = make_train_step(net, tx)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        batch, size, size, cfg.input_channels).astype(np.float32)).to(device)
    state, _ = step(state, x, 0)  # warm-up: cuDNN plans, first launches
    rows = []
    for r in range(repeats):
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, x, 0)
        synchronize(device)
        dt = time.perf_counter() - t0
        row = {"model": model, "size": size, "batch": batch, "steps": steps,
               "repeat": r, "seconds": dt, "imgs_per_s": batch * steps / dt,
               "loss": float(metrics["loss"]), "device": str(device),
               "clock": "host, synchronised"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if profile:
        row = {"model": model, "size": size, "batch": batch,
               "profile": profile_step(lambda: step(state, x, 0), device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="vae", choices=MODELS)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    main(args.model, args.device, args.batch, args.steps, args.repeats,
         args.profile, args.size)
