"""Sampling rate of the int8 tier: samples/s of the flagship InfoDiff's
DDIM through the W8A8 UNet (``DiffusionProcess(turbo='int8')``) and, with
``--profile``, two steps' device time by kernel and the device's idle share
(torch.profiler).

    python -m infodiffusion_tpu_torch.tools.int8_rate [--batch 128] \\
        [--steps 100] [--repeats 2] [--profile]

The model is the CelebA-64 InfoDiff (AuxiliaryUNet ch 64, ch_mult
(1,2,2,2), a_dim 256, T 1000) in bf16 with its initializers' weights
(torch seed 0); xT and a are a numpy draw (seed 0). The route is the one
the environment selects: the int8 conv unless
``INFODIFF_ENABLE_FUSED_QCONV=1`` asks for K7. Each repeat times ``steps``
DDIM steps after a two-step warm-up, on the host clock synchronised on both
ends. Prints one JSON line per repeat and one for the profile.
``--device cpu`` runs the kernels' plain versions. The file also runs as a
script (``python path/to/int8_rate.py``), which times the package that
``PYTHONPATH`` names: another checkout's, with the same steps.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import (
    A_DIM,
    flagship_config,
    resolve_device,
    synchronize,
)
from infodiffusion_tpu_torch.tools.trace_summary import profile_step


def main(device=None, batch: int = 128, steps: int = 100, repeats: int = 2,
         profile: bool = False, size: int = 64) -> list:
    """Time ``repeats`` runs of ``steps`` int8 DDIM steps at ``size`` pixels
    and batch ``batch``; print and return one dict a repeat (and, with
    ``profile``, one more for two profiled steps)."""
    device = resolve_device(device)
    if profile and device.type != "cuda":
        raise ValueError("--profile reads the card's device time")
    cfg = flagship_config(size)
    torch.manual_seed(0)
    net = build_model(cfg, dtype=torch.bfloat16, device=device).eval()
    rng = np.random.RandomState(0)
    xT = torch.from_numpy(rng.randn(batch, size, size, 3).astype(
        np.float32)).to(device)
    a = torch.from_numpy(rng.randn(batch, A_DIM).astype(np.float32)).to(
        device)
    proc = DiffusionProcess(cfg, net, turbo="int8")  # calibrates
    with torch.no_grad():
        proc.sampling(xT=xT, a=a, num_steps=2)  # warm-up
        rows = []
        for r in range(repeats):
            synchronize(device)
            t0 = time.perf_counter()
            out = proc.sampling(xT=xT, a=a, num_steps=steps)
            synchronize(device)
            dt = time.perf_counter() - t0
            row = {"size": size, "batch": batch,
                   "steps": steps, "repeat": r, "seconds": dt,
                   "samples_per_s": batch / dt,
                   "finite": bool(torch.isfinite(out).all()),
                   "device": str(device), "clock": "host, synchronised"}
            print(json.dumps(row), flush=True)
            rows.append(row)
        if profile:
            prof = profile_step(
                lambda: proc.sampling(xT=xT, a=a, num_steps=2), device)
            row = {"size": size, "batch": batch,
                   "profile_steps": 2, "device_ms_per_step":
                   prof["device_ms"] / 2, "profile": prof}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    main(args.device, args.batch, args.steps, args.repeats,
         args.profile, args.size)
