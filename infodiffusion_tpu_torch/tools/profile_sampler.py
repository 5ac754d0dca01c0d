"""Profile the flagship InfoDiff's DDIM sampler on the card with
torch.profiler: writes ``<trace_dir>/trace.json`` and prints
``trace_summary``'s summary of it.

    python -m infodiffusion_tpu_torch.tools.profile_sampler [trace_dir]
        [--device cpu]
    INFODIFF_BENCH_BATCH=128 INFODIFF_BENCH_STEPS=100 \\
        INFODIFF_BENCH_SIZE=64 INFODIFF_TURBO=int8 python -m ...

The model is the CelebA-64 InfoDiff (AuxiliaryUNet ch 64, ch_mult
(1,2,2,2), a_dim 256, T 1000) at ``INFODIFF_BENCH_SIZE`` pixels in bf16
with its initializers' weights (torch seed 0); xT and a are a numpy draw
(seed 0). ``INFODIFF_TURBO=int8`` calibrates and samples the W8A8 tier
(``DiffusionProcess(turbo='int8')``). One sampling run warms up, the next
is captured (``trace_summary.capture``). The counterpart of the JAX
package's ``tools/profile_sampler.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import (
    A_DIM,
    bench_env,
    flagship_config,
    resolve_device,
)
from infodiffusion_tpu_torch.tools.trace_summary import (
    capture,
    summarize_file,
)


def main(out: str = "trace_sampler", device=None, batch: Optional[int] = None,
         steps: Optional[int] = None, size: Optional[int] = None,
         turbo: Optional[str] = None, top: int = 20) -> dict:
    """Capture one DDIM run of ``steps`` steps at batch ``batch`` and
    ``size`` pixels (defaults from the environment); print and return its
    wall time and the summary of its trace."""
    device = resolve_device(device)
    batch = batch or bench_env("BATCH", 128)
    steps = steps or bench_env("STEPS", 100)
    size = size or bench_env("SIZE", 64)
    turbo = os.environ.get("INFODIFF_TURBO", "") if turbo is None else turbo
    cfg = flagship_config(size)
    torch.manual_seed(0)
    net = build_model(cfg, dtype=torch.bfloat16, device=device).eval()
    rng = np.random.RandomState(0)
    xT = torch.from_numpy(rng.randn(batch, size, size, 3).astype(
        np.float32)).to(device)
    a = torch.from_numpy(rng.randn(batch, A_DIM).astype(np.float32)).to(
        device)
    proc = DiffusionProcess(cfg, net, turbo=turbo or None)
    with torch.no_grad():
        wall = capture(lambda: proc.sampling(xT=xT, a=a, num_steps=steps),
                       device, out)
    row = {"program": "ddim", "batch": batch, "steps": steps, "size": size,
           "turbo": turbo or None, "device": str(device), "wall_ms": wall,
           "summary": summarize_file(out, top)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace_dir", nargs="?", default="trace_sampler")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args()
    main(args.trace_dir, args.device)
