"""Profile the flagship train step on the card with torch.profiler (the
InfoDiff's whole loss: backbone and Encoder forward and backward, the MMD,
the clip and AdamW): writes ``<trace_dir>/trace.json`` and prints
``trace_summary``'s summary of it.

    python -m infodiffusion_tpu_torch.tools.profile_train [trace_dir]
        [--device cpu]
    INFODIFF_BENCH_BATCH=128 INFODIFF_BENCH_SIZE=64 INFODIFF_REMAT=1 ...

The model is the CelebA-64 InfoDiff (mmd 0.1, epochs 50) at
``INFODIFF_BENCH_SIZE`` pixels in bf16 with its initializers' weights
(torch seed 0), the images a numpy draw (seed 0), the learning rate and
schedule ``bench.py``'s train mode's. One step warms up, the next is
captured (``trace_summary.capture``). The counterpart of the JAX
package's ``tools/profile_train.py``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import (
    bench_env,
    flagship_config,
    resolve_device,
)
from infodiffusion_tpu_torch.tools.trace_summary import (
    capture,
    summarize_file,
)
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import make_train_step


def main(out: str = "trace_train", device=None, batch: Optional[int] = None,
         size: Optional[int] = None, top: int = 20) -> dict:
    """Capture one train step at batch ``batch`` and ``size`` pixels
    (defaults from the environment); print and return its wall time and the
    summary of its trace."""
    device = resolve_device(device)
    batch = batch or bench_env("BATCH", 128)
    size = size or bench_env("SIZE", 64)
    cfg = flagship_config(size)
    torch.manual_seed(0)
    net = build_model(cfg, dtype=torch.bfloat16, device=device).train()
    tx = make_optimizer(1e-4, 50, 1000)
    state = create_train_state(net, seed=0, tx=tx)
    step = make_train_step(net, tx)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        batch, size, size, 3).astype(np.float32)).to(device)
    metrics = {}

    def run():
        _, m = step(state, x, 0)
        metrics.update(m)

    wall = capture(run, device, out)
    row = {"program": "train_step", "batch": batch, "size": size,
           "loss": float(metrics["loss"]), "device": str(device),
           "wall_ms": wall, "summary": summarize_file(out, top)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trace_dir", nargs="?", default="trace_train")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args()
    main(args.trace_dir, args.device)
