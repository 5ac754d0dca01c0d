"""Peak device memory of the flagship programs on the card: the train step
and the DDIM-100 sampler of the CelebA-64 InfoDiff, each as peak bytes
allocated and reserved (``torch.cuda.max_memory_allocated`` /
``max_memory_reserved`` after ``reset_peak_memory_stats``) and as a share
of the card's memory.

    python -m infodiffusion_tpu_torch.tools.memory_report
    INFODIFF_BENCH_BATCH=256 INFODIFF_BENCH_SIZE=512 \\
        INFODIFF_BENCH_BF16=0 INFODIFF_MEMREPORT_PROGRAMS=train ...

The switches are the JAX package's ``tools/memory_report.py``'s:
``INFODIFF_BENCH_BATCH`` (128), ``INFODIFF_BENCH_SIZE`` (64),
``INFODIFF_BENCH_BF16`` (1: bf16 activations, 0: f32) and
``INFODIFF_MEMREPORT_PROGRAMS`` (``both``, ``train`` or ``sampler``; any
other value raises); and ``INFODIFF_BENCH_STEPS`` (100), the sampler's
DDIM steps (the loop holds one step's tensors, so its peak is one
step's). ``INFODIFF_REMAT=1`` measures the train step with its ResBlocks
recomputed. Each program runs once to warm up and is
measured on its second run. Device memory has no counterpart on the CPU:
without a card the tool raises. Prints one JSON line per program.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import torch

from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import A_DIM, bench_env, flagship_config
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import make_train_step

PROGRAMS = ("both", "train", "sampler")


class NoCardError(RuntimeError):
    """Peak device memory was asked for without a CUDA card."""


def programs_from_env() -> List[str]:
    """The programs ``INFODIFF_MEMREPORT_PROGRAMS`` names; a typo raises
    (it must not silently skip a report)."""
    programs = os.environ.get("INFODIFF_MEMREPORT_PROGRAMS", "both")
    if programs not in PROGRAMS:
        raise SystemExit(f"INFODIFF_MEMREPORT_PROGRAMS={programs!r}: "
                         f"expected one of {', '.join(map(repr, PROGRAMS))}")
    return ["train", "sampler"] if programs == "both" else [programs]


def peak(run, device: torch.device) -> Dict:
    """Peak bytes of ``run()``'s second call (the first warms up), and
    their shares of the card's memory."""
    run()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    run()
    torch.cuda.synchronize(device)
    total = torch.cuda.get_device_properties(device).total_memory
    alloc = torch.cuda.max_memory_allocated(device)
    reserved = torch.cuda.max_memory_reserved(device)
    return {"peak_allocated_bytes": alloc, "peak_reserved_bytes": reserved,
            "total_bytes": total, "allocated_share": alloc / total,
            "reserved_share": reserved / total}


def main(device=None) -> List[Dict]:
    programs = programs_from_env()
    if not torch.cuda.is_available():
        raise NoCardError("memory_report reads the card's peak memory and "
                          "no CUDA device is visible (device memory has no "
                          "CPU counterpart)")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise NoCardError(f"memory_report measures a CUDA device, not "
                          f"{device}")
    batch, size = bench_env("BATCH", 128), bench_env("SIZE", 64)
    steps = bench_env("STEPS", 100)
    bf16 = os.environ.get("INFODIFF_BENCH_BF16", "1") == "1"
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfg = flagship_config(size)
    head = {"model": f"CelebA-64 InfoDiff at {size}px", "batch": batch,
            "activations": "bf16" if bf16 else "f32",
            "remat": os.environ.get("INFODIFF_REMAT") == "1",
            "card": torch.cuda.get_device_name(device)}
    rows = []
    for program in programs:
        row = {**head, "program": ("train step" if program == "train"
                                   else f"DDIM-{steps} sampler"),
               **_measure(program, cfg, batch, size, steps, dtype, device)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _measure(program: str, cfg, batch: int, size: int, steps: int, dtype,
             device: torch.device) -> Dict:
    """``peak`` of one program, built here so that nothing of it outlives
    the call."""
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    net = build_model(cfg, dtype=dtype, device=device)
    x = torch.from_numpy(rng.randn(batch, size, size, 3).astype(
        np.float32)).to(device)
    if program == "train":
        tx = make_optimizer(1e-4, 50, 1000)
        state = create_train_state(net.train(), seed=0, tx=tx)
        step = make_train_step(net, tx)
        return peak(lambda: step(state, x, 0), device)
    proc = DiffusionProcess(cfg, net.eval())
    a = torch.from_numpy(rng.randn(batch, A_DIM).astype(np.float32)).to(
        device)

    def run():
        with torch.no_grad():
            return proc.sampling(xT=x, a=a, num_steps=steps)

    return peak(run, device)


if __name__ == "__main__":
    main()
