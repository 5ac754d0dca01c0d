"""Micro-benchmark: single-head attention at the flagship's shapes, the
plain version against the attention kernel K2 and its batch-tiled variant
K2' (port of ``tools/microbench_attention.py``).

Variants:
- plain:    ``attention_reference`` (the JAX package's XLA path, in torch)
- k2:       ``attention_cuda``, one pass over k on the tensor cores with
            the logit strip on chip, w rounded to v's dtype
- k2_tiled: ``attention_tiled_cuda``, w unrounded (all f32, the JAX tool's
            ``attention_pallas_tiled``; tb=8 must divide the batch)

    python -m infodiffusion_tpu_torch.tools.microbench_attention [--reps N]

Runs on the card and reports CUDA-event microseconds per call;
``--device cpu`` runs the plain versions on the CPU with the host clock.
"""

from __future__ import annotations

import argparse
import functools

import torch

from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_reference,
    attention_tiled_cuda,
    attention_tiled_reference,
)
from infodiffusion_tpu_torch.tools import clock_name, resolve_device, time_ms

SHAPES = ((128, 256, 128), (128, 64, 256), (256, 256, 128))  # (B, N, C)
TB = 8


def variants(device: torch.device) -> dict:
    cuda = device.type == "cuda"
    tiled = attention_tiled_cuda if cuda else attention_tiled_reference
    return {"plain": attention_reference,
            "k2": attention_cuda if cuda else attention_reference,
            "k2_tiled": functools.partial(tiled, tb=TB)}


def main(device=None, reps: int = 50, shapes=SHAPES) -> list:
    """Time every variant at every shape in f32 and bf16; print one line
    per (dtype, shape) and return the rows as dicts."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for B, N, C in shapes:
            q, k, v = (torch.randn(B, N, C, generator=gen, device=device)
                       .to(dtype) for _ in range(3))
            row = {"dtype": str(dtype).removeprefix("torch."), "B": B, "N": N,
                   "C": C, "device": str(device), "clock": clock_name(device)}
            line = f"{row['dtype']} B{B} N{N} C{C}:"
            for name, fn in variants(device).items():
                us = 1e3 * time_ms(lambda: fn(q, k, v), reps, device) / reps
                row[f"{name}_us"] = us
                line += f"  {name} {us:.1f}us"
            print(f"{line} ({row['clock']})", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    main(args.device, args.reps)
