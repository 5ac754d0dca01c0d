"""The port's command-line tools (``python -m
infodiffusion_tpu_torch.tools.<name>``): the attention microbenchmark and
the flash-attention bench. Each runs on the card unless its ``device``
argument asks for the CPU, where the kernels' plain versions run."""

from __future__ import annotations

import time

import torch


def resolve_device(device=None) -> torch.device:
    """The card by default; a CPU device only when asked for. Raises when
    the card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tools time the port's "
                           "kernels on the card (device='cpu' runs their "
                           "plain versions)")
    return device


def time_ms(fn, calls: int, device: torch.device) -> float:
    """Milliseconds of ``calls`` calls of ``fn`` (after one warm-up call):
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def clock_name(device: torch.device) -> str:
    return "cuda_events" if device.type == "cuda" else "host"
