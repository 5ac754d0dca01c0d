"""The port's command-line tools (``python -m
infodiffusion_tpu_torch.tools.<name>``), the counterparts of the JAX
package's root ``tools/`` and a few of the port's own:

- kernels: ``microbench_attention`` (K2'), ``flash_attn_bench`` (K3a-c),
  ``qconv_bench`` (the int8 tier's convs), ``adagn_rate`` (K1),
  ``latent_turbo_bench`` (K4 with bf16 against int8 weights);
- rates and profiles: ``train_rate``, ``int8_rate``, ``profile_sampler``
  and ``profile_train`` (torch.profiler captures), ``trace_summary`` (a
  Chrome trace by category, idle share and gaps), ``image_io_bench``;
- accounting: ``flops_report`` (FLOPs on the plain path),
  ``memory_report`` (peak device memory);
- end to end through the CLI: ``pipeline_rehearsal`` (JPEG decode and
  save_latent), ``turbo_fid_delta`` (FID of the bf16 against the int8
  tier), ``repr_learning_demo`` (dsprites factors from the latents);
- files: ``convert_checkpoint``, ``verify_inception_weights``,
  ``dryrun_multichip``.

Each runs on the card unless its ``device`` argument (``--device cpu``)
asks for the CPU, where the kernels' plain versions run; none falls back
to the CPU when it finds no card."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional, Sequence

import torch

A_DIM = 256  # the flagship's a_dim


def flagship_config(size: int = 64, model: str = "diff"):
    """The CelebA-64 flagship's Config (a_dim 256, T 1000) at ``size``
    pixels: the InfoDiff (AuxiliaryUNet ch 64, ch_mult (1,2,2,2)), or the
    vanilla Diff or the VAE at their CelebA widths."""
    from infodiffusion_tpu_torch.config import Config

    return dataclasses.replace(Config(
        model=model, dataset="celeba", a_dim=A_DIM,
        diffusion_steps=1000).with_dataset_config(), input_size=size)


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


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_env(name: str, default: int) -> int:
    """``INFODIFF_BENCH_<name>`` (bench.py's knobs), else ``default``."""
    return int(os.environ.get(f"INFODIFF_BENCH_{name}", str(default)))


def clock_name(device: torch.device) -> str:
    return "cuda_events" if device.type == "cuda" else "host"


@contextlib.contextmanager
def env_set(values: Dict[str, str]):
    """Set environment variables for a block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def in_directory(path: str):
    """Work in ``path`` (made if missing) for a block."""
    os.makedirs(path, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def run_cli(argv: Sequence[str], env: Optional[Dict[str, str]] = None):
    """One mode of ``python -m infodiffusion_tpu_torch <argv>`` through its
    entry point (``cli.main``) in this process, with ``env`` set for the
    call: a tool's modes then share one start of the card and one build of
    the kernels."""
    from infodiffusion_tpu_torch import cli

    print("+ python -m infodiffusion_tpu_torch " + " ".join(argv), flush=True)
    with env_set(env or {}):
        cli.main(list(argv))
