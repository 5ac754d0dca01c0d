"""K1 (GroupNorm + FiLMs) and its backward at the flagship InfoDiff's
GroupNorm sites, bf16: per site and summed, CUDA-event ms and device ms (a
CUDA graph of calls on copies of the inputs that fill the L2 twice over,
so each call reads from HBM, replayed between CUDA events: the host's
launch cost drops out), and the host microseconds per call through
``ops.norm.adagn`` at B=2 (forward under ``no_grad``; forward and backward
through autograd), where the host, not the card, bounds the call.

    python -m infodiffusion_tpu_torch.tools.adagn_rate [--sizes 64,128] \\
        [--reps 20]

The forward runs at the sites of one UNet forward at 64px, B=128 (the
generation path); the backward at the sites of one training forward
(UNet and Encoder) at 64px B=128 and 128px B=64. Inputs are a seeded
draw. Prints one JSON line a measurement. The file also runs as a script
(``python path/to/adagn_rate.py``), which times the package that
``PYTHONPATH`` names: another checkout's, through the wrappers' common
calls (``adagn_cuda(..., return_stats=True)``, ``adagn_bwd_cuda``).
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from infodiffusion_tpu_torch.models.wrappers import InfoDiff
from infodiffusion_tpu_torch.nn.attention import _GN
from infodiffusion_tpu_torch.nn.blocks import _GNParams
from infodiffusion_tpu_torch.ops.cuda.adagn import adagn_bwd_cuda, adagn_cuda
from infodiffusion_tpu_torch.ops.norm import adagn
from infodiffusion_tpu_torch.tools import time_ms

L2_BYTES = 50 * 2**20  # an H100's
# (image size, batch) of the generation and the training runs
GENERATION = (64, 128)
TRAINING = ((64, 128), (128, 64))


def gn_sites(model: torch.nn.Module, run) -> list:
    """(HW, C, K) of every GroupNorm site (K FiLMs) that ``run()``, one
    forward of ``model``, hits, found by hooks; run without gradients."""
    found = set()

    def hook(mod, args, kwargs):
        x = args[0]
        if isinstance(mod, _GN):  # NHWC
            hw, c = x.shape[1] * x.shape[2], x.shape[3]
        else:                     # NCHW, or an up block's skip-concat pieces
            pieces = x if isinstance(x, (tuple, list)) else [x]
            hw = pieces[0].shape[2] * pieces[0].shape[3]
            c = sum(p.shape[1] for p in pieces)
        found.add((hw, c, len(kwargs.get("films", ()))))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in model.modules() if isinstance(m, (_GN, _GNParams))]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return sorted(found)


def sites(size: int, training: bool) -> list:
    """The GroupNorm sites of one forward of the flagship InfoDiff at
    ``size`` pixels (``training``: its loss, UNet and Encoder), on the meta
    device (shapes only)."""
    meta = torch.device("meta")
    model = InfoDiff(T=1000, a_dim=256, shape=(3, size, size),
                     unets_channels=64, encoder_channels=64).to(meta)
    x = torch.zeros(1, size, size, 3, device=meta)
    t = torch.zeros(1, dtype=torch.long, device=meta)
    a = torch.zeros(1, 256, device=meta)
    if training:
        return gn_sites(model, lambda: model.loss_fn(
            x, deterministic=True, t=t, eps=torch.zeros_like(x),
            reparam_eps=a, prior_samples=a))
    return gn_sites(model, lambda: model(x, t, a))


def inputs(B, hw, c, k, g, device, dtype=torch.bfloat16):
    """x [B, hw, c] (mean 0.5, std 2), gamma, beta and the FiLM
    projections [B, 2c] whose halves (``chunk``, as a ResBlock's) are the
    FiLM rows, read in place by the kernel."""
    x = (torch.randn(B, hw, c, generator=g, device=device) * 2 + 0.5).to(
        dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=device)
    beta = 0.1 * torch.randn(c, generator=g, device=device)
    proj = [torch.randn(B, 2 * c, generator=g, device=device).to(dtype)
            for _ in range(k)]
    return x, gamma, beta, proj


def films_of(proj):
    """The FiLM rows (s, b) of each projection: its halves, as views."""
    return [tuple(p.chunk(2, dim=-1)) for p in proj]


def graph_ms(fn, args, reps: int) -> float:
    """Device ms per call of ``fn(*args)`` from a CUDA graph of at least
    ``reps`` calls on copies of ``args`` that fill the L2 twice over."""
    fn(*args)
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    calls = max(reps, copies)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        outs = [fn(*sets[i % copies]) for i in range(calls)]
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del outs, sets, graph
    return start.elapsed_time(end) / calls


def host_us(site_list, device, reps: int = 50) -> dict:
    """Host microseconds per ``ops.norm.adagn`` call at ``site_list``,
    bf16, B=2 (small enough that the card keeps ahead of the host):
    forward under no_grad, and forward plus backward through autograd."""
    g = torch.Generator(device=device).manual_seed(5)
    calls = []
    for hw, c, k in site_list:
        x, gamma, beta, proj = inputs(2, hw, c, k, g, device)
        calls.append((x, gamma, beta, films_of(proj), torch.randn_like(x)))

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (reps * len(calls)) * 1e6

    def forwards():
        with torch.no_grad():
            for x, gamma, beta, films, _ in calls:
                adagn(x, 32, gamma, beta, films)

    leaves = [(x.requires_grad_(True), gamma.requires_grad_(True), beta,
               films, dy) for x, gamma, beta, films, dy in calls]

    def both():
        for x, gamma, beta, films, dy in leaves:
            torch.autograd.grad(adagn(x, 32, gamma, beta, films), (x, gamma),
                                dy)

    return {"forward_us": per_call(forwards), "forward_backward_us":
            per_call(both)}


def main(sizes=(64, 128), reps: int = 20) -> list:
    device = torch.device("cuda", 0)
    rows = []
    g = torch.Generator(device=device).manual_seed(0)

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    size, B = GENERATION
    ev = dev = 0.0
    for hw, c, k in sites(size, training=False):
        x, gamma, beta, proj = inputs(B, hw, c, k, g, device)
        fn = lambda x, gamma, beta, *proj: adagn_cuda(  # noqa: E731
            x, 32, gamma, beta, films_of(proj))
        e = time_ms(lambda: fn(x, gamma, beta, *proj), reps, device) / reps
        d = graph_ms(fn, (x, gamma, beta, *proj), reps)
        ev, dev = ev + e, dev + d
        emit({"kernel": "adagn", "size": size, "B": B, "site": [hw, c, k],
              "events_ms": e, "device_ms": d})
        del x, proj
    emit({"kernel": "adagn", "sites": "generation", "events_ms": ev,
          "device_ms": dev})
    ev = dev = 0.0
    n = 0
    for size, B in TRAINING:
        if size not in sizes:
            continue
        for hw, c, k in sites(size, training=True):
            x, gamma, beta, proj = inputs(B, hw, c, k, g, device)
            dy = torch.randn_like(x)
            # the backward alone, on the forward's statistics
            films = films_of(proj)
            _, stats = adagn_cuda(x, 32, gamma, beta, films,
                                  return_stats=True)
            e = time_ms(lambda: adagn_bwd_cuda(x, dy, 32, gamma, beta,
                                               films, stats), reps,
                        device) / reps
            d = graph_ms(lambda x, dy, stats, gamma, beta, *proj:
                         adagn_bwd_cuda(x, dy, 32, gamma, beta,
                                        films_of(proj), stats)[0],
                         (x, dy, stats, gamma, beta, *proj), reps)
            ev, dev, n = ev + e, dev + d, n + 1
            emit({"kernel": "adagn_bwd", "size": size, "B": B,
                  "site": [hw, c, k], "events_ms": e, "device_ms": d})
            del x, dy, proj, stats, films
            torch.cuda.empty_cache()
    emit({"kernel": "adagn_bwd", "sites": f"training ({n})", "events_ms": ev,
          "device_ms": dev})
    emit({"kernel": "adagn", "host": "B=2, generation sites",
          **host_us(sites(GENERATION[0], training=False), device)})
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", default="64,128",
                        help="training image sizes of the backward's sites")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    main(tuple(int(s) for s in args.sizes.split(",")), args.reps)
