"""Per-site times of K7, the fused quantize-conv: body v1 (``_kernel``),
body v2 (``_kernel_v2``, the pipelined body) and the tier's default route
at the same site (the chain materialized in the model dtype, the
activation quantized at its calibrated scale, then the chainless int8
conv with its dequant: what ``Conv3`` / ``PieceConv3`` run without K7, as
the JAX package's ``tools/qconv_bench.py`` times its XLA oracle), beside
the card's bound, at the flagship InfoDiff's 11 ResBlock conv sites.

    python -m infodiffusion_tpu_torch.tools.qconv_bench [--batch 128] \\
        [--reps 20] [--sites 64x64-128+64-64,...] [--device cpu]

Each time is CUDA-graph device time (``--reps`` calls captured in one
graph on copies of the inputs that fill the L2 twice over, so each call
reads its inputs from device memory), bf16 pieces, bf16 out. The bound is
the larger of the bytes (each input read once, the output written once)
over 3.35 TB/s and the int8 operations over 1,979 TOP/s (H100 SXM). Prints
one JSON line per site and one for their sum, with the card's name and
power limit. ``--device cpu`` runs the plain versions on the host clock
(no device time). The file also runs as a script (``python
path/to/qconv_bench.py``), which times the package that ``PYTHONPATH``
names: another checkout's, with the same inputs.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from infodiffusion_tpu_torch.nn.blocks import (
    Conv3,
    PieceConv3,
    _AffineChain,
    _materialize_chain,
)
from infodiffusion_tpu_torch.ops import quant as Q
from infodiffusion_tpu_torch.ops.cuda import qconv as K7
from infodiffusion_tpu_torch.tools import resolve_device

# (name, H, W, piece channels, Cout): the flagship InfoDiff's (CelebA-64,
# ch 64, ch_mult (1,2,2,2)) ResBlock convs at 64px
SITES = [
    ("8x8-128-128", 8, 8, (128,), 128),
    ("8x8-128+128-128", 8, 8, (128, 128), 128),
    ("16x16-128-128", 16, 16, (128,), 128),
    ("16x16-128+128-128", 16, 16, (128, 128), 128),
    ("32x32-64-128", 32, 32, (64,), 128),
    ("32x32-128-128", 32, 32, (128,), 128),
    ("32x32-128+64-128", 32, 32, (128, 64), 128),
    ("32x32-128+128-128", 32, 32, (128, 128), 128),
    ("64x64-64-64", 64, 64, (64,), 64),
    ("64x64-64+64-64", 64, 64, (64, 64), 64),
    ("64x64-128+64-64", 64, 64, (128, 64), 64),
]
PEAK_INT8 = 1979e12
HBM = 3.35e12
L2_BYTES = 50 * 2**20


def site_inputs(B, H, W, splits, cout, device, seed=0):
    """bf16 pieces, f32 rows A and B, the calibrated absmax, an f32 HWIO
    kernel and bias, drawn from a torch generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    ctot = sum(splits)
    pieces = [(0.5 * torch.randn(B, H, W, c, generator=g, device=device))
              .to(torch.bfloat16) for c in splits]
    A = 1.0 + 0.1 * torch.randn(B, ctot, generator=g, device=device)
    Bv = 0.1 * torch.randn(B, ctot, generator=g, device=device)
    absmax = torch.stack([p.float().abs().amax() * 1.2 for p in pieces])
    kernel = 0.2 * torch.randn(3, 3, ctot, cout, generator=g, device=device)
    bias = 0.1 * torch.randn(cout, generator=g, device=device)
    return pieces, A, Bv, absmax, kernel, bias


def default_route(absmax, kernel, bias, splits, dtype=torch.bfloat16):
    """The tier's default route at a K7 site, as a function of (pieces, A,
    B) to the NHWC output: the chain materialized in ``dtype``
    (``_materialize_chain``), then ``Conv3``'s int8 branch (one piece) or
    ``PieceConv3``'s (two: a bf16 partial between the pieces' convs),
    weights quantized at each call as the tier does."""
    ctot, cout = sum(splits), int(kernel.shape[3])
    conv = (Conv3 if len(splits) == 1 else PieceConv3)(ctot, cout, dtype)
    conv = conv.to(kernel.device)
    with torch.no_grad():
        conv.weight.copy_(kernel.permute(3, 2, 0, 1))
        conv.bias.copy_(bias)
    conv.act_absmax = absmax.reshape(()) if len(splits) == 1 else absmax

    def run(pieces, A, Bv):
        x = _materialize_chain(_AffineChain(tuple(pieces), A, Bv), dtype)
        with torch.no_grad():
            y = conv(x) if len(splits) == 1 else conv(x, list(splits))
        return y.permute(0, 2, 3, 1)

    return run


def bound_ms(B, H, W, splits, cout) -> float:
    """The least time of one K7 call on the card: bf16 pieces read, f32 A
    and B rows, int8 weights, f32 scale and bias read once and the bf16
    output written once, against the int8 operations."""
    ctot = sum(splits)
    nbytes = (B * H * W * (2 * ctot + 2 * cout) + 8 * B * ctot
              + 9 * ctot * cout + 8 * cout)
    ops = 2 * B * H * W * 9 * ctot * cout
    return max(nbytes / HBM, ops / PEAK_INT8) * 1e3


def device_ms(fn, tensors, reps: int) -> float:
    """Device milliseconds per call of ``fn(*tensors)``: ``reps`` calls (at
    least as many as input copies) captured in one CUDA graph over copies
    of ``tensors`` that fill the L2 twice over, replayed between CUDA
    events."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [tensors] + [[t.clone() for t in tensors]
                        for _ in range(copies - 1)]
    calls = max(reps, copies)
    fn(*tensors)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        outs = [fn(*sets[i % copies]) for i in range(calls)]
    graph.replay()  # the first replay uploads the graph
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del outs, graph
    return start.elapsed_time(end) / calls


def host_ms(fn, tensors, reps: int) -> float:
    fn(*tensors)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*tensors)
    return (time.perf_counter() - t0) * 1e3 / reps


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    return {"card": smi.strip()}


def main(device=None, batch: int = 128, reps: int = 20, sites=None) -> list:
    """Time each site (``sites``: names of :data:`SITES`, default all);
    print and return one dict a site and one for the sum."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    chosen = [s for s in SITES if not sites or s[0] in sites]
    if sites and len(chosen) != len(sites):
        unknown = sorted(set(sites) - {s[0] for s in SITES})
        raise ValueError(f"unknown sites {unknown}")
    timer = device_ms if on_card else host_ms
    extra = card() if on_card else {}
    rows, tot = [], {"v1_ms": 0.0, "v2_ms": 0.0, "default_ms": 0.0,
                     "bound_ms": 0.0}
    for name, H, W, splits, cout in chosen:
        pieces, A, Bv, absmax, kernel, bias = site_inputs(
            batch, H, W, splits, cout, device)
        s_act = Q.act_scale(absmax)
        kmat, sw = K7._fold_pack(kernel, s_act, list(splits))
        n = len(pieces)
        if on_card:
            bodies = (K7.qconv_cuda, K7.qconv_v2_cuda)
        else:  # the plain version on the packed weights' function
            bodies = (None, None)

        def body(run):
            def call(*t):
                if run is None:
                    return K7.qconv_reference(list(t[:n]), t[n], t[n + 1],
                                              absmax, kernel, bias)
                return run(list(t[:n]), t[n], t[n + 1], s_act, kmat, sw,
                           bias)
            return call

        route = default_route(absmax, kernel, bias, splits)

        def default(*t):
            return route(list(t[:n]), t[n], t[n + 1])

        tensors = [*pieces, A, Bv]
        row = {"site": name, "batch": batch,
               "v1_ms": timer(body(bodies[0]), tensors, reps),
               "v2_ms": timer(body(bodies[1]), tensors, reps),
               "default_ms": timer(default, tensors, reps),
               "bound_ms": bound_ms(batch, H, W, splits, cout),
               "clock": "cuda_graph_device" if on_card else "host",
               "device": str(device), **extra}
        for k in tot:
            tot[k] += row[k]
        print(json.dumps(row), flush=True)
        rows.append(row)
    row = {"site": "sum", "batch": batch, "sites": len(chosen), **tot,
           "clock": "cuda_graph_device" if on_card else "host",
           "device": str(device), **extra}
    print(json.dumps(row), flush=True)
    rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sites", default="",
                        help="comma-separated site names (default all)")
    args = parser.parse_args()
    main(args.device, args.batch, args.reps,
         [s for s in args.sites.split(",") if s] or None)
