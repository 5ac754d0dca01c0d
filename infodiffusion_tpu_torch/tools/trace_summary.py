"""Summary of a Chrome trace of the port on the card: device self-time by
category (each hand kernel K1...K7 by its symbol names, cuDNN convs,
cuBLAS GEMMs, elementwise, reductions, copies and sets, other), the top
kernels, the device's idle share over the traced window, and the longest
idle gaps, each with the host op that ran during it.

    python -m infodiffusion_tpu_torch.tools.trace_summary <dir or
        trace.json> [--top 20] [--gaps 5]

The trace is one that ``torch.profiler`` exported: the runner's
(``INFODIFF_PROFILE=<dir>`` writes ``<dir>/trace.json``) or the profile
tools' (``tools.profile_sampler``, ``tools.profile_train``). It reads the
file only, on the host; prints one JSON line. The counterpart of the JAX
package's ``tools/trace_summary.py`` (xprof's ``hlo_stats``).

:func:`capture` traces one call; :func:`profile_step` is the profile the
rate tools (``train_rate``, ``int8_rate``) and ``chip_smoke.py`` take of
one call, its numbers :func:`summarize`'s of that trace.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from infodiffusion_tpu_torch.tools import synchronize

# The device events of a trace (kernels, copies, sets)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The hand kernels by their symbols' namespaces and names
# (infodiffusion_tpu_torch/csrc); the first rule that matches names the
# category, so K1-bwd comes before K1 (both in namespace adagn)
HAND_KERNELS = (
    ("K1-bwd adagn_bwd", ("adagn::",), ("bwd_kernel", "stream_reduce_kernel",
                                        "stream_film_kernel",
                                        "stream_dx_kernel",
                                        "params_kernel")),
    ("K1 adagn", ("adagn::",), ()),
    ("K2 attention", ("strip_mma::", "fma_f32::"), ()),
    ("K3a flash_attention", ("flash_fwd_kernel", "flash_wgmma::",
                             "flash_mma::"), ()),
    ("K3b flash_attention_bwd", ("flash_bwd::", "fma_bwd::"), ()),
    ("K3c flash_attention_online", ("fma_online::",), ()),
    ("K4 latent_traj", ("latent_traj_",), ()),
    ("K5 latent_mlp", ("latent_mlp_",), ()),
    ("K6 shortcut_fused", ("shortcut_wgmma_kernel", "shortcut_f32_kernel"),
     ()),
    ("K7 qconv", ("qconv_v1_kernel", "qconv_v2_kernel"), ()),
    ("int8 conv", ("int8_wgmma::",), ()),
)
# library kernels, matched on the lower-cased name after the hand kernels
LIBRARY = (
    ("elementwise", ("elementwise", "foreach", "catarray")),
    ("cuDNN conv", ("fprop", "dgrad", "wgrad", "cudnn", "conv")),
    ("cuBLAS GEMM", ("gemm", "cublas", "cutlass", "nvjet")),
    ("reduction", ("reduce", "norm", "softmax", "scan")),
)
CATEGORIES = tuple(c for c, _, _ in HAND_KERNELS) + tuple(
    c for c, _ in LIBRARY) + ("memcpy/memset", "other")


def categorize(name: str, cat: str = "kernel") -> str:
    """The category of one device event."""
    if cat in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy",
                                                                "Memset")):
        return "memcpy/memset"
    for label, marks, also in HAND_KERNELS:
        if any(m in name for m in marks) and (
                not also or any(a in name for a in also)):
            return label
    low = name.lower()
    for label, marks in LIBRARY:
        if any(m in low for m in marks):
            return label
    return "other"


def find_trace(path: str) -> str:
    """``path`` itself, or ``<path>/trace.json``."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no Chrome trace at {path}")
    return path


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_op(ops, s: float, e: float) -> Optional[str]:
    """The host op running during the gap [s, e]: the innermost (shortest)
    op running at its middle, else the op that overlaps it most."""
    mid = (s + e) / 2
    at_mid = [(oe - os_, name) for name, os_, oe in ops if os_ <= mid <= oe]
    if at_mid:
        return min(at_mid)[1]
    over = [(min(e, oe) - max(s, os_), -(oe - os_), name)
            for name, os_, oe in ops if min(e, oe) > max(s, os_)]
    return max(over)[2] if over else None


def summarize(trace: dict, top: int = 20, gaps: int = 5) -> Dict:
    """The summary of a loaded Chrome trace (times in ms)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError("the trace holds no complete events")
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    window = t1 - t0
    by_cat = dict.fromkeys(CATEGORIES, 0.0)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_cat[categorize(e["name"], e["cat"])] += e["dur"]
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    busy = _merge((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    idle, edge = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            idle.append((s - edge, edge, s))
        edge = max(edge, e)
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in ("cpu_op", "user_annotation")]
    return {
        "window_ms": window / 1e3,
        "device_ms": sum(e["dur"] for e in dev) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / window if window > 0 else None,
        "device_events": len(dev),
        "by_category_ms": {c: us / 1e3 for c, us in by_cat.items() if us},
        "top": [[name, us / 1e3, n, categorize(name)]
                for name, (us, n) in sorted(
                    by_name.items(), key=lambda kv: -kv[1][0])[:top]],
        "gaps": [{"start_ms": (s - t0) / 1e3, "ms": d / 1e3,
                  "host_op": _host_op(ops, s, e)}
                 for d, s, e in sorted(idle, reverse=True)[:gaps]],
    }


def summarize_file(path: str, top: int = 20, gaps: int = 5) -> Dict:
    path = find_trace(path)
    with open(path) as f:
        out = summarize(json.load(f), top, gaps)
    return {"trace": path, **out}


def capture(run, device: torch.device, trace_dir: str) -> float:
    """Warm up with one ``run()``, trace the next with torch.profiler (the
    card's kernels and copies too, on the card) into
    ``<trace_dir>/trace.json``; returns its wall ms (host clock,
    synchronised on both ends). On the CPU only the host is traced."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run()
    synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return wall


def profile_step(run, device: torch.device, top: int = 8,
                 trace_dir: Optional[str] = None) -> dict:
    """The wall ms of one ``run()`` (:func:`capture`) and, from
    :func:`summarize` of its trace, the device ms, the idle share over the
    traced window, the device ms of K1's family (forward and backward) and
    the kernels that took the most device time. The trace is kept as
    ``<trace_dir>/trace.json`` where ``trace_dir`` is given."""
    with tempfile.TemporaryDirectory() as tmp:
        wall = capture(run, device, trace_dir or tmp)
        out = summarize_file(trace_dir or tmp, top, gaps=0)
    cats = out["by_category_ms"]
    return {"device_ms": out["device_ms"], "wall_ms": wall,
            "idle": out["idle_share"],
            "adagn_ms": cats.get("K1 adagn", 0.0) + cats.get(
                "K1-bwd adagn_bwd", 0.0),
            "kernels": [[name[:80], ms] for name, ms, _, _ in out["top"]]}


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path", help="a trace.json or the folder holding it")
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--gaps", type=int, default=5)
    args = parser.parse_args(argv)
    out = summarize_file(args.path, args.top, args.gaps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
