"""Kernel-level timing of the plain attention against the routed flash
kernel (K3a, or K3c where the JAX package's whole-k/v plan does not fit) at
large token counts (port of ``tools/flash_attn_bench.py``).

Methodology: each rep times ``inner`` calls with CUDA events on the card
(the host clock with ``device='cpu'``); the report is the median of the
reps and their middle-half spread, and "significant" means the medians
differ by more than the SUM of the two spreads.

Prints one JSON line per (N, B) config, with the JAX tool's keys:
  {"N": .., "B": .., "C": 128, "inner": .., "grad": .., "xla_ms": ..,
   "flash_ms": .., "speedup": .., "xla_spread_ms": .., "flash_spread_ms":
   .., "significant": bool, "max_abs_diff": ..}
where ``xla_ms`` is the plain PyTorch version (the port's counterpart of
the XLA path) and ``flash_ms`` the kernel ``route`` names, both per call;
plus "route", "device" and "clock".

Env: INFODIFF_FAB_REPS (default 9), INFODIFF_FAB_CONFIGS (default
"256x128,512x128,1024x128,2048x64,4096x32" as NxB pairs), INFODIFF_FAB_DTYPE
(default bf16), INFODIFF_FAB_GRAD=1 to time forward + backward instead
(the plain version's autograd against the kernel forward and K3b on the
contract JAX's gradient takes, ``bwd_route``).

    python -m infodiffusion_tpu_torch.tools.flash_attn_bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from infodiffusion_tpu_torch.ops.cuda.attention import attention_reference
from infodiffusion_tpu_torch.ops.cuda.flash_attention import (
    backward_for,
    bwd_route,
    flash_plan,
    forward_for,
)
from infodiffusion_tpu_torch.tools import clock_name, resolve_device, time_ms

C = 128  # every attention site of the InfoDiff UNet is 128-channel


def significant(m_a, m_b, s_a, s_b) -> bool:
    """The medians differ by more than the sum of the two middle-half
    spreads."""
    return abs(m_a - m_b) > (s_a + s_b)


def measure(fn, reps: int, inner: int, device) -> tuple[float, float]:
    """Median and middle-half spread of per-call milliseconds over
    ``reps`` reps of ``inner`` calls."""
    times = sorted(time_ms(fn, inner, device) / inner for _ in range(reps))
    n = len(times)
    mid = times[n // 4: n - n // 4] or times
    return times[n // 2], max(mid) - min(mid)


def main(device=None) -> list:
    device = resolve_device(device)
    reps = int(os.environ.get("INFODIFF_FAB_REPS", "9"))
    dtype = (torch.bfloat16
             if os.environ.get("INFODIFF_FAB_DTYPE", "bf16") == "bf16"
             else torch.float32)
    configs = [
        tuple(int(t) for t in c.split("x"))
        for c in os.environ.get(
            "INFODIFF_FAB_CONFIGS",
            "256x128,512x128,1024x128,2048x64,4096x32",
        ).split(",")
    ]
    grad_mode = os.environ.get("INFODIFF_FAB_GRAD") == "1"
    cuda = device.type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    lines = []
    for N, B in configs:
        flops = (4 if not grad_mode else 14) * B * N * N * C
        # enough work per rep for the clock; one call from ~0.2 TFLOP
        inner = max(1, min(20, int(2e11 / flops)))
        q, k, v, do = (torch.randn(B, N, C, generator=gen, device=device)
                       .to(dtype) for _ in range(4))
        route = flash_plan(N, C, dtype)
        fwd = forward_for(route, cuda)
        bwd = backward_for(bwd_route(N, C, dtype), cuda)

        if grad_mode:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

            def plain():
                out = attention_reference(*leaves)
                return torch.autograd.grad(out, leaves, do)

            def flash():
                fwd(q, k, v)
                return bwd(q, k, v, do)
        else:
            def plain():
                return attention_reference(q, k, v)

            def flash():
                return fwd(q, k, v)

        d0 = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(_tuple(flash()), _tuple(plain())))
        m_x, s_x = measure(plain, reps, inner, device)
        m_f, s_f = measure(flash, reps, inner, device)
        line = {
            "N": N, "B": B, "C": C, "inner": inner, "grad": grad_mode,
            "xla_ms": m_x, "flash_ms": m_f, "speedup": m_x / m_f,
            "xla_spread_ms": s_x, "flash_spread_ms": s_f,
            "significant": significant(m_x, m_f, s_x, s_f),
            "max_abs_diff": d0, "route": route, "device": str(device),
            "clock": clock_name(device),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
