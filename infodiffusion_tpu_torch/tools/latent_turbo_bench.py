"""K4 (the whole latent trajectory) with the bf16 weight stream against
the int8 one (``quantize_packed_weights``) on the same inputs, per a_dim:
median and middle-half spread of many reps, and whether the difference is
significant.

    python -m infodiffusion_tpu_torch.tools.latent_turbo_bench
        [--device cpu]
    INFODIFF_LTB_REPS=15 INFODIFF_LTB_BATCH=256 INFODIFF_LTB_T=1000 ...

Sweeps a_dim 32, 64 and 256 (every reference configuration class). The
latent prior (a LatentUNet, bf16, its initializers' weights, torch seed 0)
is packed as the sampler packs it; xT is a numpy draw (seed 3); each rep
draws its noise from a fresh generator. Each line names the route
``latent_route`` takes for that a_dim and weight stream: where it is not
K4 (the cluster core does not take the a_dim) the line says so and times
nothing; the tool never forces K4. Prints one JSON line per a_dim:
``bf16_ms``, ``int8_ms``, ``speedup``, both spreads, ``significant`` (the
medians differ by more than the sum of the two spreads) and
``max_abs_diff`` (the two streams' trajectories from one generator).
Times are per call on the host clock, synchronised on both ends. The
counterpart of the JAX package's ``tools/latent_turbo_bench.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import (
    pack_latent_unet_params,
)
from infodiffusion_tpu_torch.ops.cuda.latent_traj import (
    latent_route,
    latent_trajectory,
    quantize_packed_weights,
)
from infodiffusion_tpu_torch.tools import resolve_device, synchronize

A_DIMS = (32, 64, 256)


def significant(m_a: float, m_b: float, s_a: float, s_b: float) -> bool:
    """The medians differ by more than the sum of the two middle-half
    spreads: a difference inside the spreads is noise, not a win."""
    return abs(m_a - m_b) > (s_a + s_b)


def measure(fn, reps: int, clock=time.perf_counter, sync=lambda: None):
    """(median, middle-half spread) of ``fn(i)``'s seconds over reps
    ``i``, each synchronised on both ends (``sync``); ``clock`` is
    injectable so the statistics are testable."""
    times = []
    for i in range(reps):
        sync()
        t0 = clock()
        fn(i)
        sync()
        times.append(clock() - t0)
    times.sort()
    n = len(times)
    mid = times[n // 4: n - n // 4] or times
    return times[n // 2], max(mid) - min(mid)


def main(device=None, a_dims: Sequence[int] = A_DIMS,
         reps: Optional[int] = None, batch: Optional[int] = None,
         T: Optional[int] = None) -> List[dict]:
    device = resolve_device(device)
    reps = reps or int(os.environ.get("INFODIFF_LTB_REPS", "15"))
    B = batch or int(os.environ.get("INFODIFF_LTB_BATCH", "256"))
    T = T or int(os.environ.get("INFODIFF_LTB_T", "1000"))
    sync = lambda: synchronize(device)  # noqa: E731
    sched = make_schedule(1e-5, 1e-2, T, device)
    rows = []
    for a_dim in a_dims:
        routes = {"bf16": latent_route(a_dim, torch.bfloat16, False),
                  "int8": latent_route(a_dim, torch.int8, False)}
        row = {"a_dim": a_dim, "batch": B, "T": T, "reps": reps,
               "route": routes, "device": str(device)}
        if set(routes.values()) != {"k4"}:
            row["k4"] = (f"not taken at a_dim {a_dim}: the sampler's route "
                         f"is {routes}; nothing timed")
            print(json.dumps(row), flush=True)
            rows.append(row)
            continue
        torch.manual_seed(0)
        model = Diff(T=T, shape=(1, a_dim, a_dim), is_latent=True,
                     dtype=torch.bfloat16).to(device)
        packed = pack_latent_unet_params(model.backbone, a_dim,
                                         dtype=torch.bfloat16)
        streams = {"bf16": packed, "int8": quantize_packed_weights(packed)}
        xT = torch.from_numpy(np.random.RandomState(3).randn(
            B, a_dim).astype(np.float32)).to(device, torch.bfloat16)

        def run(pk, seed):
            g = torch.Generator(device=device).manual_seed(seed)
            return latent_trajectory(pk, sched, xT, g, deterministic=True)

        with torch.no_grad():
            diff = float((run(streams["bf16"], 9).float()
                          - run(streams["int8"], 9).float()).abs().max())
            run(streams["bf16"], 4), run(streams["int8"], 5)  # warm
            m_b, s_b = measure(lambda i: run(streams["bf16"], 10_000 + i),
                               reps, sync=sync)
            m_i, s_i = measure(lambda i: run(streams["int8"], 20_000 + i),
                               reps, sync=sync)
        row.update({
            "bf16_ms": m_b * 1e3, "int8_ms": m_i * 1e3,
            "speedup": m_b / m_i, "bf16_spread_ms": s_b * 1e3,
            "int8_spread_ms": s_i * 1e3,
            "significant": significant(m_b, m_i, s_b, s_i),
            "max_abs_diff": diff,
            "clock": "host, synchronised"})
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
