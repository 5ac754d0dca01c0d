"""The benchmark of the PyTorch/CUDA port (``infodiffusion_tpu_torch``):
one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's files are found by its name: ``benchmark/workloads/<cell>.json``
names its configuration (``benchmark/configs/<config>.json``) and its
traffic mix (``benchmark/traffic/<traffic>.json``), whose ``kind`` names
the generator (``benchmark/traffic/<kind>.py``). A run builds the port's
objects from the seed, warms up the cell's shapes (``setup_s``), measures
for ``--seconds``, and then compares what the window produced with the
plain reference (``benchmark/reference/``). With ``--trace 1`` it reports
the cell's per-layer metrics instead (each read by
``benchmark/metrics/<name>.py``), from host clocks in the window and a
profiled stretch after it.

The last line of standard output is the result (JSON); the line before it
holds the host's facts and the card's state beside the window. The last
lines of standard error give each compared number beside its limit.
Exits 2 without a card, 3 when a forbidden module was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cache of the run inside the checkout, at fixed paths (the port's
# kernels build into build/torch_kernels/ by themselves)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(ROOT / "build" / _sub)
os.environ.setdefault("OMP_NUM_THREADS", "2")

from benchmark import harness as H  # noqa: E402


class Run:
    """One run of one cell: its files, seed, window and clocks."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device, files: dict, turbo: str = ""):
        self.name = name
        self.seed = seed
        # the loader's RandomState takes 32 bits
        self.r_seed = seed % (1 << 32)
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.cell = files["cell"]
        self.config = files["config"]
        self.traffic = files["traffic"]
        self.turbo = turbo
        self.marks = H.Marks(device)
        self.t_start = time.perf_counter()
        self.setup_phases = {}

    def phase(self, name: str) -> None:
        """Seconds since the process started, at the end of a set-up
        phase (the host line reports them)."""
        self.setup_phases[name] = time.perf_counter() - self.t_start


def per_layer(spec: dict, name: str, ctx: dict) -> dict:
    out = {}
    for m in H.cell_metrics(spec, name, "per_layer"):
        value = H.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             files: dict = None, spec: dict = None, turbo: str = "",
             t_start: float = None) -> dict:
    """One run; returns the result (``line`` and the pieces printed)."""
    import torch

    from benchmark import trace as T

    files = files or H.cell_files(name)
    spec = spec or H.benchmark_spec()
    t_start = _T0 if t_start is None else t_start
    device = torch.device(device)
    cuda = device.type == "cuda"
    run = Run(name, seed, seconds, trace, device, files, turbo)
    run.t_start = t_start
    run.phase("imports")
    traffic = H.traffic_kind(run.traffic["kind"]).Traffic(run)
    facts = H.host_facts()
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        # the port's kernel library: built by nvcc in a checkout's first
        # run, loaded from build/torch_kernels/ in every later one
        from infodiffusion_tpu_torch.ops.cuda.library import library

        facts["kernel_build_s"] = library().build_seconds
        run.phase("kernels")
    traffic.setup()
    setup_s = time.perf_counter() - t_start
    card_before = H.card_state() if cuda else None
    clock = H.HostClock()
    clock.start()
    res = traffic.window()
    facts.update(clock.stop())
    facts.update(getattr(traffic, "window_diag", {}))
    card_after = H.card_state() if cuda else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    layer = traffic.layer_data()
    summary = traffic.profile(T.capture) if trace and cuda else None
    numbers = traffic.check()
    limits = run.cell["limits"]
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    diagnostics = {k: v for k, v in numbers.items() if k not in limits}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        peaks = H.load_json(H.BENCH_DIR / "peaks.json")
        ctx = {"layer": layer, "trace": summary, "config": run.config,
               "traffic": run.traffic, "peak": peaks.get(dev_info["kind"])}
        metrics = per_layer(spec, name, ctx)
        if summary is not None:
            dev_info["busy_s"] = summary["busy_s"]
            dev_info["window_s"] = summary["window_s"]
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"]
                 for m in H.cell_metrics(spec, name, "end_to_end")}
        values = dict(res["metrics"], setup_s=setup_s)
        metrics = {k: {"value": values[k], "unit": u}
                   for k, u in units.items()}
    return {"correct": H.passed(checks), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev_info,
            "checks": checks, "breakdown": breakdown,
            "host": dict(facts, diagnostics=diagnostics,
                         setup_phases=run.setup_phases,
                         card_before=card_before,
                         card_after=card_after, setup_s=setup_s,
                         seed=seed, workload=name, trace=int(trace))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = H.cell_files(args.workload)
    spec = H.benchmark_spec()

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no result: the cell needs {chips} CUDA device(s), {seen} "
              f"visible", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), files, spec)
    found = H.forbidden_modules()
    if found:
        print(f"no result: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print("host " + json.dumps(out["host"]), flush=True)
    print(H.result_line(out["correct"], out["attempted"], out["failed"],
                        out["metrics"], out["device"], out["checks"],
                        out["breakdown"]), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
