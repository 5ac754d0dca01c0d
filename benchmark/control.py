"""The control of each cell's comparison, and the planted faults' readings,
on the card at the cell's own size (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13
        [--seconds 8]

Training cells: the plain reference put in the program's place, computed
with every product's operands rounded to fp8 (e4m3, a scale per tensor),
compared with the float32 reference as a run compares the program; and
the fault "half of the batch left out, the mean taken over the rest" (the
reference's loss over the first half of the rows). A state left unchanged
reads 1 on the change by construction. Generation cells: the program with
its own int8 tier switched on (``turbo='int8'``: W8A8 convolutions and
K4's int8 weight stream), run as a short window and compared as a run
compares it. Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402


def train_readings(files: dict, seed: int, device) -> dict:
    """The fp8 control's and the half-batch fault's numbers for one seed."""
    import torch

    from benchmark import port
    from benchmark.reference import model as RM
    from benchmark.reference import precision
    from benchmark.reference import train as RT
    from benchmark.traffic.train import gap_numbers

    cfg, tr = files["config"], files["traffic"]
    B = tr["batch_size"]
    r_seed = seed % (1 << 32)
    pc = port.port_config(cfg, B, r_seed)
    model = port.build(pc, "meta")
    shapes = port.leaf_shapes(model)
    del model
    imgs = port.images(cfg["dataset_images"], cfg["input_size"],
                       cfg["input_channels"], port.sub_seed(seed, port.DATA),
                       device)
    RM.strict_f32()
    rc = dict(cfg, arch=dict(cfg["arch"], T=cfg["T"]))
    draw = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
    w0 = port.make_weights(shapes, port.sub_seed(seed, port.WEIGHTS), device)
    kw = dict(n_steps=tr["check_steps"], batch=B, block=tr["ref_block"],
              device=device, draw_dtype=draw)
    t0 = time.perf_counter()
    ref = RT.run_steps(rc, w0, imgs, r_seed, **kw)
    t_ref = time.perf_counter() - t0
    fp8 = RT.run_steps(rc, w0, imgs, r_seed, q=precision.fp8, **kw)
    half = RT.run_steps(rc, w0, imgs, r_seed, rows=B // 2, **kw)
    return {"control_fp8": gap_numbers(fp8, ref),
            "fault_half_batch": gap_numbers(half, ref),
            "reference_s": t_ref}


def gen_readings(name: str, files: dict, seed: int, seconds: float,
                 device) -> dict:
    from benchmark.run import run_cell

    out = run_cell(name, seed, seconds, False, device, files,
                   turbo="int8", t_start=time.perf_counter())
    return {"control_int8": {k: c["value"] for k, c in out["checks"].items()},
            "diagnostics": out["host"]["diagnostics"],
            "batches_images": out["attempted"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    files = H.cell_files(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if files["traffic"]["kind"] == "train":
            out = train_readings(files, seed, device)
        else:
            out = gen_readings(args.workload, files, seed, args.seconds,
                               device)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
