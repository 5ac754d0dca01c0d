"""N local ranks as subprocesses, each in one process group.

    results = spawn("pkg.module:function", world=2, args={...},
                    workdir=tmp, timeout=120)

starts ``world`` Python processes that join one group over a ``FileStore``
in ``workdir`` (no TCP port to race for), call ``function(**args)`` and
``torch.save`` what it returns; the parent returns the ranks' results in
rank order. A rank that fails, or a run past ``timeout`` seconds, kills
every rank and raises with the tails of their output. The backend is gloo
unless ``backend='nccl'``; ``INFODIFF_FORCE_CPU=1`` is set for gloo runs
unless ``env`` says otherwise. The CPU tests and
``tools/dryrun_multichip.py`` run their ranks this way; ``torchrun`` is
the launcher for real runs.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(target: str, world: int, args: Optional[dict] = None, *,
          workdir: str, timeout: float = 300.0, backend: str = "gloo",
          env: Optional[Dict[str, str]] = None,
          pythonpath: Sequence[str] = (), threads: int = 2) -> List:
    import torch

    os.makedirs(workdir, exist_ok=True)
    tag = f"{os.getpid()}-{time.monotonic_ns()}"
    store = os.path.join(workdir, f"store-{tag}")
    args_path = os.path.join(workdir, f"args-{tag}.pt")
    torch.save(args or {}, args_path)
    outs = [os.path.join(workdir, f"out-{tag}-{r}.pt") for r in range(world)]
    logs = [os.path.join(workdir, f"log-{tag}-{r}.txt") for r in range(world)]
    child_env = dict(os.environ)
    if backend == "gloo":
        child_env["INFODIFF_FORCE_CPU"] = "1"
    child_env.update(env or {})
    child_env["PYTHONPATH"] = os.pathsep.join(
        [*pythonpath, _ROOT] + ([child_env["PYTHONPATH"]]
                                if child_env.get("PYTHONPATH") else []))
    child_env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    try:
        for r in range(world):
            e = dict(child_env, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world))
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, target, str(r),
                     str(world), store, args_path, outs[r], backend,
                     str(threads)],
                    env=e, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} at {world} ranks ran past "
                                   f"{timeout:.0f} s\n{_tails(logs)}")
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
        if any(c != 0 for c in codes):
            time.sleep(0.5)  # let the others fail on the broken group
            raise RuntimeError(f"{target} at {world} ranks: exit codes "
                               f"{[p.poll() for p in procs]}\n{_tails(logs)}")
        return [torch.load(o, weights_only=False) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in outs + [args_path, store]:
            if os.path.exists(path):
                os.remove(path)


def _tails(logs, n: int = 3000) -> str:
    out = []
    for r, path in enumerate(logs):
        try:
            with open(path) as f:
                text = f.read()
        except OSError:
            text = ""
        out.append(f"--- rank {r} ---\n{text[-n:]}")
    return "\n".join(out)


def _child(target, rank, world, store, args_path, out, backend, threads):
    import torch
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel.multihost import TIMEOUT

    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(**torch.load(args_path, weights_only=False))
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    t, r, w, s, a, o, b, th = sys.argv[1:9]
    _child(t, int(r), int(w), s, a, o, b, int(th))
