"""Checkpoints with full train-state resume
(JAX counterpart: ``infodiffusion_tpu/train/checkpoint.py``).

The directory contract is the JAX package's:
``{model_folder}/[vae|diff/]{exp}[_latent]/model-{epoch}`` (``checkpoint_root``).
The content is the port's own: ``state.pt``, a ``torch.save`` of the
parameters (the model's ``state_dict``), the optimizer state (count and the
f32 moments), the EMA, the step, the seed of the step draws and the
loader's position (the epoch and the batch within it), and ``meta.json``
that names the format. Each file is written to a temporary name and moved
into place with ``os.replace``; ``meta.json`` goes last, so a directory
without it is an unfinished write, never loaded. A directory that the JAX
package wrote (Orbax) is refused with an error that names both formats:
reading it needs jax.

``async_save`` copies the state to host memory at once, so later steps
cannot change what is saved, and writes it on one background thread;
retention for such a save waits until it is on disk (``wait_for_saves``).

Across ranks, ``save_checkpoint`` is called by every rank: a state laid
out by ``parallel/layout.py`` is gathered whole first (``layout=``), rank 0
alone writes the one-device format, synchronously, and every rank waits
for it at a barrier. A checkpoint written by N ranks therefore resumes in
one process and the other way round (the runner restores whole, then lays
the state out).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import torch

from infodiffusion_tpu_torch.train.state import TrainState

FORMAT = "infodiffusion_tpu_torch"
STATE_FILE = "state.pt"
META_FILE = "meta.json"


def checkpoint_root(cfg, latent: bool = False) -> str:
    """``{model_folder}/[vae|diff/]{exp}[_latent]``, absolute."""
    from infodiffusion_tpu_torch.config import generate_exp_string

    root = cfg.model_folder
    if cfg.model == "vae":
        root = os.path.join(root, "vae")
    elif cfg.model == "vanilla":
        root = os.path.join(root, "diff")
    exp = generate_exp_string(cfg)
    if latent:
        exp += "_latent"
    return os.path.abspath(os.path.join(root, exp))


def _path(root: str, epoch: int) -> str:
    return os.path.join(root, f"model-{epoch}")


# the one in-flight background save, and retention deferred past it:
# deleting older epochs while the new one is still being written could
# leave no complete checkpoint if the process dies mid-write
_writer: Optional[threading.Thread] = None
_writer_error: list = []
_pending_retention: Optional[tuple] = None


def _flush_pending_retention() -> None:
    global _pending_retention
    if _pending_retention is not None:
        root, keep, epoch = _pending_retention
        _pending_retention = None
        _apply_retention(root, keep, current=epoch)


def wait_for_saves() -> None:
    """Barrier for the in-flight background save (train end, and before a
    preemption save); re-raises its error."""
    global _writer
    if _writer is not None:
        _writer.join()
        _writer = None
    if _writer_error:
        err = _writer_error.pop()
        raise RuntimeError("background checkpoint write failed") from err
    _flush_pending_retention()


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _payload(state: TrainState, position) -> dict:
    """The saved content of ``state``, on the host."""
    return {
        "format": FORMAT,
        "step": int(state.step),
        "seed": int(state.seed),
        "params": {n: _host(p) for n, p in state.params.items()},
        "opt_state": {
            "count": int(state.opt_state.count),
            "mu": [_host(t) for t in state.opt_state.mu],
            "nu": [_host(t) for t in state.opt_state.nu],
        },
        "ema_params": (None if state.ema_params is None else
                       {n: _host(t) for n, t in state.ema_params.items()}),
        "loader": {"epoch": int(position[0]), "batch": int(position[1])},
    }


def _write(path: str, payload: dict) -> None:
    os.makedirs(path, exist_ok=True)
    meta = os.path.join(path, META_FILE)
    if os.path.exists(meta):  # overwritten: unfinished until meta is back
        os.remove(meta)
    tmp = os.path.join(path, f".{STATE_FILE}.tmp-{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    tmp = os.path.join(path, f".{META_FILE}.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump({"format": FORMAT, "step": payload["step"],
                   "loader": payload["loader"]}, f)
    os.replace(tmp, meta)


def save_checkpoint(root: str, epoch: int, state: TrainState, *,
                    async_save: bool = False, keep: Optional[int] = None,
                    position=None, layout=None) -> str:
    """Write the full train state to ``root/model-{epoch}``.

    ``position`` is the loader's (epoch, batch) to resume at; default
    (epoch, 0), an epoch boundary. ``async_save`` writes on the background
    thread (at most one save in flight); ``keep`` deletes all but the
    newest ``keep`` epochs once the save is on disk. In a run of several
    ranks every rank calls this; ``layout`` gathers a laid-out state whole,
    and only rank 0 writes (see the module docstring)."""
    global _writer, _pending_retention
    from infodiffusion_tpu_torch.parallel import multihost

    path = _path(root, epoch)
    if layout is not None:
        state = layout.whole_state(state)
    if multihost.world_size() > 1:
        if multihost.is_main_process():
            _write(path, _payload(state, position or (epoch, 0)))
            if keep is not None:
                _apply_retention(root, keep, current=epoch)
        multihost.barrier()
        return path
    payload = _payload(state, position or (epoch, 0))
    if async_save:
        wait_for_saves()  # the previous save is on disk now

        def run():
            try:
                _write(path, payload)
            except BaseException as e:  # noqa: BLE001 - wait_for_saves raises
                _writer_error.append(e)

        _writer = threading.Thread(target=run, name="checkpoint-writer",
                                   daemon=False)
        _writer.start()
    else:
        _write(path, payload)
    if keep is not None:
        if async_save:
            _pending_retention = (root, keep, epoch)
        else:
            _apply_retention(root, keep, current=epoch)
    return path


def _apply_retention(root: str, keep: int, current: int) -> None:
    """Delete all but the newest ``keep`` epochs under root; ``current``
    counts and is never deleted."""
    epochs = {current}
    for name in os.listdir(root) if os.path.isdir(root) else []:
        m = re.fullmatch(r"model-(\d+)", name)
        if m and os.path.isdir(os.path.join(root, name)):
            epochs.add(int(m.group(1)))
    doomed = sorted(epochs)[:-keep] if keep > 0 else []
    for e in doomed:
        if e != current:
            shutil.rmtree(_path(root, e), ignore_errors=True)


def latest_checkpoint_epoch(root: str) -> Optional[int]:
    """The newest ``model-{epoch}`` under ``root`` (None when there is
    none)."""
    if not os.path.isdir(root):
        return None
    epochs = []
    for name in os.listdir(root):
        m = re.fullmatch(r"model-(\d+)", name)
        if m and os.path.isdir(os.path.join(root, name)):
            epochs.append(int(m.group(1)))
    return max(epochs) if epochs else None


def _check_format(path: str) -> None:
    """Raise unless ``path`` holds a finished checkpoint of this format."""
    meta = os.path.join(path, META_FILE)
    if os.path.exists(meta):
        with open(meta) as f:
            fmt = json.load(f).get("format")
        if fmt == FORMAT:
            return
        raise ValueError(f"{path}: checkpoint format {fmt!r}, expected "
                         f"{FORMAT!r}")
    names = set(os.listdir(path))
    if names & {"_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
                "_sharding", "checkpoint"} or any(
            n.startswith("ocdbt") or n == "d" for n in names):
        raise ValueError(
            f"{path} is an Orbax checkpoint, written by the JAX package "
            f"(infodiffusion_tpu). The port reads only its own checkpoints "
            f"({STATE_FILE} + {META_FILE}, torch.save); loading an Orbax "
            f"checkpoint needs jax. Train with the port, or point "
            f"--model_folder elsewhere.")
    raise FileNotFoundError(
        f"{path} holds no finished checkpoint ({META_FILE} missing: the "
        f"write did not complete)")


def load_checkpoint(root: str, epoch: int, map_location=None) -> dict:
    """The saved payload of ``root/model-{epoch}``."""
    path = _path(root, epoch)
    _check_format(path)
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


@torch.no_grad()
def restore_checkpoint(root: str, epoch: int, target: TrainState):
    """Restore ``root/model-{epoch}`` into ``target`` in place (its
    tensors keep their devices and dtypes). Returns ``(target, (epoch,
    batch))``, the loader position to resume at."""
    saved = load_checkpoint(root, epoch, map_location=next(
        iter(target.params.values())).device)
    if set(saved["params"]) != set(target.params):
        raise ValueError(f"checkpoint params do not match the model: "
                         f"{sorted(set(saved['params']) ^ set(target.params))}")
    for name, p in target.params.items():
        p.copy_(saved["params"][name])
    opt = saved["opt_state"]
    target.opt_state.count = opt["count"]
    for dst, src in zip(target.opt_state.mu + target.opt_state.nu,
                        opt["mu"] + opt["nu"]):
        dst.copy_(src)
    if target.ema_params is not None:
        ema = saved["ema_params"] or saved["params"]
        for name, t in target.ema_params.items():
            t.copy_(ema[name])
    target.step = saved["step"]
    target.seed = saved["seed"]
    return target, (saved["loader"]["epoch"], saved["loader"]["batch"])


def restore_params(root: str, epoch: int, model: torch.nn.Module,
                   prefer_ema: bool = True):
    """Load ``root/model-{epoch}``'s weights into ``model``
    (``load_state_dict(strict=True)``, read onto the model's device), the
    EMA when it was saved and ``prefer_ema``. Returns ``model``."""
    path = _path(root, epoch)
    if not os.path.isdir(path):
        have = latest_checkpoint_epoch(root)
        hint = (
            f"latest saved epoch there is {have} — pass -e/--epochs {have}"
            if have is not None
            else f"no checkpoints under {root} — train first (--mode train)"
        )
        raise FileNotFoundError(
            f"Checkpoint {path} not found: eval modes load model-{{--epochs}}; {hint}."
        )
    saved = load_checkpoint(root, epoch,
                            map_location=next(model.parameters()).device)
    params = saved["params"]
    if prefer_ema and saved.get("ema_params") is not None:
        params = saved["ema_params"]
    model.load_state_dict(params, strict=True)
    return model
