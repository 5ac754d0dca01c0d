"""Training and eval drivers for every mode
(JAX counterpart: ``infodiffusion_tpu/runner.py``).

The modes, artifact names and directory layouts are the JAX runner's, so
the reference's shell workflows translate one to one through
``python -m infodiffusion_tpu_torch``:

- ``train`` / ``train_latent_ddim``: :func:`train` (the image model over
  its dataset, or the latent prior over the latents ``save_latent``
  wrote), with ``--resume``, checkpoint retention, background saves,
  SIGTERM and ``INFODIFF_PREEMPT_AFTER_STEPS`` preemption, metrics
  fetched every ``INFODIFF_LOG_EVERY`` steps only,
  ``INFODIFF_PROFILE=<dir>`` (steps 10..20, a Chrome trace with the
  port's spans) and ``INFODIFF_TRACE=1`` (the spans and counters of
  ``tracing.py`` at each fetch, as ``trace/...`` metrics);
- ``eval``, ``eval_fid``, ``latent_quality``, ``plot_latent``,
  ``disentangle``, ``save_latent``, ``interpolate``,
  ``attr_classification``: :func:`evaluate`;
- ``save_original_img``: :func:`save_original_img`.

A process runs on one device: the card, or the CPU when
``INFODIFF_FORCE_CPU=1`` (or an explicit ``device``); with neither a card
nor that switch a run raises. Every random draw of a mode comes from one
``torch.Generator`` on that device, seeded with ``--r_seed``.

Training runs across processes under ``torchrun`` (or ``--multihost``),
one rank a device, with the JAX runner's flags and rules
(:func:`parallel_plan`): ``--mesh_devices`` / ``--fsdp`` / ``--tp`` lay the
state out over a ``(data, model)`` mesh (``parallel/layout.py``), each rank
loading its rows of the global batch; ``--pp`` pipelines
``train_latent_ddim`` (``parallel/pp.py``, with data replicas where the
world is a multiple of the stages); ``--sp`` splits large attentions over
the ranks (``parallel/sp.py``). ``--pp`` and ``--sp`` own the devices and
drop the data mesh, with the JAX runner's warning. Rank 0 alone writes the
metrics, TensorBoard and checkpoints; the preemption decision is agreed
every ``INFODIFF_PREEMPT_SYNC_EVERY`` steps. The eval modes run in one
process (``require_single_process``), as the JAX runner's do on one host.

Where the port differs from the JAX runner: a run preempted mid-epoch
resumes at the batch after the last one it trained on (the JAX runner
re-runs the epoch), so a resumed run equals an uninterrupted one; the
train loop does not peek a batch before training, so its epoch k takes the
loader's k-th draw; ``plot_latent`` always uses the dependency-free
scatter; ``attr_classification``'s probe starts from the port's own draws
(JAX's cannot be reproduced) and scores with the port's ``auroc``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import signal
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from infodiffusion_tpu_torch import tracing
from infodiffusion_tpu_torch.config import Config, generate_exp_string
from infodiffusion_tpu_torch.data import DataLoader, LatentDataset, get_dataset
from infodiffusion_tpu_torch.data import native
from infodiffusion_tpu_torch.data.datasets import dataset_flags
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    LatentDiffusionProcess,
    TwoPhaseDiffusionProcess,
    _resolve_turbo,
)
from infodiffusion_tpu_torch.imaging import save_image, write_png, write_png_batch
from infodiffusion_tpu_torch.logging_utils import MetricsWriter
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.ops import quant as q8
from infodiffusion_tpu_torch.train.checkpoint import (
    checkpoint_root,
    latest_checkpoint_epoch,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    wait_for_saves,
)
from infodiffusion_tpu_torch.train.state import create_train_state, make_optimizer
from infodiffusion_tpu_torch.train.step import make_eval_encode_step, make_train_step
from infodiffusion_tpu_torch.utils import AverageMeter, ProgressMeter, cos, seed_everything

# the eleven etas of a latent traversal and the ten of an interpolation
DISENTANGLE_ETAS = (-1.5, -1.2, -0.9, -0.6, -0.3, 0.0, 0.3, 0.6, 0.9, 1.2, 1.5)
INTERPOLATE_ETAS = (0.0, 0.11, 0.22, 0.33, 0.44, 0.55, 0.66, 0.77, 0.88, 1.0)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """``device`` when given; else the CPU under ``INFODIFF_FORCE_CPU=1``;
    else the card, and with no card this raises (there is no quiet CPU
    run)."""
    if device is not None:
        return torch.device(device)
    if os.environ.get("INFODIFF_FORCE_CPU"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the card "
            "(INFODIFF_FORCE_CPU=1 runs it on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


# ---------------------------------------------------------------------------
# the parallel layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ParallelPlan:
    """How a training run lies over the ranks: the ``(data, model)`` mesh
    of the layouts (None under ``--pp`` / ``--sp`` and in one process),
    or the pipeline's mesh and microbatches, and the rows of each global
    batch this rank loads (None: all)."""

    mesh: object = None
    pp_mesh: object = None
    microbatches: int = 0
    rows: Optional[np.ndarray] = None

    def describe(self) -> str:
        if self.pp_mesh is not None:
            from infodiffusion_tpu_torch.parallel.mesh import (
                DATA_AXIS,
                STAGE_AXIS,
                axis_size,
            )

            dp = axis_size(self.pp_mesh, DATA_AXIS)
            return (f"GPipe latent training: "
                    f"{axis_size(self.pp_mesh, STAGE_AXIS)} stages x "
                    f"{self.microbatches} microbatches"
                    + (f" x {dp} data-parallel replicas" if dp > 1 else ""))
        if self.mesh is None:
            return "one device a process, the whole batch on each"
        return f"mesh {dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))}"


def _configure_sp(cfg: Config) -> None:
    """Arm (or clear) the sequence-parallel attention context (``--sp N``:
    ring attention over a ``seq`` group of N ranks once an attention has
    ``INFODIFF_SP_MIN_TOKENS`` tokens), with the JAX runner's two
    warnings."""
    from infodiffusion_tpu_torch.parallel.sp import configure_sp

    if cfg.sp <= 1:
        configure_sp(None)
        return
    from infodiffusion_tpu_torch.parallel.ring_attention import make_seq_mesh

    configure_sp(make_seq_mesh(cfg.sp))
    min_tokens = int(os.environ.get("INFODIFF_SP_MIN_TOKENS", "1024"))
    _say(f"[sp] ring attention armed: {cfg.sp}-way 'seq' group, >= "
         f"{min_tokens} tokens")
    levels = (tuple(int(i) for i in cfg.attn.split(",")) if cfg.attn
              else (2,))
    max_tokens = max((cfg.input_size // (2 ** lvl)) ** 2 for lvl in levels)
    if max_tokens < min_tokens:
        warnings.warn(
            f"--sp {cfg.sp} will never engage: the largest attention grid "
            f"for this config is {max_tokens} tokens (input_size "
            f"{cfg.input_size}, attn levels {levels}), below the "
            f"{min_tokens}-token threshold (INFODIFF_SP_MIN_TOKENS) — yet "
            "--sp still disables data-sharded batches. Drop the flag (or "
            "lower the threshold) unless you mean to force ring attention.")
        return
    profit_tokens = int(os.environ.get("INFODIFF_SP_PROFIT_TOKENS", "4096"))
    per_device = max_tokens // cfg.sp
    if per_device < profit_tokens:
        warnings.warn(
            f"--sp {cfg.sp} engages but leaves only {per_device} tokens per "
            f"device (largest grid {max_tokens}); below ~{profit_tokens} "
            "tokens/device (INFODIFF_SP_PROFIT_TOKENS) each ring hop's "
            "transfer is not hidden by its block's compute and SP runs "
            "latency-bound — on top of the data-parallel width it already "
            "takes. Prefer data parallelism unless attention memory forces "
            "the split.")


def parallel_plan(cfg: Config, latent: bool = False) -> ParallelPlan:
    """The JAX runner's rules for a training run: ``--pp`` only for
    ``train_latent_ddim``; ``--pp`` / ``--sp`` own the devices (``--fsdp``,
    ``--tp`` and data-sharded batches are dropped with a warning);
    otherwise, once a process group is up, the ``(data, model)`` mesh of
    ``--mesh_devices`` ranks with ``--tp`` over ``model``. In one process
    without a group every flag that needs devices a process does not have
    is a no-op, as on the JAX runner's single device; ``--sp`` > 1 asks for
    ranks and raises there, as JAX's does without the devices."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel import multihost
    from infodiffusion_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_index,
        axis_size,
        make_mesh,
    )

    use_pp = cfg.pp > 1
    if use_pp and not latent:
        raise ValueError(
            "--pp pipelines the LatentUNet middle stack and is only "
            "supported for --mode train_latent_ddim (the image UNet's skip "
            "connections couple its stages; parallel/pp.py)")
    _configure_sp(cfg)
    world = multihost.world_size()
    plan = ParallelPlan()
    if use_pp or cfg.sp > 1:
        dropped = [flag for flag, on in (
            ("--fsdp", cfg.fsdp), (f"--tp {cfg.tp}", cfg.tp > 1),
            ("data-sharded batches", world > 1 and not use_pp)) if on]
        if dropped:
            warnings.warn(
                f"--{'pp' if use_pp else 'sp'} owns the device mesh: "
                + ", ".join(dropped) + " disabled for this run (they need "
                "the 'data'/'model' mesh, which --pp/--sp replaces)")
    if use_pp:
        from infodiffusion_tpu_torch.parallel.pp import (
            make_dp_stage_mesh,
            microbatch_count,
        )

        if world % cfg.pp:
            raise ValueError(f"--pp {cfg.pp} must divide the world size "
                             f"{world}: the port runs one process a device")
        dp = 1 if os.environ.get("INFODIFF_PP_NO_DP") else world // cfg.pp
        if dp * cfg.pp != world:
            raise ValueError(f"INFODIFF_PP_NO_DP=1 needs the world size "
                             f"{world} to equal --pp {cfg.pp}")
        plan.microbatches = microbatch_count(cfg.pp)
        if cfg.batch_size % plan.microbatches:
            raise ValueError(
                f"--batch_size {cfg.batch_size} must be divisible by the "
                f"pipeline microbatch count {plan.microbatches} (--pp "
                f"{cfg.pp}; override with INFODIFF_PP_MICROBATCHES)")
        if (cfg.batch_size // plan.microbatches) % dp:
            raise ValueError(
                f"microbatch size {cfg.batch_size // plan.microbatches} does "
                f"not divide over the {dp} data-parallel pipeline replicas "
                f"(world {world} / --pp {cfg.pp}); the port has no idle "
                f"ranks to fall back to the 1-D stage layout with")
        plan.pp_mesh = make_dp_stage_mesh(dp, cfg.pp)
        mesh = plan.pp_mesh
    elif cfg.sp > 1 or not dist.is_initialized():
        return plan
    else:
        mesh = plan.mesh = make_mesh(cfg.mesh_devices, model_parallel=cfg.tp)
    plan.rows = multihost.local_row_indices(
        axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS),
        cfg.batch_size)
    return plan


def _say(msg: str) -> None:
    """Print on rank 0 only."""
    from infodiffusion_tpu_torch.parallel import multihost

    if multihost.is_main_process():
        print(msg)


# ---------------------------------------------------------------------------
# artifact paths
# ---------------------------------------------------------------------------


def image_root(cfg: Config) -> str:
    root = cfg.img_folder
    if cfg.model == "vae":
        root = os.path.join(root, "vae")
    elif cfg.model == "vanilla":
        root = os.path.join(root, "diff")
    return os.path.join(root, generate_exp_string(cfg))


def latent_npz_path(cfg: Config) -> str:
    """'{model}_{exp}_latent.npz' in the working directory, dots ->
    underscores."""
    return "{}_{}_latent.npz".format(
        cfg.model, generate_exp_string(cfg).replace(".", "_"))


def _mode_subdir(cfg: Config) -> str:
    if cfg.mode == "disentangle":
        return f"disentangle-{cfg.img_id}"
    if cfg.mode == "interpolate":
        return f"interpolate-{cfg.img_id}"
    return cfg.mode


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x)


def save_images(cfg: Config, sample, sample_num: int = 0, epoch: int = 0):
    """Mode-dependent grid layouts."""
    root = os.path.join(image_root(cfg), _mode_subdir(cfg))
    os.makedirs(root, exist_ok=True)
    arr = _host(sample)
    if cfg.mode == "train":
        path = os.path.join(root, f"sample-{epoch}.png")
        save_image(arr, path, normalize=True, value_range=(-1, 1), nrow=4)
    elif cfg.mode == "eval":
        path = os.path.join(root, f"sample{sample_num:05d}.png")
        save_image(arr, path, normalize=True, value_range=(-1, 1))
    elif cfg.mode in ("disentangle", "interpolate"):
        path = os.path.join(root, f"sample{sample_num}.png")
        save_image(arr, path, normalize=True, value_range=(-1, 1),
                   nrow=arr.shape[0])
    else:
        path = os.path.join(root, f"sample-{sample_num:06d}.png")
        save_image(arr, path)
    return path


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _loader(cfg: Config, device, with_attrs=False, shuffle=None,
            rows=None):
    flip, shuf = dataset_flags(cfg.dataset)
    if shuffle is not None:
        shuf = shuffle
    return DataLoader(get_dataset(cfg), cfg.batch_size, device=device,
                      shuffle=shuf, flip=flip, seed=cfg.r_seed,
                      with_attrs=with_attrs, rows=rows)


# calibrated encoder quant states under --turbo, one per (model, tier):
# the eval modes encode batch after batch with one model, and calibrating
# per batch would make each batch's int8 scales batch-dependent. Entries
# keep the model itself and re-check identity on a hit (a bare id() could
# alias a new model at a recycled address); FIFO eviction bounds them.
_ENCODER_QUANT_CACHE: dict = {}
_ENCODER_QUANT_CACHE_MAX = 4


def _encoder_quant(cfg: Config, model, x) -> Optional[dict]:
    """The encoder's quant state for the --turbo tier, calibrated on ``x``
    (the first data batch) on the first call per model; None when turbo is
    off."""
    mode = _resolve_turbo(cfg, None)
    if not mode:
        return None
    key = (id(model), mode)
    hit = _ENCODER_QUANT_CACHE.get(key)
    if hit is None or hit[0] is not model:
        while len(_ENCODER_QUANT_CACHE) >= _ENCODER_QUANT_CACHE_MAX:
            _ENCODER_QUANT_CACHE.pop(next(iter(_ENCODER_QUANT_CACHE)))
        q8.calibrate_encoder(model, x=x, mode=mode)
        hit = (model, q8.quant_state(model.encoder))
        q8.clear_quant_state(model.encoder)
        _ENCODER_QUANT_CACHE[key] = hit
    return hit[1]


def _encode(cfg: Config, model, x, quant) -> torch.Tensor:
    """Deterministic latents of ``x``: mu when KLD is on, else a; the
    encoder's quant state installed for the call only."""
    enc = make_eval_encode_step(model, pick_mu=cfg.kld_weight != 0)
    if not quant:
        return enc(x)
    q8.load_quant_state(model.encoder, quant)
    try:
        return enc(x)
    finally:
        q8.clear_quant_state(model.encoder)


def _encode_batch(cfg: Config, model, x) -> torch.Tensor:
    return _encode(cfg, model, x, _encoder_quant(cfg, model, x))


def _encode_dataset(cfg: Config, model, device):
    """The whole dataset's deterministic latents, (all_a [N, a_dim] f32,
    all_attr); the latents stay on the device until the end (one copy
    back)."""
    loader = _loader(cfg, device, with_attrs=True, shuffle=False)
    all_a, all_attr, quant = [], [], None
    for i, (x, attr) in enumerate(loader):
        if i == 0:
            quant = _encoder_quant(cfg, model, x)
        all_a.append(_encode(cfg, model, x, quant).to(torch.float32))
        all_attr.append(
            np.asarray(attr) if attr is not None else
            np.full((len(x),), "No Attributes", dtype=object))
    return (torch.cat(all_a).cpu().numpy(), np.concatenate(all_attr))


def _nth_batch(loader, n: int):
    """The batch at index n (the last one when the loader is shorter)."""
    data = None
    for idx, item in enumerate(loader):
        data = item
        if idx == n:
            break
    return data[0] if isinstance(data, tuple) else data


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

_PREEMPTED = threading.Event()


def request_preempt(signum=None, frame=None):
    """Ask the training loop to save the full state and return at the next
    step boundary: the SIGTERM handler during :func:`train`, and what
    ``INFODIFF_PREEMPT_AFTER_STEPS=N`` fires after N steps."""
    _PREEMPTED.set()


def train(cfg: Config, latent: bool = False, device=None):
    """Train the image model (or, with ``latent``, the latent prior) for
    ``cfg.epochs`` epochs; returns the train state (this rank's pieces of
    it under a layout)."""
    from infodiffusion_tpu_torch.parallel import multihost
    from infodiffusion_tpu_torch.parallel.layout import Layout, describe
    from infodiffusion_tpu_torch.parallel.mesh import replicate

    multihost.maybe_initialize(cfg.multihost)
    seed = seed_everything(cfg.r_seed)
    cfg = cfg.with_dataset_config()
    plan = parallel_plan(cfg, latent)
    device = resolve_device(device)
    _say(str(dict(vars(cfg))))
    if latent:
        loader = DataLoader(LatentDataset(latent_npz_path(cfg)),
                            cfg.batch_size, device=device, shuffle=True,
                            seed=cfg.r_seed, rows=plan.rows)
        model = build_model(cfg, latent=True, device=device)
        log_dir = os.path.join(cfg.log_folder,
                               generate_exp_string(cfg) + "_latent")
    else:
        loader = _loader(cfg, device, rows=plan.rows)
        model = build_model(cfg, device=device)
        log_dir = os.path.join(cfg.log_folder, generate_exp_string(cfg))
    # one writer for the run: ranks on a shared filesystem must not write
    # the same metrics and TensorBoard files
    writer = MetricsWriter(log_dir, use_tb=cfg.tb_logger,
                           enabled=multihost.is_main_process())
    tx = make_optimizer(cfg.learning_rate, cfg.epochs, max(len(loader), 1))
    replicate(model.parameters())
    state = create_train_state(model.train(), seed, tx,
                               ema=cfg.ema_decay > 0)

    ckpt_root = checkpoint_root(cfg, latent=latent)
    start = (0, 0)
    if cfg.resume:
        last = latest_checkpoint_epoch(ckpt_root)
        if last is not None:
            # restored whole on every rank, then laid out below
            state, start = restore_checkpoint(ckpt_root, last, state)
            # the resumed run's epoch k sees the uninterrupted run's order
            # and flips; the step draws follow (seed, step)
            loader.fast_forward(*start)
            _say(f"Resumed from epoch {last} (step {state.step})")
    layout = None
    if plan.pp_mesh is not None:
        from infodiffusion_tpu_torch.parallel.pp import make_pp_train_step

        step_fn = make_pp_train_step(model, tx, plan.pp_mesh,
                                     plan.microbatches,
                                     ema_decay=cfg.ema_decay)
    elif plan.mesh is not None:
        layout = Layout.for_model(model, plan.mesh, fsdp=cfg.fsdp)
        state = layout.shard_state(model, state)
        step_fn = make_train_step(model, tx, ema_decay=cfg.ema_decay,
                                  layout=layout)
    else:
        step_fn = make_train_step(model, tx, ema_decay=cfg.ema_decay)
    if multihost.world_size() > 1 or plan.mesh is not None:
        _say(f"[parallel] {multihost.world_size()} ranks: "
             f"{plan.describe()}; {describe(layout)}")

    _PREEMPTED.clear()
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM, request_preempt)
    try:
        return _train_loop(cfg, loader, state, step_fn, start, writer,
                           ckpt_root, device, layout)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


class _StepProfile:
    """``INFODIFF_PROFILE=<dir>``: a torch.profiler capture of steps 10..20
    of the first epoch it sees, exported as ``<dir>/trace.json``."""

    def __init__(self, device):
        self.dir = os.environ.get("INFODIFF_PROFILE")
        self.device = device
        self.prof = None
        self.done = self.dir is None

    def at(self, i: int):
        if self.done:
            return
        if i == 10 and self.prof is None:
            self.prof = _start_profiler(self.device)
        elif i == 20 and self.prof is not None:
            self.stop()

    def stop(self):
        if self.prof is not None:
            _stop_profiler(self.prof, self.dir, self.device)
            self.prof = None
            self.done = True


def _start_profiler(device):
    """A started capture, with the port's spans on until it stops."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    tracing.enable()
    return prof


def _stop_profiler(prof, out_dir: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tracing.disable()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Saved profiler trace to {path}")


def _trace_scalars(snap: dict) -> dict:
    """A ``tracing.snapshot()`` as metrics: each span's count and mean ms,
    and each counter."""
    out = {}
    for name, rec in snap["spans"].items():
        out[f"{name}.count"] = rec["count"]
        out[f"{name}.mean_ms"] = rec["total_s"] / rec["count"] * 1e3
    out.update(snap["counters"])
    return out


def _fetch(metrics: dict) -> dict:
    """The metrics on the host, in one device-to-host copy."""
    vals = torch.stack([v.detach().to(torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


# steps between the ranks' preemption agreements (a collective)
_PREEMPT_SYNC_EVERY = int(os.environ.get("INFODIFF_PREEMPT_SYNC_EVERY", "10"))


def _preempt_now(host_steps: int) -> bool:
    """The preemption decision at this step boundary: the local flag in one
    process; across ranks, any rank's flag, agreed on at the same step
    boundaries (every ``_PREEMPT_SYNC_EVERY`` steps), so no rank leaves the
    loop while the others enter the next gradient all-reduce."""
    from infodiffusion_tpu_torch.parallel import multihost

    if multihost.world_size() == 1:
        return _PREEMPTED.is_set()
    if host_steps % _PREEMPT_SYNC_EVERY:
        return False
    return multihost.agree_on_preemption(_PREEMPTED.is_set())


def _train_loop(cfg, loader, state, step_fn, start, writer, ckpt_root,
                device, layout=None):
    from infodiffusion_tpu_torch.parallel import multihost

    main = multihost.is_main_process()
    losses = AverageMeter("Loss", ":.4f")
    progress = ProgressMeter(cfg.epochs, [losses], prefix="Epoch ")
    log_every = int(os.environ.get("INFODIFF_LOG_EVERY", "50"))
    preempt_after = int(os.environ.get("INFODIFF_PREEMPT_AFTER_STEPS", "0"))
    profile = _StepProfile(device)
    if tracing.exported:
        tracing.reset()
    host_steps = 0
    start_epoch, start_batch = start
    try:
        for curr_epoch in range(start_epoch, cfg.epochs):
            total, count, last_metrics = 0.0, 0, None
            first = start_batch if curr_epoch == start_epoch else 0
            for i, batch in enumerate(loader, start=first):
                if isinstance(batch, tuple):
                    batch = batch[0]
                profile.at(i)
                state, metrics = step_fn(state, batch, curr_epoch)
                last_metrics = metrics
                host_steps += 1
                if preempt_after and host_steps >= preempt_after:
                    request_preempt()
                if _preempt_now(host_steps):
                    wait_for_saves()  # any background write first
                    path = save_checkpoint(ckpt_root, curr_epoch, state,
                                           position=(curr_epoch, i + 1),
                                           layout=layout)
                    _say(f"Preempted at step {host_steps} of epoch "
                         f"{curr_epoch}: saved full train state to {path}; "
                         f"continue with --resume")
                    writer.close()
                    return state
                # metrics only every log_every steps: a per-step fetch
                # would wait for the device every step
                if i % log_every == 0:
                    vals = _fetch(metrics)
                    if not np.isfinite(vals["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss {vals['loss']} at step "
                            f"{state.step} (epoch {curr_epoch}) — check "
                            f"LR/precision; metrics: {vals}")
                    total += vals["loss"]
                    count += 1
                    writer.write(state.step, vals)
                    if tracing.exported:
                        writer.write(state.step, _trace_scalars(
                            tracing.snapshot()), prefix="trace")
                        tracing.reset()
            if last_metrics is not None and count == 0:
                total += _fetch(last_metrics)["loss"]
                count += 1
            losses.update(total / max(count, 1))
            if main:
                progress.display(curr_epoch)
                print()
            writer.flush()
            if (curr_epoch + 1) % cfg.save_epochs == 0:
                path = save_checkpoint(
                    ckpt_root, curr_epoch + 1, state,
                    async_save=cfg.async_ckpt, keep=cfg.keep_checkpoints,
                    layout=layout)
                _say(f"Saved checkpoint to {path}")
        wait_for_saves()
    finally:
        profile.stop()
    writer.close()
    return state


# ---------------------------------------------------------------------------
# eval modes
# ---------------------------------------------------------------------------


def _build_eval(cfg: Config, device):
    """The model of ``cfg`` with the weights of ``model-{--epochs}``."""
    cfg = cfg.with_dataset_config()
    model = build_model(cfg, device=device)
    restore_params(checkpoint_root(cfg), cfg.epochs, model)
    return cfg, model.eval()


def _second_model(cfg: Config, device):
    """eval_fid's second model: the latent prior from ``{exp}_latent``, or
    a separately trained vanilla UNet."""
    if cfg.is_latent:
        model2 = build_model(cfg, latent=True, device=device)
        restore_params(checkpoint_root(cfg, latent=True), cfg.epochs, model2)
        return model2.eval()
    vanilla_cfg = cfg.replace(model="vanilla", mmd_weight=0.0, kld_weight=0.0)
    model2 = build_model(vanilla_cfg, device=device)
    restore_params(checkpoint_root(vanilla_cfg), cfg.epochs, model2)
    return model2.eval()


def evaluate(cfg: Config, device=None):
    """Run the eval mode ``cfg.mode`` on the checkpoint at ``--epochs``
    (one process)."""
    from infodiffusion_tpu_torch.parallel.multihost import (
        require_single_process,
    )

    require_single_process(f"--mode {cfg.mode}")
    _configure_sp(cfg)
    seed = seed_everything(cfg.r_seed)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg, model = _build_eval(cfg, device)
    # only the modes that sample build the sampler (under --turbo its
    # construction calibrates)
    process = None
    if cfg.model in ("diff", "vanilla") and cfg.mode in (
            "eval", "latent_quality", "disentangle", "interpolate"):
        process = DiffusionProcess(cfg, model)
    profile_dir = os.environ.get("INFODIFF_PROFILE")
    prof = _start_profiler(device) if profile_dir else None
    try:
        return _run_eval_mode(cfg, model, process, gen, device)
    finally:
        if prof is not None:
            _stop_profiler(prof, profile_dir, device)


def _run_eval_mode(cfg, model, process, gen, device):
    mode = cfg.mode
    if mode == "eval":
        return _mode_eval(cfg, model, process, gen)
    if mode == "eval_fid":
        return _mode_eval_fid(cfg, model, gen, device)
    if mode == "latent_quality":
        return _mode_latent_quality(cfg, model, process, gen, device)
    if mode == "plot_latent":
        return _mode_plot_latent(cfg, model, device)
    if mode == "disentangle":
        return _mode_disentangle(cfg, model, process, gen, device)
    if mode == "save_latent":
        return _mode_save_latent(cfg, model, device)
    if mode == "interpolate":
        return _mode_interpolate(cfg, model, process, gen, device)
    if mode == "attr_classification":
        return _mode_attr_classification(cfg, model, device)
    raise ValueError(mode)


def _decode(model, a):
    with torch.no_grad():
        return model.decode(a)


def _mode_eval(cfg, model, process, gen):
    """Grid samples."""
    if cfg.model in ("diff", "vanilla"):
        for sample_num in range(0, cfg.sampling_number, cfg.batch_size):
            sample = process.sampling(gen, sampling_number=16)
            save_images(cfg, sample, sample_num=sample_num)
    else:
        a = torch.randn((cfg.sampling_number, cfg.a_dim), generator=gen,
                        device=gen.device)
        save_images(cfg, _decode(model, a))


def _fid_root(cfg) -> str:
    sub = "eval-fid-latent" if cfg.is_latent else "eval-fid-fast"
    root = os.path.join(image_root(cfg), sub)
    os.makedirs(root, exist_ok=True)
    return root


def _fid_codes(batch: torch.Tensor) -> torch.Tensor:
    """Clip to [-1, 1], rescale to [0, 1], 8-bit codes: on the device, so
    one byte a pixel crosses back."""
    x = batch.to(torch.float32).clamp(-1.0, 1.0)
    return ((x + 1.0) / 2.0 * 255.0 + 0.5).to(torch.uint8)


def _to_host_async(t: torch.Tensor):
    """(host tensor, event): a copy into pinned memory queued behind the
    work that makes ``t``, and the event that marks it done (None on the
    CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


# which writer served each FID batch: "native" (the library's thread pool,
# data/native.py) or "imaging" (the standard-library writer)
FID_WRITERS: collections.Counter = collections.Counter()


def _save_fid_batch(cfg, root, pending) -> bool:
    """One PNG per sample, ``sample-{n:06d}.png``, through the native PNG
    writer, or ``imaging.write_png_batch`` where the library is
    unavailable; False once ``--sampling_number`` is reached."""
    (host, done), sample_num = pending
    if done is not None:
        done.synchronize()
    u8 = host.numpy()
    n = min(len(u8), cfg.sampling_number - sample_num)
    paths = [os.path.join(root, f"sample-{sample_num + bn:06d}.png")
             for bn in range(n)]
    if native.write_png_batch(paths, u8[:n]):
        FID_WRITERS["native"] += 1
    else:
        write_png_batch(paths, u8[:n])
        FID_WRITERS["imaging"] += 1
    return n == len(u8)


def _mode_eval_fid(cfg, model, gen, device):
    """The FID image dump: the latent prior then DDIM (``--is_latent``),
    or two-phase sampling, ``--batch_size`` at a time."""
    root = _fid_root(cfg)
    print(f"Saving images to {root}")
    if cfg.model == "diff":
        model2 = _second_model(cfg, device)
        if cfg.is_latent:
            process = DiffusionProcess(cfg, model)
            process_latent = LatentDiffusionProcess(cfg, model2)
        else:
            process = TwoPhaseDiffusionProcess(cfg, model, model2)

        def sample():
            if cfg.is_latent:
                batch_a = process_latent.sampling(
                    gen, sampling_number=cfg.batch_size)
                return process.sampling(gen, sampling_number=cfg.batch_size,
                                        a=batch_a)
            return process.sampling(gen, sampling_number=cfg.batch_size)
    elif cfg.model == "vae":
        def sample():
            a = torch.randn((cfg.batch_size, cfg.a_dim), generator=gen,
                            device=device)
            return _decode(model, a)
    else:
        return None
    # one batch in flight: batch n+1 is queued on the device before the
    # host waits for batch n's codes and writes its PNGs
    pending = None
    for sample_num in range(0, cfg.sampling_number, cfg.batch_size):
        queued = (_to_host_async(_fid_codes(sample())), sample_num)
        if pending is not None and not _save_fid_batch(cfg, root, pending):
            return root
        pending = queued
    if pending is not None:
        _save_fid_batch(cfg, root, pending)
    print("DONE")
    return root


def _mode_latent_quality(cfg, model, process, gen, device):
    """Re-sample ``--sampling_number`` images with the encoded a of one
    image and fresh xT draws."""
    data = _nth_batch(_loader(cfg, device, shuffle=False), 10)
    if cfg.kld_weight != 0:
        # the reference's quirk: a = mu + exp(0.5 * log_var), the std
        # added with no noise draw
        with torch.no_grad():
            _a, _aq, mu, log_var = model.encode(data, sample=False)
        a = mu + torch.exp(0.5 * log_var)
    else:
        a = _encode_batch(cfg, model, data)
    xT = process.reverse_sampling(data, a)
    n = cfg.sampling_number
    xT = torch.randn((xT.shape[0] * n,) + tuple(xT.shape[1:]), generator=gen,
                     device=device)
    batch = process.sampling(gen, xT=xT, a=a.repeat(n, 1))
    root = os.path.join(image_root(cfg), "latent_quality")
    os.makedirs(root, exist_ok=True)
    arr = (np.clip(_host(batch), -1, 1) + 1.0) / 2.0
    for bn, img in enumerate(arr):
        save_image(img, os.path.join(root, f"sample-{bn:06d}.png"))
    return root


def _mode_plot_latent(cfg, model, device):
    """Scatter of the first two latent dims, coloured by class."""
    all_a, all_attr = _encode_dataset(cfg, model, device)
    root = os.path.join(image_root(cfg), "plot_latent")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "plot_latent.png")
    labels = np.asarray(all_attr)
    if labels.ndim > 1:
        labels = labels[:, 0]
    # attribute-less datasets carry "No Attributes" strings: one colour
    try:
        labels = labels.astype(float)
    except (ValueError, TypeError):
        labels = np.zeros(len(labels), dtype=float)
    write_png(path, scatter_image(all_a[:, 0], all_a[:, 1], labels))
    print(f"Saved latent plot to {path}")
    return path


# tab10's colours
_PALETTE = np.asarray(
    [[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
     [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
     [188, 189, 34], [23, 190, 207]], np.uint8)


def scatter_image(x, y, c) -> np.ndarray:
    """A dependency-free scatter plot, [512, 512, 3] uint8: white, a 2x2
    dot a point, coloured by ``c`` mod 10."""
    size = 512
    img = np.full((size, size, 3), 255, np.uint8)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xs = ((x - x.min()) / max(np.ptp(x), 1e-9) * (size - 9) + 4).astype(int)
    ys = ((y - y.min()) / max(np.ptp(y), 1e-9) * (size - 9) + 4).astype(int)
    ci = (np.asarray(c) % 10).astype(int)
    for px, py, pc in zip(xs, ys, ci):
        img[size - 1 - py - 1: size - py + 1, px - 1: px + 1] = _PALETTE[pc]
    return img


def _mode_disentangle(cfg, model, process, gen, device):
    """Latent traversal: per latent dim, the image regenerated with that
    dim swept over eleven etas from one shared reverse-DDIM xT."""
    data = _nth_batch(_loader(cfg, device, shuffle=False), cfg.img_id)
    eta = torch.tensor(DISENTANGLE_ETAS, dtype=torch.float32, device=device)
    a = _encode_batch(cfg, model, data)
    if cfg.model == "diff":
        xT = process.reverse_sampling(data, a).repeat(len(eta), 1, 1, 1)
    for k in range(cfg.a_dim):
        a_batch = a.repeat(len(eta), 1)
        a_batch[:, k] = eta.to(a_batch.dtype)
        if cfg.model == "diff":
            sample = process.sampling(gen, xT=xT, a=a_batch)
        else:
            sample = _decode(model, a_batch)
        save_images(cfg, sample, sample_num=k)


def _mode_save_latent(cfg, model, device):
    """The whole dataset's latents (f32) and attributes to an npz."""
    all_a, all_attr = _encode_dataset(cfg, model, device)
    path = latent_npz_path(cfg)
    np.savez(path[: -len(".npz")], all_a=all_a.astype(np.float32),
             all_attr=all_attr)
    print(f"Saved latents to {path}")
    return path


def _mode_interpolate(cfg, model, process, gen, device):
    """Slerp between two images' xT and a cos/sin blend of their a, ten
    etas."""
    data = _nth_batch(_loader(cfg, device, shuffle=False), cfg.img_id)
    a = _encode_batch(cfg, model, data)
    f32 = dict(dtype=torch.float32, device=device)
    # the blend's angles rounded once to f32, as the JAX runner takes them
    ang = [torch.tensor(e * math.pi / 2, **f32) for e in INTERPOLATE_ETAS]
    intp_a = torch.stack([torch.cos(w) * a[0] + torch.sin(w) * a[1]
                          for w in ang])
    if cfg.model in ("diff", "vanilla"):
        xT = process.reverse_sampling(data, a)
        theta = torch.arccos(cos(xT[0], xT[1]))
        intp_x = torch.stack([
            (torch.sin((1 - e) * theta) * xT[0]
             + torch.sin(e * theta) * xT[1]) / torch.sin(theta)
            for e in INTERPOLATE_ETAS])
        sample = process.sampling(gen, xT=intp_x, a=intp_a)
    else:
        sample = _decode(model, intp_a)
    return save_images(cfg, sample)


def _bce(prob: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    eps = 1e-7
    return -(y * torch.log(prob + eps)
             + (1 - y) * torch.log(1 - prob + eps)).mean()


def _mode_attr_classification(cfg, model, device):
    """Train the FeatureClassifier probe on the encoder's latents of the
    dataset (the first 80%, attributes binarised as y > 0) and report the
    per-attribute AUROC on the rest: 20 epochs of Adam (lr 1e-3) at
    ``min(256, n_train)``, each epoch's order from ``RandomState(epoch)``.
    The probe's initial weights and its dropout masks come from generators
    seeded with ``--r_seed``."""
    import json

    from infodiffusion_tpu_torch.metrics import auroc
    from infodiffusion_tpu_torch.models.wrappers import FeatureClassifier

    all_a, all_attr = _encode_dataset(cfg, model, device)
    y = np.asarray(all_attr)
    if y.ndim == 1:
        y = y[:, None]
    y = (y > 0).astype(np.float32)
    n_tr = int(len(all_a) * 0.8)
    a = torch.from_numpy(all_a).to(device)
    y_dev = torch.from_numpy(y).to(device)
    te_y = y[n_tr:]

    clf = FeatureClassifier(
        all_a.shape[1], y.shape[1],
        generator=torch.Generator().manual_seed(cfg.r_seed)).to(device)
    opt = torch.optim.Adam(clf.parameters(), lr=1e-3)
    drop = torch.Generator(device=device).manual_seed(cfg.r_seed)
    bs = min(256, n_tr)
    for epoch in range(20):
        perm = torch.from_numpy(
            np.random.RandomState(epoch).permutation(n_tr)).to(device)
        for i in range(0, n_tr - bs + 1, bs):
            sl = perm[i:i + bs]
            loss = _bce(clf(a[sl], deterministic=False, generator=drop),
                        y_dev[sl])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    with torch.no_grad():
        probs = clf(a[n_tr:]).cpu().numpy()
    aurocs = [auroc(te_y[:, j], probs[:, j]) for j in range(y.shape[1])
              if te_y[:, j].min() != te_y[:, j].max()]
    mean_auroc = float(np.mean(aurocs)) if aurocs else float("nan")
    root = os.path.join(image_root(cfg), "attr_classification")
    os.makedirs(root, exist_ok=True)
    out_path = os.path.join(root, "results.json")
    with open(out_path, "w") as f:
        json.dump({"mean_auroc": mean_auroc, "per_attr_auroc": aurocs}, f)
    print(f"attr_classification mean AUROC: {mean_auroc:.4f} "
          f"({len(aurocs)} attrs) -> {out_path}")
    return mean_auroc


def save_original_img(cfg: Config, device=None):
    """The dataset as [0, 1]-scaled PNGs, one grid a batch
    (``./{dataset}_imgs/{i:06d}.png``)."""
    from infodiffusion_tpu_torch.parallel.multihost import (
        require_single_process,
    )

    require_single_process("--mode save_original_img")
    cfg = cfg.with_dataset_config()
    device = resolve_device(device)
    out = f"./{cfg.dataset}_imgs/"
    os.makedirs(out, exist_ok=True)
    for i, batch in enumerate(_loader(cfg, device, shuffle=False)):
        if isinstance(batch, tuple):
            batch = batch[0]
        save_image((_host(batch) + 1.0) / 2.0,
                   os.path.join(out, f"{i:06d}.png"))
    print(f"Saved original images to {out}")
    return out
