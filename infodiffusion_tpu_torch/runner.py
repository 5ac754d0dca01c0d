"""Training and eval drivers for every mode
(JAX counterpart: ``infodiffusion_tpu/runner.py``).

The modes, artifact names and directory layouts are the JAX runner's, so
the reference's shell workflows translate one to one through
``python -m infodiffusion_tpu_torch``:

- ``train`` / ``train_latent_ddim``: :func:`train` (the image model over
  its dataset, or the latent prior over the latents ``save_latent``
  wrote), with ``--resume``, checkpoint retention, background saves,
  SIGTERM and ``INFODIFF_PREEMPT_AFTER_STEPS`` preemption, metrics
  fetched every ``INFODIFF_LOG_EVERY`` steps only and
  ``INFODIFF_PROFILE=<dir>`` (steps 10..20, a Chrome trace);
- ``eval``, ``eval_fid``, ``latent_quality``, ``plot_latent``,
  ``disentangle``, ``save_latent``, ``interpolate``: :func:`evaluate`;
- ``save_original_img``: :func:`save_original_img`.

Everything runs on one device: the card, or the CPU when
``INFODIFF_FORCE_CPU=1`` (or an explicit ``device``); with neither a card
nor that switch a run raises. Every random draw of a mode comes from one
``torch.Generator`` on that device, seeded with ``--r_seed``.

Where the port differs from the JAX runner: a run preempted mid-epoch
resumes at the batch after the last one it trained on (the JAX runner
re-runs the epoch), so a resumed run equals an uninterrupted one; the
train loop does not peek a batch before training, so its epoch k takes the
loader's k-th draw; ``plot_latent`` always uses the dependency-free
scatter; ``attr_classification`` is not ported.
"""

from __future__ import annotations

import math
import os
import signal
import threading
from typing import Optional

import numpy as np
import torch

from infodiffusion_tpu_torch.config import Config, generate_exp_string
from infodiffusion_tpu_torch.data import DataLoader, LatentDataset, get_dataset
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


def check_single_device(cfg: Config) -> None:
    """Refuse the flags that need more than one device: the port has no
    parallel layouts yet."""
    wanted = [flag for flag, on in (
        (f"--mesh_devices {cfg.mesh_devices}",
         cfg.mesh_devices is not None and cfg.mesh_devices > 1),
        ("--multihost", cfg.multihost), ("--fsdp", cfg.fsdp),
        (f"--tp {cfg.tp}", cfg.tp > 1), (f"--pp {cfg.pp}", cfg.pp > 1),
        (f"--sp {cfg.sp}", cfg.sp > 1)) if on]
    if wanted:
        raise NotImplementedError(
            f"{', '.join(wanted)}: the port runs on one device; its "
            f"parallel layouts are ROADMAP.md Queue 1 item 7 (parallelism)")


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


def _loader(cfg: Config, device, with_attrs=False, shuffle=None):
    flip, shuf = dataset_flags(cfg.dataset)
    if shuffle is not None:
        shuf = shuffle
    return DataLoader(get_dataset(cfg), cfg.batch_size, device=device,
                      shuffle=shuf, flip=flip, seed=cfg.r_seed,
                      with_attrs=with_attrs)


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
    ``cfg.epochs`` epochs; returns the train state."""
    check_single_device(cfg)
    seed = seed_everything(cfg.r_seed)
    cfg = cfg.with_dataset_config()
    device = resolve_device(device)
    print(dict(vars(cfg)))
    if latent:
        loader = DataLoader(LatentDataset(latent_npz_path(cfg)),
                            cfg.batch_size, device=device, shuffle=True,
                            seed=cfg.r_seed)
        model = build_model(cfg, latent=True, device=device)
        log_dir = os.path.join(cfg.log_folder,
                               generate_exp_string(cfg) + "_latent")
    else:
        loader = _loader(cfg, device)
        model = build_model(cfg, device=device)
        log_dir = os.path.join(cfg.log_folder, generate_exp_string(cfg))
    writer = MetricsWriter(log_dir, use_tb=cfg.tb_logger)
    tx = make_optimizer(cfg.learning_rate, cfg.epochs, max(len(loader), 1))
    state = create_train_state(model.train(), seed, tx,
                               ema=cfg.ema_decay > 0)
    step_fn = make_train_step(model, tx, ema_decay=cfg.ema_decay)

    ckpt_root = checkpoint_root(cfg, latent=latent)
    start = (0, 0)
    if cfg.resume:
        last = latest_checkpoint_epoch(ckpt_root)
        if last is not None:
            state, start = restore_checkpoint(ckpt_root, last, state)
            # the resumed run's epoch k sees the uninterrupted run's order
            # and flips; the step draws follow (seed, step)
            loader.fast_forward(*start)
            print(f"Resumed from epoch {last} (step {state.step})")

    _PREEMPTED.clear()
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM, request_preempt)
    try:
        return _train_loop(cfg, loader, state, step_fn, start, writer,
                           ckpt_root, device)
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
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, out_dir: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Saved profiler trace to {path}")


def _fetch(metrics: dict) -> dict:
    """The metrics on the host, in one device-to-host copy."""
    vals = torch.stack([v.detach().to(torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def _train_loop(cfg, loader, state, step_fn, start, writer, ckpt_root,
                device):
    losses = AverageMeter("Loss", ":.4f")
    progress = ProgressMeter(cfg.epochs, [losses], prefix="Epoch ")
    log_every = int(os.environ.get("INFODIFF_LOG_EVERY", "50"))
    preempt_after = int(os.environ.get("INFODIFF_PREEMPT_AFTER_STEPS", "0"))
    profile = _StepProfile(device)
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
                if _PREEMPTED.is_set():
                    wait_for_saves()  # any background write first
                    path = save_checkpoint(ckpt_root, curr_epoch, state,
                                           position=(curr_epoch, i + 1))
                    print(f"Preempted at step {host_steps} of epoch "
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
            if last_metrics is not None and count == 0:
                total += _fetch(last_metrics)["loss"]
                count += 1
            losses.update(total / max(count, 1))
            progress.display(curr_epoch)
            print()
            writer.flush()
            if (curr_epoch + 1) % cfg.save_epochs == 0:
                path = save_checkpoint(
                    ckpt_root, curr_epoch + 1, state,
                    async_save=cfg.async_ckpt, keep=cfg.keep_checkpoints)
                print(f"Saved checkpoint to {path}")
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
    """Run the eval mode ``cfg.mode`` on the checkpoint at ``--epochs``."""
    check_single_device(cfg)
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
        raise NotImplementedError(
            "attr_classification needs FeatureClassifier and an AUROC, "
            "which the port does not have yet (ROADMAP.md, Queue 1)")
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


def _save_fid_batch(cfg, root, pending) -> bool:
    """One PNG per sample, ``sample-{n:06d}.png``; False once
    ``--sampling_number`` is reached."""
    (host, done), sample_num = pending
    if done is not None:
        done.synchronize()
    u8 = host.numpy()
    n = min(len(u8), cfg.sampling_number - sample_num)
    paths = [os.path.join(root, f"sample-{sample_num + bn:06d}.png")
             for bn in range(n)]
    write_png_batch(paths, u8[:n])
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


def save_original_img(cfg: Config, device=None):
    """The dataset as [0, 1]-scaled PNGs, one grid a batch
    (``./{dataset}_imgs/{i:06d}.png``)."""
    check_single_device(cfg)
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
