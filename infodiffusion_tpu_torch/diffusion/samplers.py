"""Samplers (JAX counterpart: ``infodiffusion_tpu/diffusion/samplers.py``).

The JAX package compiles a whole trajectory into one ``lax.scan``; here a
trajectory is a Python loop of eager steps, except the latent one, which
runs as one kernel launch (K4, ``ops/cuda/latent_traj.py``) unless the
per-forward route (K5) is asked for.

- ``sample_loop``: DDPM ancestral / stochastic DDIM (eta 0.01) over the
  full T grid.
- ``reverse_sample_loop``: deterministic DDIM encoding x0 -> xT over
  idx = 1 .. T-2.
- ``two_phase_sample_loop``: the unconditional model for the steps
  n <= split_step (counted from xT), the conditional one after; with
  ``reference_quirk`` the unconditional one throughout.
- ``strided_ddim_loop``: DDIM-N on the evenly spaced subgrid, walked down
  to t_prev = -1.
- ``DiffusionProcess``: the image sampler over an InfoDiff (conditioned on
  ``a``) or a vanilla ``Diff`` (``cfg.model == 'vanilla'``), ``sampling``
  and ``reverse_sampling`` (with the reference's D13 quirk behind
  ``cfg.reverse_reference_quirk``), and the turbo tiers
  (``turbo='int8'``: W8A8 UNet conv bodies; ``'int8x'``: also each
  ResBlock's input read through an s8 view).
- ``TwoPhaseDiffusionProcess``: an InfoDiff and a vanilla Diff, sampling
  in two phases and reverse sampling through the InfoDiff, both models on
  the turbo tier under ``turbo=``.
- ``LatentDiffusionProcess``: sampling and reverse sampling of the latent
  prior on the route ``latent_route`` picks: the trajectory kernel K4
  (``turbo='int8'`` or ``'int8x'`` streams int8 weights), or, with
  ``INFODIFF_ENABLE_FUSED_LATENT=1``, ``sample_loop`` /
  ``reverse_sample_loop`` with one K5 forward per step, or, where the
  cluster core does not take a_dim or the kernels are switched off, those
  loops over the model's own forward.

``eps_fn(x, t, a)`` takes an int64 ``t`` [B]; random draws come from an
explicit ``torch.Generator`` on the device, or are injected with
``noises=`` (tests hand both implementations the same numbers).

The image processes take ``group=`` (a data process group): ``sampling``
then splits the batch's rows over its ranks, from draws made for the whole
batch (xT, a and every step's noise; ``parallel/batch.py``), and gathers
the result on every rank, so it equals the one-process trajectory. A
batch that does not divide over the group warns and runs whole, as the
JAX processes' ``_shard_for_mesh`` does. Sharded sampling is a library
API: the command line's eval modes run in one process
(``parallel.multihost.require_single_process``) and pass no group.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from infodiffusion_tpu_torch import tracing
from infodiffusion_tpu_torch.diffusion.schedule import (
    Schedule,
    ddim_reverse_step,
    ddim_step,
    ddpm_step,
    make_schedule,
    strided_ddim_step,
)
from infodiffusion_tpu_torch.ops import quant as q8
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import (
    fused_latent_supported,
    latent_eps_fn,
    pack_latent_unet_params,
    use_fused_latent,
)
from infodiffusion_tpu_torch.ops.cuda.latent_traj import (
    latent_route,
    latent_trajectory,
    quantize_packed_weights,
)
from infodiffusion_tpu_torch.parallel.batch import (
    BatchRows,
    batch_scope,
    draw_rows,
)


def _full_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return idx.expand(x.shape[0])


def _noise(x: torch.Tensor, generator) -> torch.Tensor:
    """A step's draw shaped like ``x`` (this rank's rows of the whole
    batch's draw when sampling is split over a group)."""
    return draw_rows(lambda n: torch.randn(
        (n,) + tuple(x.shape[1:]), generator=generator, device=x.device,
        dtype=x.dtype), x.shape[0])


def _split_rows(group, batch: int) -> Optional[BatchRows]:
    """This rank's rows of a ``batch``-row sampling batch over ``group``
    (None: one rank, or a batch that does not divide, which warns)."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return None
    n = dist.get_world_size(group)
    if batch % n:
        warnings.warn(
            f"sampling batch size {batch} does not divide the {n}-way data "
            f"group; sampling the whole batch on every rank (pad or resize "
            f"the batch to a multiple of {n} to split it)", stacklevel=3)
        return None
    return BatchRows(group, dist.get_rank(group), n, batch)


def _rows_of(rows: Optional[BatchRows], t: Optional[torch.Tensor]):
    return t if rows is None or t is None else t[rows.lo:rows.hi]


def sample_loop(
    eps_fn: Callable,
    sched: Schedule,
    xT: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    a: Optional[torch.Tensor] = None,
    *,
    deterministic: bool = False,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-grid reverse diffusion; ``deterministic`` selects stochastic
    DDIM (eta 0.01), else DDPM. ``noises`` [T, *xT.shape] injects the
    per-step draws, ``noises[i]`` at timestep T-1-i."""
    x = xT
    idxs = torch.arange(sched.T - 1, -1, -1, device=xT.device)
    for i in range(sched.T):
        idx = idxs[i]
        eps = eps_fn(x, _full_t(x, idx), a)
        noise = (noises[i] if noises is not None else _noise(
            x, generator))
        if deterministic:
            x = ddim_step(sched, x, idx, eps, noise)
        else:
            noise = torch.where(idx == 0, torch.zeros_like(noise), noise)
            x = ddpm_step(sched, x, idx, eps, noise)
    return x


def reverse_sample_loop(
    eps_fn: Callable,
    sched: Schedule,
    x0: torch.Tensor,
    a: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Deterministic DDIM encoding x0 -> xT over idx = 1 .. T-2 (the
    reference's idx 0 step is a no-op)."""
    x = x0
    idxs = torch.arange(1, sched.T - 1, device=x0.device)
    for i in range(idxs.shape[0]):
        idx = idxs[i]
        x = ddim_reverse_step(sched, x, idx, eps_fn(x, _full_t(x, idx), a))
    return x


def two_phase_sample_loop(
    eps_fn_cond: Callable,
    eps_fn_uncond: Callable,
    sched: Schedule,
    xT: torch.Tensor,
    generator: Optional[torch.Generator],
    a: torch.Tensor,
    split_step: int,
    *,
    deterministic: bool = False,
    reference_quirk: bool = False,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-grid two-phase sampling: step n (0 at xT) runs
    ``eps_fn_uncond(x, t)`` when n <= split_step, else
    ``eps_fn_cond(x, t, a)``; ``reference_quirk`` runs the unconditional
    model on every step. Updates and ``noises`` as in ``sample_loop``."""
    x = xT
    idxs = torch.arange(sched.T - 1, -1, -1, device=xT.device)
    for n in range(sched.T):
        idx = idxs[n]
        t = _full_t(x, idx)
        if reference_quirk or n <= split_step:
            eps = eps_fn_uncond(x, t)
        else:
            eps = eps_fn_cond(x, t, a)
        noise = (noises[n] if noises is not None else _noise(
            x, generator))
        if deterministic:
            x = ddim_step(sched, x, idx, eps, noise)
        else:
            noise = torch.where(idx == 0, torch.zeros_like(noise), noise)
            x = ddpm_step(sched, x, idx, eps, noise)
    return x


def strided_timesteps(T: int, num_steps: int, device=None):
    """The DDIM-N grid: ``num_steps`` evenly spaced points of 0..T-1 walked
    from high noise, and the step targets, ending at -1 (x0)."""
    ts = torch.linspace(0, T - 1, num_steps, dtype=torch.float32)
    ts = ts.round().to(torch.int64).flip(0)
    ts_prev = torch.cat([ts[1:], torch.tensor([-1])])
    return ts.to(device), ts_prev.to(device)


def strided_ddim_loop(
    eps_fn: Callable,
    sched: Schedule,
    xT: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    a: Optional[torch.Tensor] = None,
    *,
    num_steps: int = 100,
    eta: float = 0.0,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fast DDIM-N over the subsampled grid. With eta 0 (the default) the
    trajectory draws nothing; otherwise ``noises`` [num_steps, *xT.shape]
    injects the draws, or ``generator`` makes them. Each step is the span
    ``gen.ddim_step``."""
    x = xT
    ts, ts_prev = strided_timesteps(sched.T, num_steps, xT.device)
    for i in range(num_steps):
        with tracing.span("gen.ddim_step"):
            t, t_prev = ts[i], ts_prev[i]
            eps = eps_fn(x, _full_t(x, t), a)
            if eta == 0.0:
                noise = torch.zeros_like(x)
            else:
                noise = (noises[i] if noises is not None else _noise(
                    x, generator))
                noise = torch.where(t_prev < 0, torch.zeros_like(noise),
                                    noise)
            x = strided_ddim_step(sched, x, t, t_prev, eps, noise, eta=eta)
    return x


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _resolve_turbo(cfg, turbo: Optional[str]) -> str:
    """The turbo tier: the argument, else ``cfg.turbo``, else
    ``INFODIFF_TURBO``. '' falls through; 'off' stops the fall-through.
    Returns '' or a tier of ``quant.MODES``; unknown names raise."""
    mode = turbo if turbo is not None else (
        getattr(cfg, "turbo", "") or q8.turbo_mode())
    if mode in ("", "off"):
        return ""
    q8.check_mode(mode)
    return mode


def _calibrated(cfg, model, data_shape, a_dim, mode: str) -> dict:
    """The quant state of ``model`` calibrated for ``mode`` ({} when off),
    left off the model."""
    if not mode:
        return {}
    q8.calibrate(model, data_shape, a_dim=a_dim, T=cfg.diffusion_steps,
                 mode=mode)
    state = q8.quant_state(model)
    q8.clear_quant_state(model)
    return state


class _Installed:
    """Installs one model's quant state at a time, for as long as that
    model runs: ``wrap(model, fn)`` returns ``fn`` behind a switch that
    installs ``states[model]`` (dropping the other model's) when the
    trajectory moves to ``model``; leaving the block clears both."""

    def __init__(self, states):
        self.states = states
        self.on = None

    def wrap(self, model, fn):
        def run(*args):
            if self.on is not model:
                self._clear()
                q8.load_quant_state(model, self.states[model])
                self.on = model
            return fn(*args)

        return run

    def _clear(self):
        if self.on is not None:
            q8.clear_quant_state(self.on)
            self.on = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._clear()


def _requirk_eps_fn(model, generator: torch.Generator) -> Callable:
    """The reference's reverse-sampling quirk (D13): ``a`` is dropped, so
    the InfoDiff re-encodes the current noisy sample at every step and
    routes ``a`` or ``a_q`` (drawn from ``generator``) to its backbone."""

    def eps_fn(x, t, _a):
        a_det, a_q, _, _ = model.encode(x, sample=True, generator=generator)
        return model(x, t, model._route_latent(a_det, a_q))

    return eps_fn


def _reverse_eps_fn(cfg, model, conditional: bool, a,
                    generator: Optional[torch.Generator]) -> Callable:
    """The eps function of DDIM encoding through ``model``: unconditional,
    or conditioned on ``a`` (required), or under
    ``cfg.reverse_reference_quirk`` the D13 re-encoding, which draws from
    ``generator``, else from one seeded with ``cfg.r_seed`` (as the JAX
    package derives its key)."""
    if not conditional:
        return lambda x, t, _a: model(x, t)
    if cfg.reverse_reference_quirk:
        if generator is None:
            generator = torch.Generator(
                device=_device_of(model)).manual_seed(cfg.r_seed)
        return _requirk_eps_fn(model, generator)
    if a is None:
        raise ValueError("reverse sampling a conditional model needs a")
    return model


class DiffusionProcess:
    """The image sampler. ``model`` is a port ``InfoDiff``, conditioned on
    ``a``, or a vanilla ``Diff`` when ``cfg.model == 'vanilla'``
    (unconditional); ``sampling`` draws xT ~ N(0, I), and for a
    conditional model a ~ N(0, I) when not given, from ``generator``. The
    carry stays f32 whatever the model's dtype.

    ``turbo='int8'`` (or ``cfg.turbo``, or ``INFODIFF_TURBO``) calibrates
    the activation scales once, here (``ops.quant.calibrate``), and the
    UNet's conv bodies then run W8A8; ``'int8x'`` calibrates the blocks'
    input views as well. The process keeps the quant state
    and installs it on the model's modules for the length of each
    ``sampling`` / ``reverse_sampling`` call only, so the model is left
    without it (training and other processes over the same model never see
    it). The vanilla Diff calibrates without ``a`` (``a_dim=None``), as
    the JAX process does. ``shape`` (C, H, W) overrides ``cfg.shape``.
    ``group`` splits ``sampling``'s rows over a data group (see the module
    docstring)."""

    def __init__(self, cfg, model: torch.nn.Module,
                 turbo: Optional[str] = None, shape=None, group=None):
        self.cfg = cfg
        self.group = group
        self.model = model.eval()
        c, h, w = shape if shape is not None else cfg.shape
        self.data_shape = (h, w, c)
        self.device = _device_of(model)
        self.is_conditional = cfg.model != "vanilla"
        self.sched = make_schedule(cfg.beta1, cfg.betaT, cfg.diffusion_steps,
                                   self.device)
        self.turbo = _resolve_turbo(cfg, turbo)
        self.quant = _calibrated(
            cfg, model, self.data_shape,
            cfg.a_dim if self.is_conditional else None, self.turbo)

    def _eps_fn(self) -> Callable:
        if self.is_conditional:
            return self.model
        return lambda x, t, a: self.model(x, t)

    @torch.no_grad()
    def sampling(self, generator: Optional[torch.Generator] = None,
                 sampling_number: int = 16, xT=None, a=None,
                 num_steps: Optional[int] = None):
        """``num_steps`` selects DDIM-N (None: ``cfg.sampling_steps``, and
        when that is None too, the full-grid sampler)."""
        if num_steps is None:
            num_steps = self.cfg.sampling_steps
        if xT is None:
            xT = torch.randn((sampling_number,) + self.data_shape,
                             generator=generator, device=self.device)
        if a is None and self.is_conditional:
            a = torch.randn((xT.shape[0], self.cfg.a_dim),
                            generator=generator, device=self.device)
        rows = _split_rows(self.group, xT.shape[0])
        q8.load_quant_state(self.model, self.quant)
        try:
            with batch_scope(rows):
                xT, a = _rows_of(rows, xT), _rows_of(rows, a)
                if num_steps is not None:
                    x = strided_ddim_loop(self._eps_fn(), self.sched, xT,
                                          generator, a, num_steps=num_steps)
                else:
                    x = sample_loop(self._eps_fn(), self.sched, xT,
                                    generator, a,
                                    deterministic=self.cfg.deterministic)
            return x if rows is None else rows.gather(x)
        finally:
            q8.clear_quant_state(self.model)

    @torch.no_grad()
    def reverse_sampling(self, x0: torch.Tensor, a=None,
                         generator: Optional[torch.Generator] = None):
        """Deterministic DDIM encoding x0 -> xT, conditioned on ``a`` (a
        conditional model needs it unless ``cfg.reverse_reference_quirk``,
        whose re-encoding draws from ``generator``, else from
        ``cfg.r_seed``)."""
        eps_fn = _reverse_eps_fn(self.cfg, self.model, self.is_conditional,
                                 a, generator)
        q8.load_quant_state(self.model, self.quant)
        try:
            return reverse_sample_loop(eps_fn, self.sched, x0, a)
        finally:
            q8.clear_quant_state(self.model)


class TwoPhaseDiffusionProcess:
    """Two-phase sampling over a conditional InfoDiff ``model1`` and an
    unconditional vanilla Diff ``model2`` (both on one device):
    ``sampling`` runs ``model2`` for the steps n <= ``cfg.split_step``,
    ``model1`` after (``model2`` throughout with
    ``cfg.two_phase_reference_quirk``); ``reverse_sampling`` encodes through
    ``model1`` (D13 quirk as in ``DiffusionProcess``).

    ``turbo='int8'`` (or ``'int8x'``) calibrates both models here,
    ``model1`` with ``a`` and ``model2`` without, as the JAX process does,
    and keeps both quant states; each is installed on its model only while
    that model's phase runs. ``shape`` (C, H, W) overrides ``cfg.shape``;
    ``group`` as in ``DiffusionProcess``."""

    def __init__(self, cfg, model1: torch.nn.Module, model2: torch.nn.Module,
                 turbo: Optional[str] = None, shape=None, group=None):
        self.cfg = cfg
        self.group = group
        self.model1 = model1.eval()
        self.model2 = model2.eval()
        c, h, w = shape if shape is not None else cfg.shape
        self.data_shape = (h, w, c)
        self.device = _device_of(model1)
        self.sched = make_schedule(cfg.beta1, cfg.betaT, cfg.diffusion_steps,
                                   self.device)
        self.turbo = _resolve_turbo(cfg, turbo)
        self.quant1 = _calibrated(cfg, model1, self.data_shape, cfg.a_dim,
                                  self.turbo)
        self.quant2 = _calibrated(cfg, model2, self.data_shape, None,
                                  self.turbo)

    def _installed(self) -> _Installed:
        return _Installed({self.model1: self.quant1,
                           self.model2: self.quant2})

    @torch.no_grad()
    def sampling(self, generator: Optional[torch.Generator] = None,
                 sampling_number: int = 16, xT=None, a=None, noises=None):
        """The full T grid; ``noises`` [T, *xT.shape] injects the draws."""
        if xT is None:
            xT = torch.randn((sampling_number,) + self.data_shape,
                             generator=generator, device=self.device)
        if a is None:
            a = torch.randn((xT.shape[0], self.cfg.a_dim),
                            generator=generator, device=self.device)
        rows = _split_rows(self.group, xT.shape[0])
        with self._installed() as quant, batch_scope(rows):
            x = two_phase_sample_loop(
                quant.wrap(self.model1, self.model1),
                quant.wrap(self.model2, lambda x, t: self.model2(x, t)),
                self.sched, _rows_of(rows, xT), generator, _rows_of(rows, a),
                self.cfg.split_step, deterministic=self.cfg.deterministic,
                reference_quirk=self.cfg.two_phase_reference_quirk,
                noises=noises if noises is None or rows is None
                else noises[:, rows.lo:rows.hi])
        return x if rows is None else rows.gather(x)

    @torch.no_grad()
    def reverse_sampling(self, x0: torch.Tensor, a=None,
                         generator: Optional[torch.Generator] = None):
        """DDIM encoding through ``model1``, as
        ``DiffusionProcess.reverse_sampling`` does for a conditional
        model."""
        eps_fn = _reverse_eps_fn(self.cfg, self.model1, True, a, generator)
        with self._installed() as quant:
            return reverse_sample_loop(quant.wrap(self.model1, eps_fn),
                                       self.sched, x0, a)


# the JAX process's warning where the trajectory kernel is not taken
_LATENT_TURBO_OFF = (
    "--turbo requested for the latent sampler but the whole-trajectory "
    "kernel is not active (mesh path, non-TPU backend, INFODIFF_DISABLE_* "
    "set, or unsupported a_dim) — the latent leg runs bf16; only the "
    "trajectory kernel carries the int8 weight stream")


class LatentDiffusionProcess:
    """The latent prior's sampler. ``model`` is a port
    ``Diff(is_latent=True)``. ``route`` is :func:`latent_route`'s choice,
    made here as the JAX process makes it: "k4" runs the whole trajectory
    as one K4 launch on the card (its plain version on the CPU) over the
    weights packed once, here, in the model's dtype, and ``turbo='int8'``
    quantizes them to K4's int8 stream (``quantize_packed_weights``); "k5"
    (opt-in ``INFODIFF_ENABLE_FUSED_LATENT=1``) runs ``sample_loop`` and
    ``reverse_sample_loop`` over ``latent_eps_fn``, one K5 launch per step;
    "torch" runs those loops over the model's own forward (stock torch ops,
    JAX's XLA scan) where the cluster core does not take a_dim or the
    kernels are switched off. The int8 stream is K4's only, so a turbo mode
    on the other routes warns, as the JAX process does, and samples
    unquantized."""

    def __init__(self, cfg, model: torch.nn.Module,
                 turbo: Optional[str] = None):
        self.cfg = cfg
        self.model = model.eval()
        self.device = _device_of(model)
        self.sched = make_schedule(cfg.beta1, cfg.betaT, cfg.diffusion_steps,
                                   self.device)
        self.turbo = _resolve_turbo(cfg, turbo)
        # the latent leg's one quantized form is K4's int8 weight stream;
        # 'int8x' (a residual-read form of the image UNet) has none of its
        # own, so it runs 'int8', as JAX normalizes it
        if self.turbo == "int8x":
            self.turbo = "int8"
        self.route = "torch"
        if fused_latent_supported(model.backbone, cfg.a_dim):
            self.route = latent_route(
                cfg.a_dim, model.dtype,
                use_fused_latent(next(model.parameters())))
        self.params = None
        if self.route != "torch":
            self.params = pack_latent_unet_params(model.backbone, cfg.a_dim,
                                                  dtype=model.dtype)
        if self.turbo and self.route != "k4":
            warnings.warn(_LATENT_TURBO_OFF)
        elif self.turbo:
            self.params = quantize_packed_weights(self.params)

    @property
    def per_forward(self) -> bool:
        """Whether the sampler runs K5 once a step."""
        return self.route == "k5"

    def _eps_fn(self) -> Callable:
        if self.route == "k5":
            return latent_eps_fn(self.params)
        return lambda x, t, a=None: self.model(x, t)

    @torch.no_grad()
    def sampling(self, generator: Optional[torch.Generator] = None,
                 sampling_number: int = 16, xT=None, noises=None):
        """``noises`` [T, B, a_dim] injects the per-step draws. The
        trajectory is the span ``gen.latent_prior``."""
        if xT is None:
            xT = torch.randn((sampling_number, self.cfg.a_dim),
                             generator=generator, device=self.device)
        with tracing.span("gen.latent_prior"):
            if self.route != "k4":
                return sample_loop(self._eps_fn(), self.sched, xT,
                                   generator,
                                   deterministic=self.cfg.deterministic,
                                   noises=noises)
            return latent_trajectory(
                self.params, self.sched, xT, generator,
                deterministic=self.cfg.deterministic, noises=noises,
            )

    @torch.no_grad()
    def reverse_sampling(self, x0: torch.Tensor) -> torch.Tensor:
        if self.route != "k4":
            return reverse_sample_loop(self._eps_fn(), self.sched, x0)
        return latent_trajectory(self.params, self.sched, x0,
                                 deterministic=True, reverse=True)
