"""Experiment configuration (JAX counterpart: ``infodiffusion_tpu/config.py``).

One dataclass with every field of the JAX ``Config``, under the same names
and defaults (the reference CLI's flags plus the JAX package's own knobs),
the same per-dataset override table and the same experiment-naming
contract. The port imports nothing of the JAX package, so this is its own
copy; ``tests/test_torch_ops.py`` holds the two against each other field by
field. Fields that name a multi-device layout (``mesh_devices``,
``multihost``, ``fsdp``, ``tp``, ``pp``, ``sp``) mean what they mean in
the JAX package, one process a device (``runner.parallel_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MODELS = ("diff", "vae", "vanilla")
MODES = (
    "train",
    "eval",
    "eval_fid",
    "save_latent",
    "disentangle",
    "interpolate",
    "save_original_img",
    "latent_quality",
    "train_latent_ddim",
    "plot_latent",
    # the JAX package's extension mode; the port raises NotImplementedError
    # for it (runner.py)
    "attr_classification",
)
PRIORS = ("regular", "10mix", "roll")
DATASETS = ("fmnist", "mnist", "celeba", "cifar10", "dsprites", "chairs", "ffhq")

# dataset -> (input_channels, unets_channels, encoder_channels, input_size)
DATASET_CONFIG = {
    "fmnist": (1, 32, 32, 32),
    "mnist": (1, 32, 32, 32),
    "dsprites": (1, 32, 32, 32),
    "celeba": (3, 64, 64, 64),
    "cifar10": (3, 64, 64, 32),
    "chairs": (3, 32, 32, 64),
    "ffhq": (3, 64, 64, 64),
}


@dataclasses.dataclass
class Config:
    # --- the reference CLI's flags ---
    r_seed: int = 0
    img_id: int = 0
    model: str = "diff"  # {diff, vae, vanilla}
    mode: str = "train"  # one of MODES
    prior: str = "regular"  # {regular, 10mix, roll}
    kld_weight: float = 0.0
    mmd_weight: float = 0.1
    use_C: bool = False
    C_max: float = 25.0
    dataset: str = "mnist"
    img_folder: str = "./imgs"
    log_folder: str = "./logs"
    epochs: int = 20
    save_epochs: int = 5
    batch_size: int = 64
    learning_rate: float = 1e-4
    optimizer: str = "adam"
    model_folder: str = "./models"
    deterministic: bool = False
    input_channels: int = 1
    unets_channels: int = 64
    encoder_channels: int = 64
    input_size: int = 32
    a_dim: int = 32
    beta1: float = 1e-5
    betaT: float = 1e-2
    diffusion_steps: int = 1000
    # two-phase sampling: steps n <= split_step (counted from xT) run the
    # unconditional model
    split_step: int = 500
    sampling_number: int = 16
    data_dir: str = "./data"
    tb_logger: bool = False
    is_latent: bool = False
    is_bottleneck: bool = False
    # accepted for the reference scripts, which pass it
    disent_metric: str = "tad"

    # --- the JAX package's own knobs ---
    # sampler steps; None => the full T grid
    sampling_steps: Optional[int] = None
    # inference tier of the samplers: '' (INFODIFF_TURBO decides), 'off'
    # or one of ops.quant.MODES
    turbo: str = ""
    # bf16 activations in the backbone (schedule math stays f32)
    bf16: bool = False
    # multi-device layouts (runner.parallel_plan)
    mesh_devices: Optional[int] = None
    multihost: bool = False
    # resume training from the latest checkpoint
    resume: bool = False
    fsdp: bool = False
    tp: int = 1
    pp: int = 1
    sp: int = 1
    # checkpoint writes on a background thread (barriered at train end and
    # before a preemption save)
    async_ckpt: bool = False
    # keep only the newest N checkpoint epochs (None: keep all)
    keep_checkpoints: Optional[int] = None
    # EMA of the parameters (0 = off); eval prefers the EMA when saved
    ema_decay: float = 0.0
    # architecture overrides, comma-separated ints ("1,2,2,2"); None takes
    # the reference's ch_mult table and attn (2,)
    ch_mult: Optional[str] = None
    attn: Optional[str] = None
    # the reference's two-phase quirk: its phase-2 (unconditional) model
    # runs the whole trajectory
    two_phase_reference_quirk: bool = False
    # the reference's reverse-sampling quirk (D13): `a` is dropped and the
    # model re-encodes the current noisy sample at every step
    reverse_reference_quirk: bool = False

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {self.model!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.prior not in PRIORS:
            raise ValueError(f"prior must be one of {PRIORS}, got {self.prior!r}")
        if self.dataset not in DATASETS:
            raise ValueError(
                f"dataset must be one of {DATASETS}, got {self.dataset!r}"
            )
        from infodiffusion_tpu_torch.ops.quant import MODES as _TURBO_MODES

        if self.turbo not in ("", "off") + _TURBO_MODES:
            raise ValueError(
                f"turbo must be '', 'off' or one of {_TURBO_MODES}, "
                f"got {self.turbo!r}"
            )

    def with_dataset_config(self) -> "Config":
        """Apply the per-dataset override table."""
        ch, unets_ch, enc_ch, size = DATASET_CONFIG[self.dataset]
        return dataclasses.replace(
            self,
            input_channels=ch,
            unets_channels=unets_ch,
            encoder_channels=enc_ch,
            input_size=size,
        )

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Data shape in the reference's (C, H, W) convention."""
        return (self.input_channels, self.input_size, self.input_size)

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        """Shape handed to the latent DDIM."""
        return (1, self.a_dim, self.a_dim)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def generate_exp_string(cfg: Config) -> str:
    """The experiment name that checkpoints, logs, images and latents are
    filed under:
    ``{dataset}_{a_dim}d[_{kld}kld[_{C}C]][_{mmd}mmd][_{prior}][_bottleneck]``,
    floats formatted by ``str()`` as the reference's f-strings do."""
    root = f"{cfg.dataset}_{cfg.a_dim}d"
    if cfg.kld_weight != 0:
        root += f"_{cfg.kld_weight}kld"
        if cfg.use_C:
            root += f"_{cfg.C_max}C"
    if cfg.mmd_weight != 0:
        root += f"_{cfg.mmd_weight}mmd"
    if cfg.prior != "regular":
        root += f"_{cfg.prior}"
    if cfg.is_bottleneck:
        root += "_bottleneck"
    return root
