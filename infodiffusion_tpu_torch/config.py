"""Experiment configuration for the port's generation and training slices
(JAX counterpart: ``infodiffusion_tpu/config.py``).

The fields the ported slices read, with the JAX ``Config``'s names and
defaults (the reference CLI flags), and the same per-dataset override
table. The port imports nothing of the JAX package, so this is its own
dataclass; ``tests/test_torch_ops.py`` holds its fields, defaults and
table against the JAX one. The remaining fields come with the slices that
read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

MODELS = ("diff", "vae", "vanilla")
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
    model: str = "diff"  # {diff, vae, vanilla}
    prior: str = "regular"  # {regular, 10mix, roll}
    kld_weight: float = 0.0
    mmd_weight: float = 0.1
    use_C: bool = False
    C_max: float = 25.0
    dataset: str = "mnist"
    epochs: int = 20
    batch_size: int = 64
    learning_rate: float = 1e-4
    deterministic: bool = False
    input_channels: int = 1
    unets_channels: int = 64
    encoder_channels: int = 64
    input_size: int = 32
    a_dim: int = 32
    beta1: float = 1e-5
    betaT: float = 1e-2
    diffusion_steps: int = 1000
    # sampler steps; None => the full T grid
    sampling_steps: Optional[int] = None
    # bf16 activations in the backbone (schedule math stays f32)
    bf16: bool = False
    # EMA of the parameters (0 = off)
    ema_decay: float = 0.0

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {self.model!r}")
        if self.prior not in PRIORS:
            raise ValueError(f"prior must be one of {PRIORS}, got {self.prior!r}")
        if self.dataset not in DATASETS:
            raise ValueError(
                f"dataset must be one of {DATASETS}, got {self.dataset!r}"
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
