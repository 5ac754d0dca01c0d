"""The system under test, built from a configuration file: the port's
``Config``, its models on the card with weights made from the seed, and
the seeded inputs that both the port and the reference read.

Weights: one normal draw on the device for all leaves of a model (a
``torch.Generator`` on the card, seeded from the run's seed), each leaf
scaled as its kind wants: a kernel or Dense weight by 1/sqrt(fan_in), a
normalisation's scale 1 + 0.1 n, a bias 0.1 n. Float32 leaves, as the
port keeps them under ``bf16`` (the products run in bf16).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose of the run (weights, data, batch n)."""
    state = np.random.SeedSequence(
        [seed % (1 << 64), *path]).generate_state(
        1, dtype=np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


WEIGHTS, LATENT_WEIGHTS, DATA, BATCH, WARMUP, CHECK = 1, 2, 3, 4, 5, 6


def port_config(cfg: dict, batch_size: int, r_seed: int, turbo: str = "off"):
    """The port's ``Config`` for a configuration file."""
    from infodiffusion_tpu_torch.config import Config

    c = Config(
        model="diff" if cfg["model"] == "infodiff" else "vanilla",
        dataset=cfg["dataset"], a_dim=cfg["a_dim"],
        mmd_weight=cfg.get("mmd_weight", 0.0), kld_weight=0.0,
        prior=cfg.get("prior", "regular"), diffusion_steps=cfg["T"],
        beta1=cfg["beta1"], betaT=cfg["betaT"], batch_size=batch_size,
        learning_rate=cfg["learning_rate"], epochs=cfg["epochs"],
        bf16=cfg["dtype"] == "bfloat16", sampling_steps=cfg["sampling_steps"],
        deterministic=cfg["deterministic"], r_seed=r_seed,
        ch_mult=",".join(str(m) for m in cfg["arch"]["ch_mult"]),
        attn=",".join(str(a) for a in cfg["arch"]["attn"]), turbo=turbo,
    ).with_dataset_config()
    for key, want in (("unets_channels", cfg["arch"]["ch"]),
                      ("input_size", cfg["input_size"]),
                      ("input_channels", cfg["input_channels"])):
        if getattr(c, key) != want:
            raise ValueError(f"the port's {key} is {getattr(c, key)}, the "
                             f"configuration says {want}")
    return c


def leaf_shapes(model: torch.nn.Module) -> List[Tuple[str, tuple]]:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def make_weights(shapes: List[Tuple[str, tuple]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 weights by name from one draw on ``device``."""
    total = sum(math.prod(s) for _, s in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, o = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        w = z[o:o + n].view(shape)
        o += n
        if len(shape) >= 2:
            w = w * (1.0 / math.sqrt(n // shape[0]))
        elif name.endswith(".weight"):
            w = 1.0 + 0.1 * w
        else:
            w = 0.1 * w
        out[name] = w
    return out


def build(cfg, device, latent: bool = False):
    """The port's model for ``cfg`` on ``device`` (constructed there)."""
    from infodiffusion_tpu_torch.models.wrappers import build_model

    with torch.device(device):
        return build_model(cfg, latent=latent, device=device)


@torch.no_grad()
def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("weights and model leaves differ")
    for n, p in params.items():
        p.copy_(weights[n])


def images(n: int, size: int, channels: int, seed: int, device) -> np.ndarray:
    """``n`` uint8 images [n, size, size, channels], drawn on the device and
    brought to the host in one copy."""
    g = torch.Generator(device=device).manual_seed(seed)
    u8 = torch.randint(0, 256, (n, size, size, channels), generator=g,
                       device=device, dtype=torch.uint8)
    return u8.cpu().numpy()
