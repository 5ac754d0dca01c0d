"""Weight initializers of the reference's scheme
(JAX counterpart: ``infodiffusion_tpu/nn/initializers.py``).

Xavier-uniform with zero bias everywhere (``nn.layers.xavier_``, gain 1e-5
on the UNet tails), with the exceptions below. Parity with the JAX package
is in distribution only: tests carry weights across with
``interop.from_jax_params``. Each function fills a torch ``weight`` [O, I]
(fan_in = I) in place and returns it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the std of a unit normal truncated at +-2 (JAX's variance_scaling
# correction for its truncated normal)
_TRUNC_STD = 0.87962566103423978


def kaiming_normal_relu_(w: torch.Tensor) -> torch.Tensor:
    """torch ``kaiming_normal_(a=0, nonlinearity='relu')``: untruncated
    normal, std sqrt(2 / fan_in). The bottleneck UNet's ``fc_a`` and the
    latent MLP's activated layers."""
    return nn.init.kaiming_normal_(w, a=0.0, nonlinearity="relu")


def lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Flax ``lecun_normal``: a normal truncated at two stds, scaled to
    variance 1 / fan_in. The Decoder's ``fc_a``, the latent MLP's last
    layer and every ``FeatureClassifier`` layer."""
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
