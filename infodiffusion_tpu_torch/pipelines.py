"""High-level generation facade (JAX counterpart: ``infodiffusion_tpu/pipelines.py``).

    from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline

    pipe = InfoDiffusionPipeline(cfg, model)      # a port InfoDiff on its device
    imgs = pipe.generate(16, a=latents, steps=100)

Only ``generate`` is ported; encoding, inversion and traversal come with
a later slice (the Encoder itself is ``models.unet.Encoder``).
"""

from __future__ import annotations

from typing import Optional

import torch

from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess


class InfoDiffusionPipeline:
    """Sampling over an InfoDiff model."""

    def __init__(self, cfg, model: torch.nn.Module, seed: int = 0):
        self.cfg = cfg
        self.model = model
        self.process = DiffusionProcess(cfg, model)
        self.generator = torch.Generator(device=self.process.device)
        self.generator.manual_seed(seed)

    def generate(self, n: int = 16, a: Optional[torch.Tensor] = None,
                 steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n NHWC images in [-1, 1] (f32, on the model's device); ``steps``
        selects DDIM-N (None: the full-grid sampler); ``a`` defaults to
        draws from N(0, I)."""
        out = self.process.sampling(
            generator if generator is not None else self.generator,
            sampling_number=n, a=a, num_steps=steps,
        )
        return out.to(torch.float32).clamp(-1.0, 1.0)
