"""High-level inference facade (JAX counterpart: ``infodiffusion_tpu/pipelines.py``).

    from infodiffusion_tpu_torch.models.wrappers import build_model
    from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline

    model = build_model(cfg)                      # an InfoDiff, on the card
    pipe = InfoDiffusionPipeline(cfg, model)
    pipe = InfoDiffusionPipeline.from_checkpoint(cfg)  # or a trained one
    pipe = InfoDiffusionPipeline.from_torch_checkpoint(cfg, "model-50.pth")
    imgs = pipe.generate(16, a=latents, steps=100)
    a = pipe.encode(imgs)                         # semantic latents
    xT = pipe.invert(imgs)                        # reverse DDIM, x0 -> xT
    rec = pipe.reconstruct(imgs, steps=100)       # encode, invert, resample
    rows = pipe.traverse(imgs[:1], dim=3, steps=100)
    mix = pipe.interpolate(imgs[:2], n=10, steps=100)

Images are NHWC f32 on the model's device; outputs are clipped to [-1, 1].
``from_checkpoint`` loads ``model-{epoch}`` from the runner's checkpoint
directory (the port's own format, ``train/checkpoint.py``);
``from_torch_checkpoint`` a reference ``model-{epoch}.pth``
(``interop.load_torch_checkpoint``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from infodiffusion_tpu_torch.diffusion.samplers import DiffusionProcess
from infodiffusion_tpu_torch.utils import cos

ETAS = (-1.5, -1.2, -0.9, -0.6, -0.3, 0.0, 0.3, 0.6, 0.9, 1.2, 1.5)


class InfoDiffusionPipeline:
    """Sampling, encoding and latent manipulation over an InfoDiff model;
    random draws come from the pipeline's own generator (seeded with
    ``seed``) unless one is given."""

    def __init__(self, cfg, model: torch.nn.Module, seed: int = 0,
                 group=None):
        """``group``: a data process group to split ``generate``'s rows
        over (``DiffusionProcess``)."""
        self.cfg = cfg
        self.model = model
        self.process = DiffusionProcess(cfg, model, group=group)
        self.generator = torch.Generator(device=self.process.device)
        self.generator.manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, cfg, epoch: Optional[int] = None, device=None,
                        seed: int = 0) -> "InfoDiffusionPipeline":
        """The pipeline over the weights the runner saved for ``cfg`` at
        ``epoch`` (default ``cfg.epochs``, as the eval modes load), the EMA
        when it was saved; ``device`` as the runner resolves it (the card,
        or the CPU under ``INFODIFF_FORCE_CPU=1``)."""
        from infodiffusion_tpu_torch.models.wrappers import build_model
        from infodiffusion_tpu_torch.runner import resolve_device
        from infodiffusion_tpu_torch.train.checkpoint import (
            checkpoint_root,
            restore_params,
        )

        cfg = cfg.with_dataset_config()
        model = build_model(cfg, device=resolve_device(device))
        restore_params(checkpoint_root(cfg),
                       cfg.epochs if epoch is None else epoch, model)
        return cls(cfg, model.eval(), seed=seed)

    @classmethod
    def from_torch_checkpoint(cls, cfg, pth_path: str, device=None,
                              seed: int = 0) -> "InfoDiffusionPipeline":
        """The pipeline over a reference ``.pth`` (the reference's
        ``torch.save(model.state_dict())``), loaded as the reference's eval
        loads it (unused keys such as the dead ``crossattn.*`` ignored, a
        missing one raising); ``device`` as the runner resolves it."""
        from infodiffusion_tpu_torch.interop import load_torch_checkpoint
        from infodiffusion_tpu_torch.models.wrappers import build_model
        from infodiffusion_tpu_torch.runner import resolve_device

        cfg = cfg.with_dataset_config()
        model = build_model(cfg, device=resolve_device(device))
        load_torch_checkpoint(model, pth_path)
        return cls(cfg, model.eval(), seed=seed)

    def _sample(self, xT, a, steps, generator=None, n=16) -> torch.Tensor:
        out = self.process.sampling(
            generator if generator is not None else self.generator,
            sampling_number=n, xT=xT, a=a, num_steps=steps)
        return out.to(torch.float32).clamp(-1.0, 1.0)

    def generate(self, n: int = 16, a: Optional[torch.Tensor] = None,
                 steps: Optional[int] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """n images; ``steps`` selects DDIM-N (None: the full-grid
        sampler); ``a`` defaults to draws from N(0, I)."""
        return self._sample(None, a, steps, generator, n)

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Images -> semantic latents: mu when KLD is on, else the
        deterministic a (f32)."""
        a, _, mu, _ = self.model.encode(x, sample=False)
        return (mu if self.cfg.kld_weight != 0 else a).to(torch.float32)

    def invert(self, x: torch.Tensor,
               a: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic reverse-DDIM encoding x0 -> xT, conditioned on
        ``a`` (default: the encoder's latents of x)."""
        a = a if a is not None else self.encode(x)
        return self.process.reverse_sampling(x, a, generator=self.generator)

    def reconstruct(self, x: torch.Tensor,
                    steps: Optional[int] = None) -> torch.Tensor:
        """x -> (a, xT) -> x̂, the latent-quality round trip."""
        a = self.encode(x)
        return self._sample(self.invert(x, a), a, steps)

    def traverse(self, x: torch.Tensor, dim: int,
                 etas: Optional[Sequence[float]] = None,
                 steps: Optional[int] = None) -> torch.Tensor:
        """Latent traversal of one image along ``dim``: one sample per eta,
        the same xT, ``a[dim]`` set to eta."""
        etas = list(etas if etas is not None else ETAS)
        a = self.encode(x)
        xT = self.invert(x, a).repeat(len(etas), 1, 1, 1)
        a_batch = a.repeat(len(etas), 1)
        a_batch[:, dim] = torch.tensor(etas, dtype=a.dtype, device=a.device)
        return self._sample(xT, a_batch, steps)

    def interpolate(self, x_pair: torch.Tensor, n: int = 10,
                    steps: Optional[int] = None) -> torch.Tensor:
        """Slerp between two images' xT and a cos/sin blend of their
        latents, ``n`` samples."""
        if x_pair.shape[0] != 2:
            raise ValueError(f"interpolate takes 2 images, got "
                             f"{x_pair.shape[0]}")
        a = self.encode(x_pair)
        xT = self.invert(x_pair, a)
        theta = torch.arccos(cos(xT[0], xT[1]))
        etas = torch.linspace(0.0, 1.0, n, device=xT.device)
        intp_x = torch.stack([
            (torch.sin((1 - e) * theta) * xT[0] + torch.sin(e * theta) * xT[1])
            / torch.sin(theta) for e in etas])
        intp_a = torch.stack([
            torch.cos(e * math.pi / 2) * a[0] + torch.sin(e * math.pi / 2) * a[1]
            for e in etas])
        return self._sample(intp_x, intp_a, steps)
