"""Generate a grid of samples from a trained checkpoint through the
library API (no CLI mode involved; JAX counterpart:
``examples/generate.py``).

    python -m infodiffusion_tpu_torch.examples.generate --model diff \\
        --mode eval --prior regular --dataset celeba --a_dim 256 \\
        --epochs 50 --mmd_weight 0.1 --deterministic --sampling_steps 100 \\
        --sampling_number 64

The flags are run.py's; the checkpoint is found as ``--mode eval`` finds
it (``model-{epochs}`` under ``--model_folder``), and the run goes to the
card unless ``INFODIFF_FORCE_CPU=1``. Writes ``generated.png`` to the
working directory: ``InfoDiffusionPipeline.generate`` at the pipeline's
default seed, ``a`` drawn from N(0, I).
"""

from __future__ import annotations

import sys

from infodiffusion_tpu_torch.cli import parse_args
from infodiffusion_tpu_torch.imaging import save_image
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline


def main(argv=None):
    """Returns the samples, [n, H, W, C] f32 in [-1, 1] on the host."""
    cfg = parse_args(argv)
    pipe = InfoDiffusionPipeline.from_checkpoint(cfg)
    imgs = pipe.generate(cfg.sampling_number,
                         steps=cfg.sampling_steps).cpu().numpy()
    save_image(imgs, "generated.png", normalize=True,
               value_range=(-1.0, 1.0))
    print(f"wrote generated.png ({imgs.shape[0]} samples)")
    return imgs


if __name__ == "__main__":
    main(sys.argv[1:])
