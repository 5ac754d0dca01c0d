"""Latent traversal of a real image through the library API: encode it,
invert it to xT, then sweep one latent dimension and sample each variant
(the ``disentangle`` mode, programmatically; JAX counterpart:
``examples/traverse.py``).

    python -m infodiffusion_tpu_torch.examples.traverse --model diff \\
        --mode eval --prior regular --dataset celeba --a_dim 256 \\
        --epochs 50 --mmd_weight 0.1 --deterministic --img_id 0

The flags are run.py's (the dataset is read as the CLI reads it, the
``--img_id``-th image of the unshuffled, unflipped set). Writes one row
``traverse-dim{k}.png`` for each of the first ``n_dims`` (4) latent
dimensions to the working directory.
"""

from __future__ import annotations

import sys

from infodiffusion_tpu_torch.cli import parse_args
from infodiffusion_tpu_torch.data import DataLoader, get_dataset
from infodiffusion_tpu_torch.imaging import save_image
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from infodiffusion_tpu_torch.runner import resolve_device


def main(argv=None, n_dims: int = 4):
    """Returns the rows, one [11, H, W, C] array a dimension."""
    # the dataset table (channels, size) before the dataset is built
    cfg = parse_args(argv).with_dataset_config()
    device = resolve_device()
    pipe = InfoDiffusionPipeline.from_checkpoint(cfg, device=device)
    loader = iter(DataLoader(get_dataset(cfg), 1, device=device))
    for _ in range(cfg.img_id):  # --img_id, as the disentangle mode
        next(loader)
    x = next(loader)
    rows = []
    for k in range(min(n_dims, cfg.a_dim)):
        row = pipe.traverse(x, dim=k).cpu().numpy()
        save_image(row, f"traverse-dim{k}.png", nrow=row.shape[0],
                   normalize=True, value_range=(-1.0, 1.0))
        print(f"wrote traverse-dim{k}.png")
        rows.append(row)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
