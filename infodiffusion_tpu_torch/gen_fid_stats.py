"""FID stats generation (JAX counterpart: the root ``gen_fid_stats.py``;
reference: gen_fid_stats.py, clean-fid's ``make_custom_stats`` over the
``save_original_img`` dump).

    python -m infodiffusion_tpu_torch.gen_fid_stats <name> <folder>

Writes ``$INFODIFF_FID_STATS_DIR/<name>_<extractor tag>.npz`` (default
``./fid_stats``). The features are computed on the card, or on the CPU
only under ``INFODIFF_FORCE_CPU=1``; with neither it raises.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> str:
    from infodiffusion_tpu_torch.metrics.fid import make_custom_stats
    from infodiffusion_tpu_torch.runner import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    custom_name, dataset_path = argv[0], argv[1]
    device = resolve_device()
    print(f"Generating fid stats for dataset {custom_name} located at "
          f"{dataset_path}")
    path = make_custom_stats(custom_name, dataset_path, device=device)
    print(f"Saved stats to {path}")
    return path


if __name__ == "__main__":
    main()
