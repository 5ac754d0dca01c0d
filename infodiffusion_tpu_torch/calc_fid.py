"""FID / KID of a folder against named stats (JAX counterpart: the root
``calc_fid.py``; reference: calc_fid.py, clean-fid's ``compute_fid`` /
``compute_kid`` with dataset_res=64, num_gen=10000).

    python -m infodiffusion_tpu_torch.calc_fid <dataset_name> <folder>

The stats come from ``gen_fid_stats``. The features are computed on the
card, or on the CPU only under ``INFODIFF_FORCE_CPU=1``; with neither it
raises.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple


def main(argv: Optional[Sequence[str]] = None) -> Tuple[float, float]:
    from infodiffusion_tpu_torch.metrics.fid import compute_fid, compute_kid
    from infodiffusion_tpu_torch.runner import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    dataset_name, folder_1 = argv[0], argv[1]
    kwargs = dict(dataset_name=dataset_name, dataset_res=64, num_gen=10000,
                  device=resolve_device())
    fid_score = compute_fid(folder_1, **kwargs)
    print(f"fid: score: {fid_score}")
    kid_score = compute_kid(folder_1, **kwargs)
    print(f"kid: score: {kid_score}")
    return fid_score, kid_score


if __name__ == "__main__":
    main()
