"""FID / KID (``fid``, ``inception``) and the disentanglement metrics
(JAX counterpart: ``infodiffusion_tpu/metrics``)."""

from infodiffusion_tpu_torch.metrics.disentanglement import (
    PredMetric,
    TADMetric,
    auroc,
    compute_dci,
    completeness,
    disentanglement,
)

__all__ = [
    "compute_dci",
    "disentanglement",
    "completeness",
    "PredMetric",
    "TADMetric",
    "auroc",
]
