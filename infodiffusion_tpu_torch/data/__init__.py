"""Datasets and the host input pipeline
(JAX counterpart: ``infodiffusion_tpu/data``)."""

from infodiffusion_tpu_torch.data.datasets import (
    ArrayDataset,
    ImageFolderDataset,
    LatentDataset,
    get_dataset,
)
from infodiffusion_tpu_torch.data.loader import DataLoader

__all__ = [
    "ArrayDataset",
    "ImageFolderDataset",
    "LatentDataset",
    "get_dataset",
    "DataLoader",
]
