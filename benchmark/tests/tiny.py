"""Tiny versions of the cells' files for CPU tests: the same files with
the sizes cut (ch 32, two levels, 16px, a_dim 32, T 50, DDIM-5, batch 4)
and float32, so that the port's plain versions run in seconds."""

from __future__ import annotations

import copy

from benchmark import harness as H


def tiny_files(cell: str, dtype: str = "float32") -> dict:
    files = copy.deepcopy(H.cell_files(cell))
    cfg, tr = files["config"], files["traffic"]
    cfg.update(input_size=16, a_dim=32, T=50, sampling_steps=5,
               dataset_images=64, dtype=dtype,
               arch=dict(cfg["arch"], ch=32, ch_mult=[1, 2], attn=[1]))
    cfg["encoder_channels"] = 32
    tr.update(batch_size=4)
    if tr["kind"] == "train":
        tr.update(ref_block=2, warmup_steps=1, log_every=2, profile_steps=1)
    else:
        tr.update(check_rows=3)
    return files


def patched_table(files: dict):
    """The port's dataset table with the tiny configuration's widths (the
    port takes CelebA's channels from it)."""
    from unittest import mock

    from infodiffusion_tpu_torch import config as C

    cfg = files["config"]
    ch = cfg["arch"]["ch"]
    return mock.patch.dict(C.DATASET_CONFIG, {cfg["dataset"]: (
        cfg["input_channels"], ch, ch, cfg["input_size"])})
