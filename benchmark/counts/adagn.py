"""Bytes of K1 (GroupNorm with its FiLMs) and its backward, from the shapes.

Each input is read once and each output written once, whatever the
kernel re-reads. Forward, per site: x read and y written (bf16), the f32
scale and bias, each FiLM's scale and shift rows [B, C] (bf16), and in
training the per-(image, group) mean and rstd (f32) written for the
backward. Backward: x, dy and the statistics read, the scale and each
FiLM's scale row read; dx (bf16), dscale and dbias (f32) and each FiLM's
two gradient rows written.

Sites: every ResBlock's norm1 (over its input, the skip concat in an up
block), norm2 (with the time FiLM, and the aux FiLM in InfoDiff's
backbone) and norm3 (the backbone's blocks), each attention block's norm,
and each skeleton's tail norm. The encoder's blocks have norm1 and norm2
only, with no FiLM.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.reference.model import GROUPS, skeleton_plan

ACT = 2    # bf16 activations and FiLM rows
PARAM = 4  # f32 scale and bias
STAT = 4   # f32 mean and rstd


def skeleton_sites(arch: dict, size: int, films: int,
                   encoder: bool) -> List[Tuple[int, int, int]]:
    """(channels, resolution, FiLMs) of each K1 site of one skeleton."""
    out = []
    for kind, _name, cin, cout, use_attn, lvl in skeleton_plan(
            arch["ch"], arch["ch_mult"], arch["num_res_blocks"],
            arch["attn"]):
        if kind in ("downsample", "upsample"):
            continue
        r = size >> lvl
        out.append((cin, r, 0))
        out.append((cout, r, 0 if encoder else films))
        if not encoder:
            out.append((cout, r, 0))
        if use_attn:
            out.append((cout, r, 0))
    out.append((arch["ch"], size, 0))
    return out


def sites(cfg: dict, train: bool) -> List[Tuple[int, int, int]]:
    """K1 sites of one image-model forward (with the encoder in training,
    where InfoDiff encodes the clean batch)."""
    info = cfg["model"] == "infodiff"
    s = skeleton_sites(cfg["arch"], cfg["input_size"], 2 if info else 1,
                       False)
    if info and train:
        s += skeleton_sites(cfg["arch"], cfg["input_size"], 0, True)
    return s


def forward_bytes(site, batch: int, train: bool) -> int:
    c, r, k = site
    b = 2 * batch * r * r * c * ACT + 2 * c * PARAM + k * 2 * batch * c * ACT
    if train:
        b += batch * GROUPS * 2 * STAT
    return b


def backward_bytes(site, batch: int) -> int:
    c, r, k = site
    return (3 * batch * r * r * c * ACT + batch * GROUPS * 2 * STAT
            + c * PARAM + k * batch * c * ACT + 2 * c * PARAM
            + k * 2 * batch * c * ACT)


def train_step_bytes(cfg: dict, batch: int) -> int:
    """K1 and K1-bwd bytes of one train step."""
    return sum(forward_bytes(s, batch, True) + backward_bytes(s, batch)
               for s in sites(cfg, True))


def forward_pass_bytes(cfg: dict, batch: int) -> int:
    """K1 bytes of one sampling forward (no statistics kept)."""
    return sum(forward_bytes(s, batch, False) for s in sites(cfg, False))
