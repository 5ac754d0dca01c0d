"""The torch port's blocks and image backbone held against the JAX package:
the same numpy inputs, the JAX params moved across by ``from_jax_params``
under ``load_state_dict(strict=True)``. Tolerance: FORWARD_TOL
(tests/torch_parity.py)."""

import jax
import numpy as np
import pytest
import torch

from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.nn.attention import AttnBlock as JAttnBlock
from infodiffusion_tpu.nn.blocks import AuxResBlock as JAuxResBlock
from infodiffusion_tpu_torch.models.wrappers import InfoDiff, pick_ch_mult
from infodiffusion_tpu_torch.nn.attention import AttnBlock
from infodiffusion_tpu_torch.nn.blocks import AuxResBlock
from torch_parity import (
    FORWARD_TOL,
    assert_close,
    init_variables,
    port,
    randomize,
    tensor,
)

torch.set_num_threads(2)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW channels_last layout."""
    return tensor(x).permute(0, 3, 1, 2)


def test_attn_block():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 4, 64).astype(np.float32)
    jm = JAttnBlock()
    params = randomize(init_variables(jm, x)["params"], seed=2)
    want = jm.apply({"params": params}, x)
    got = port(AttnBlock(64), params)(_nchw(x)).permute(0, 2, 3, 1)
    assert_close(got, want, FORWARD_TOL, "AttnBlock")


@pytest.mark.parametrize("in_ch,attn", [(32, False), (64, True)])
def test_aux_res_block(in_ch, attn):
    rng = np.random.RandomState(in_ch)
    x = rng.randn(2, 8, 8, in_ch).astype(np.float32)
    temb, aemb = (rng.randn(2, 16).astype(np.float32) for _ in range(2))
    jm = JAuxResBlock(out_ch=64, attn=attn)
    params = randomize(init_variables(jm, x, temb, aemb)["params"], seed=3)
    want = jm.apply({"params": params}, x, temb, aemb)
    pm = port(AuxResBlock(in_ch, 64, 16, attn), params)
    got = pm(_nchw(x), tensor(temb), tensor(aemb)).permute(0, 2, 3, 1)
    assert_close(got, want, FORWARD_TOL, "AuxResBlock")


def test_infodiff_forward():
    """The whole AuxiliaryUNet (two levels, attention at level 1, the skip
    concats and the shortcuts) at 16x16 through InfoDiff.__call__."""
    kw = dict(T=50, a_dim=32, shape=(3, 16, 16), unets_channels=32,
              ch_mult=(1, 2), attn=(1,), num_res_blocks=1)
    jm = JInfoDiff(encoder_channels=32, **kw)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    t = np.array([3, 40], np.int32)
    a = rng.randn(2, 32).astype(np.float32)
    params = randomize(init_variables(jm, x, t, a)["params"], seed=4)
    want = jax.jit(jm.apply)({"params": params}, x, t, a)
    # a tree from init(x, t, a) holds only the backbone: load it there
    pm = InfoDiff(**kw).eval()
    port(pm.backbone, params["backbone"])
    got = pm(tensor(x), tensor(t).long(), tensor(a))
    assert_close(got, want, FORWARD_TOL, "InfoDiff")


def test_pick_ch_mult():
    from infodiffusion_tpu.models.wrappers import pick_ch_mult as j_pick

    for model in ("diff", "vae"):
        for size in (28, 32, 64):
            assert pick_ch_mult(model, size) == j_pick(model, size)
