"""The port's InceptionV3 (``infodiffusion_tpu_torch/metrics/inception.py``)
against the JAX package's, on the CPU:

- ``fold_state_dict`` equals JAX's after HWIO -> OIHW, exactly; the schema,
  the verifier and ``default_weights_path`` behave the same;
- ``forward`` at 95px (every block runs, the last grid is 1x1), B=2, on a
  schema-exact random checkpoint: max abs error <= 5e-4 x max |feature|,
  and never looser than the 2e-3 that tests/test_inception.py holds;
- ``clean_resize`` (two products with PIL's bicubic coefficients) against
  JAX's, which resizes through PIL: within 2e-6 at an upscale, a
  downscale, odd sizes and a non-square grid;
- the extractor keeps its convs in f32 whatever TF32 flags the caller set.
"""

import numpy as np
import pytest
import torch

from infodiffusion_tpu.metrics import inception as jinc
from infodiffusion_tpu_torch.metrics import inception as pinc

FEATURE_REL_TOL = 5e-4
FEATURE_ABS_CAP = 2e-3
RESIZE_TOL = 2e-6


def test_random_state_dict_is_the_test_recipe():
    """The port's fixture checkpoint is tests/test_inception.py's recipe,
    tensor for tensor, and passes the schema check."""
    from test_inception import make_state_dict

    got, want = pinc.random_state_dict(4), make_state_dict(seed=4)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert pinc.verify_state_dict_schema(got) == (True, [])


def test_fold_state_dict_matches_jax():
    sd = {k: v.numpy() for k, v in pinc.random_state_dict(1).items()}
    got, want = pinc.fold_state_dict(sd), jinc.fold_state_dict(sd)
    assert got.keys() == want.keys()
    for name, (w, b) in want.items():
        np.testing.assert_array_equal(got[name][0], w.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[name][1], b)
        assert got[name][0].dtype == got[name][1].dtype == np.float32


def test_schema_and_verifier_match_jax():
    assert pinc.conv_specs() == jinc.conv_specs()
    assert pinc.expected_state_dict_schema() == \
        jinc.expected_state_dict_schema()
    for const in ("EPS", "FEATURE_DIM", "INPUT_SIZE",
                  "CANONICAL_WEIGHTS_FILENAME", "CANONICAL_SHA256_PREFIX",
                  "CANONICAL_EXTRA_KEYS"):
        assert getattr(pinc, const) == getattr(jinc, const), const
    sd = {k: v.numpy() for k, v in pinc.random_state_dict(0).items()}
    del sd["Mixed_6b.branch1x1.conv.weight"]
    sd["Mixed_7c.branch_pool.bn.bias"] = np.zeros(3, np.float32)
    sd["fc.weight"] = np.zeros((1008, 2048), np.float32)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = np.zeros((), np.int64)
    sd["aux_logits.fc.weight"] = np.zeros((2, 2), np.float32)
    got = pinc.verify_state_dict_schema(sd)
    assert got == jinc.verify_state_dict_schema(sd)
    assert got[0] is False and len(got[1]) == 3


@pytest.mark.parametrize("case", ["env_missing", "env_file", "hub", "none"])
def test_default_weights_path_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("INFODIFF_INCEPTION_WEIGHTS", raising=False)
    if case == "env_missing":
        monkeypatch.setenv("INFODIFF_INCEPTION_WEIGHTS",
                           str(tmp_path / "nope.pth"))
        for mod in (pinc, jinc):
            with pytest.warns(UserWarning, match="nonexistent"):
                assert mod.default_weights_path() is None
        return
    want = None
    if case == "env_file":
        want = str(tmp_path / "w.pth")
        open(want, "wb").close()
        monkeypatch.setenv("INFODIFF_INCEPTION_WEIGHTS", want)
    elif case == "hub":
        hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
        hub.mkdir(parents=True)
        for name in ("other.pth", "pt_inception-2015-12-05-6726825d.pth"):
            (hub / name).write_bytes(b"")
        want = str(hub / "pt_inception-2015-12-05-6726825d.pth")
    assert pinc.default_weights_path() == jinc.default_weights_path() == want


def test_forward_matches_jax():
    sd = pinc.random_state_dict(3)
    x = np.random.RandomState(7).rand(2, 95, 95, 3).astype(np.float32)
    want = np.asarray(jinc.forward(
        jinc.fold_state_dict({k: v.numpy() for k, v in sd.items()}), x))
    params = {k: (torch.from_numpy(w), torch.from_numpy(b)) for k, (w, b)
              in pinc.fold_state_dict(
                  {k: v.numpy() for k, v in sd.items()}).items()}
    with torch.no_grad():
        got = pinc.forward(params, torch.from_numpy(
            x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, pinc.FEATURE_DIM) and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= min(FEATURE_REL_TOL * np.abs(want).max(),
                      FEATURE_ABS_CAP), err


@pytest.mark.parametrize("h,w,size", [(64, 64, 299), (37, 37, 299),
                                      (299, 299, 37), (266, 530, 299),
                                      (530, 266, 299)])
def test_clean_resize_matches_pil(h, w, size):
    batch = np.random.RandomState(h + w).randint(
        0, 256, (2, h, w, 3)).astype(np.uint8)
    # sharp edges: bicubic overshoots past [0, 1], which stays unclipped
    batch[:, : h // 2] = 0
    batch[:, h // 2:, : w // 3] = 255
    want = jinc.clean_resize(batch, size)
    got = pinc.clean_resize(torch.from_numpy(batch), size)
    assert got.shape == (2, 3, size, size) and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL
    assert got.min() < 0.0 or got.max() > 1.0 or size < h


def test_resize_matrix_rows_sum_to_one():
    for n_in, n_out in ((64, 299), (299, 37), (7, 3)):
        m = pinc.resize_matrix(n_in, n_out)
        assert m.shape == (n_out, n_in)
        np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-12)


def test_extractor_matches_jax_and_pins_f32(tmp_path, monkeypatch):
    """get_extractor('inception') finds the checkpoint, keeps the JAX tag,
    and its features equal the JAX extractor's on the same uint8 batch;
    inside, TF32 is off for cuDNN and cuBLAS, and the caller's flags come
    back after."""
    from infodiffusion_tpu.metrics import fid as jfid
    from infodiffusion_tpu_torch.metrics import fid as pfid

    ckpt = tmp_path / "pt_inception-fixture.pth"
    torch.save(pinc.random_state_dict(5), ckpt)
    monkeypatch.setenv("INFODIFF_INCEPTION_WEIGHTS", str(ckpt))
    jinc._cached_extractor.cache_clear()
    pinc._cached_extractor.cache_clear()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    seen = []
    forward = pinc.forward

    def spy(params, x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(params, x)

    monkeypatch.setattr(pinc, "forward", spy)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        extract, tag = pfid.get_extractor("inception", device="cpu")
        jextract, jtag = jfid.get_extractor("inception")
        batch = np.random.RandomState(0).randint(
            0, 256, (3, 64, 64, 3)).astype(np.uint8)
        got, want = extract(batch), jextract(batch)
        assert seen == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32 = flags[0]
        torch.backends.cuda.matmul.allow_tf32 = flags[1]
        jinc._cached_extractor.cache_clear()
        pinc._cached_extractor.cache_clear()
    assert tag == jtag == "inception-jax"
    assert got.shape == (3, pinc.FEATURE_DIM) and got.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= min(FEATURE_REL_TOL * np.abs(want).max(),
                      FEATURE_ABS_CAP), err
