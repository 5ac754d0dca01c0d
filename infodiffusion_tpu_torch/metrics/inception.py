"""InceptionV3 FID feature extractor in PyTorch
(JAX counterpart: ``infodiffusion_tpu/metrics/inception.py``).

The network behind every published FID number: the TF-Inception port used
by pytorch-fid / clean-fid (``pt_inception-2015-12-05``), torchvision's
InceptionV3 with the FID modifications (average pools with
``count_include_pad=False`` in the A/C/E blocks, a max pool in the pool
branch of Mixed_7c). Weights are a local ``state_dict`` checkpoint
(``INFODIFF_INCEPTION_WEIGHTS=/path/to/pt_inception-2015-12-05-6726825d.pth``
or the torch-hub cache); nothing is downloaded. Every ``BasicConv2d``
(conv without bias, eval BatchNorm with eps 1e-3, ReLU) is folded at load
time into one biased conv, kept OIHW for ``F.conv2d``.

The extractor runs on the run's device: one host-to-device copy of the
uint8 batch, clean-fid's "clean" resize as two products with fixed
coefficient matrices (PIL's float bicubic, :func:`resize_matrix`), the
forward in full f32 (TF32 off for its duration, whatever the caller set),
one copy of the [B, 2048] features back. The convs and pools are cuDNN's:
the JAX package runs this network through XLA's convolutions, with no
Pallas kernel, so the port has no hand kernel here.
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-3  # BasicConv2d BatchNorm eps
FEATURE_DIM = 2048
INPUT_SIZE = 299

# ---------------------------------------------------------------------------
# conv spec table: state_dict prefix -> (in_ch, out_ch, (kh, kw), stride,
# (pad_h, pad_w)). Order matters only for readability; lookups are by name.
# ---------------------------------------------------------------------------


def _inception_a(prefix: str, in_ch: int, pool_f: int):
    return [
        (f"{prefix}.branch1x1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch5x5_1", in_ch, 48, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch_pool", in_ch, pool_f, (1, 1), 1, (0, 0)),
    ]


def _inception_b(prefix: str, in_ch: int):
    return [
        (f"{prefix}.branch3x3", in_ch, 384, (3, 3), 2, (0, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 64, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0)),
    ]


def _inception_c(prefix: str, in_ch: int, c7: int):
    return [
        (f"{prefix}.branch1x1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_1", in_ch, c7, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


def _inception_d(prefix: str, in_ch: int):
    return [
        (f"{prefix}.branch3x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
        (f"{prefix}.branch7x7x3_1", in_ch, 192, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
        (f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
        (f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0)),
    ]


def _inception_e(prefix: str, in_ch: int):
    return [
        (f"{prefix}.branch1x1", in_ch, 320, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_1", in_ch, 384, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{prefix}.branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{prefix}.branch3x3dbl_1", in_ch, 448, (1, 1), 1, (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
        (f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
        (f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
        (f"{prefix}.branch_pool", in_ch, 192, (1, 1), 1, (0, 0)),
    ]


def conv_specs() -> List[Tuple[str, int, int, Tuple[int, int], int, Tuple[int, int]]]:
    """All BasicConv2d units as (name, in, out, kernel, stride, pad)."""
    specs = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    ]
    specs += _inception_a("Mixed_5b", 192, 32)
    specs += _inception_a("Mixed_5c", 256, 64)
    specs += _inception_a("Mixed_5d", 288, 64)
    specs += _inception_b("Mixed_6a", 288)
    specs += _inception_c("Mixed_6b", 768, 128)
    specs += _inception_c("Mixed_6c", 768, 160)
    specs += _inception_c("Mixed_6d", 768, 160)
    specs += _inception_c("Mixed_6e", 768, 192)
    specs += _inception_d("Mixed_7a", 768)
    specs += _inception_e("Mixed_7b", 1280)
    specs += _inception_e("Mixed_7c", 2048)
    return specs


# ---------------------------------------------------------------------------
# weight loading / BN folding
# ---------------------------------------------------------------------------


def fold_state_dict(state_dict) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """torch state_dict -> {conv name: (w OIHW f32, b f32)} with BN folded,
    the JAX package's arithmetic (which then transposes to HWIO)."""
    params: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for name, _in, _out, _k, _s, _p in conv_specs():
        w = np.asarray(state_dict[f"{name}.conv.weight"], np.float32)
        gamma = np.asarray(state_dict[f"{name}.bn.weight"], np.float32)
        beta = np.asarray(state_dict[f"{name}.bn.bias"], np.float32)
        mean = np.asarray(state_dict[f"{name}.bn.running_mean"], np.float32)
        var = np.asarray(state_dict[f"{name}.bn.running_var"], np.float32)
        scale = gamma / np.sqrt(var + EPS)
        params[name] = (w * scale[:, None, None, None], beta - mean * scale)
    return params


def default_weights_path() -> Optional[str]:
    """Locate a pt_inception checkpoint: env var, then torch-hub cache."""
    env = os.environ.get("INFODIFF_INCEPTION_WEIGHTS")
    if env:
        if os.path.exists(env):
            return env
        # a set-but-bad path must not silently degrade to the fallback
        # extractor ("set INFODIFF_INCEPTION_WEIGHTS" advice would then
        # gaslight a user who already set it)
        import warnings

        warnings.warn(
            f"INFODIFF_INCEPTION_WEIGHTS points at a nonexistent path: "
            f"{env!r} — ignoring it"
        )
        return None
    hub = os.path.join(
        os.path.expanduser("~"), ".cache", "torch", "hub", "checkpoints"
    )
    if os.path.isdir(hub):
        for f in sorted(os.listdir(hub)):
            if f.startswith("pt_inception") and f.endswith(".pth"):
                return os.path.join(hub, f)
    return None


def load_params(path: str, device=None) -> Dict[str, Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """The folded convs of the checkpoint at ``path``, moved to ``device``
    once."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    sd = {k: v.numpy() for k, v in obj.items() if hasattr(v, "numpy")}
    return {name: (torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
            for name, (w, b) in fold_state_dict(sd).items()}


# ---------------------------------------------------------------------------
# drop-in weights contract (offline verification, as the JAX package's
# tools/verify_inception_weights.py checks a candidate file)
# ---------------------------------------------------------------------------

#: the canonical pytorch-fid checkpoint this extractor is built for
#: (distributed from the pytorch-fid GitHub release "fid_weights";
#: clean-fid and the reference's calc_fid.py score through the same
#: TF-Inception port).
CANONICAL_WEIGHTS_FILENAME = "pt_inception-2015-12-05-6726825d.pth"

#: torch.hub filename convention: the trailing hex group is the first 8
#: hex digits of the file's SHA-256. The full digest is not recorded
#: anywhere offline-accessible, so the prefix is the strongest offline
#: identity check available; a candidate whose digest does not start
#: with this is NOT the canonical release file (it may still be
#: schema-valid, e.g. a re-saved copy — the verifier reports both).
CANONICAL_SHA256_PREFIX = "6726825d"


def expected_state_dict_schema() -> Dict[str, Tuple[int, ...]]:
    """Every tensor the loader consumes, name -> exact shape.

    Derived from :func:`conv_specs`: per BasicConv2d, a bias-free OIHW
    conv weight plus the four eval-mode BatchNorm vectors. The canonical
    file also carries ``fc.weight``/``fc.bias`` (the 1008-way TF logits
    head) and per-BN ``num_batches_tracked`` scalars; those are ignored
    by :func:`fold_state_dict` and deliberately NOT required here."""
    schema: Dict[str, Tuple[int, ...]] = {}
    for name, cin, cout, (kh, kw), _s, _p in conv_specs():
        schema[f"{name}.conv.weight"] = (cout, cin, kh, kw)
        for part in ("weight", "bias", "running_mean", "running_var"):
            schema[f"{name}.bn.{part}"] = (cout,)
    return schema

#: known-in-canonical-file extras the verifier should not flag as alien
CANONICAL_EXTRA_KEYS = ("fc.weight", "fc.bias")


def verify_state_dict_schema(sd) -> Tuple[bool, List[str]]:
    """Validate a mapping of name -> array-like against the schema.

    Returns ``(ok, problems)``: ok means every required tensor exists
    with the exact expected shape. Unknown keys (beyond the canonical
    fc head and BN bookkeeping scalars) are reported as notes but do
    not fail verification — the loader ignores them."""
    problems: List[str] = []
    schema = expected_state_dict_schema()
    for key, want in schema.items():
        if key not in sd:
            problems.append(f"missing tensor: {key} (want shape {want})")
            continue
        got = tuple(np.asarray(sd[key]).shape)
        if got != want:
            problems.append(f"shape mismatch: {key} has {got}, want {want}")
    ok = not problems
    for key in sd:
        if key in schema or key in CANONICAL_EXTRA_KEYS:
            continue
        if key.endswith(".bn.num_batches_tracked"):
            continue
        problems.append(f"note: unrecognized key ignored by loader: {key}")
    return ok, problems



def random_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A schema-exact checkpoint of random weights from a numpy seed (He
    scaled convs, BatchNorm scales and variances in [0.7, 1.3], small
    biases and means): the fixture that stands in for the real weights,
    which neither test machine has."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, cin, cout, (kh, kw), _s, _p in conv_specs():
        scale = np.sqrt(2.0 / (kh * kw * cin))
        sd[f"{name}.conv.weight"] = torch.tensor(
            (rng.randn(cout, cin, kh, kw) * scale).astype(np.float32))
        sd[f"{name}.bn.weight"] = torch.tensor(
            rng.uniform(0.7, 1.3, cout).astype(np.float32))
        sd[f"{name}.bn.bias"] = torch.tensor(
            rng.randn(cout).astype(np.float32) * 0.05)
        sd[f"{name}.bn.running_mean"] = torch.tensor(
            rng.randn(cout).astype(np.float32) * 0.05)
        sd[f"{name}.bn.running_var"] = torch.tensor(
            rng.uniform(0.7, 1.3, cout).astype(np.float32))
    return sd


# ---------------------------------------------------------------------------
# forward (NCHW, f32)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _conv_geometry() -> Dict[str, Tuple[int, Tuple[int, int]]]:
    return {name: (s, p) for name, _i, _o, _k, s, p in conv_specs()}


def _conv(x, p, name):
    w, b = p[name]
    stride, pad = _conv_geometry()[name]
    return F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _block_a(x, p, prefix):
    b1 = _conv(x, p, f"{prefix}.branch1x1")
    b5 = _conv(_conv(x, p, f"{prefix}.branch5x5_1"), p, f"{prefix}.branch5x5_2")
    b3 = _conv(x, p, f"{prefix}.branch3x3dbl_1")
    b3 = _conv(b3, p, f"{prefix}.branch3x3dbl_2")
    b3 = _conv(b3, p, f"{prefix}.branch3x3dbl_3")
    bp = _conv(_avg_pool(x), p, f"{prefix}.branch_pool")
    return torch.cat([b1, b5, b3, bp], 1)


def _block_b(x, p, prefix):
    b3 = _conv(x, p, f"{prefix}.branch3x3")
    bd = _conv(x, p, f"{prefix}.branch3x3dbl_1")
    bd = _conv(bd, p, f"{prefix}.branch3x3dbl_2")
    bd = _conv(bd, p, f"{prefix}.branch3x3dbl_3")
    return torch.cat([b3, bd, _max_pool(x)], 1)


def _block_c(x, p, prefix):
    b1 = _conv(x, p, f"{prefix}.branch1x1")
    b7 = _conv(x, p, f"{prefix}.branch7x7_1")
    b7 = _conv(b7, p, f"{prefix}.branch7x7_2")
    b7 = _conv(b7, p, f"{prefix}.branch7x7_3")
    bd = _conv(x, p, f"{prefix}.branch7x7dbl_1")
    for i in range(2, 6):
        bd = _conv(bd, p, f"{prefix}.branch7x7dbl_{i}")
    bp = _conv(_avg_pool(x), p, f"{prefix}.branch_pool")
    return torch.cat([b1, b7, bd, bp], 1)


def _block_d(x, p, prefix):
    b3 = _conv(x, p, f"{prefix}.branch3x3_1")
    b3 = _conv(b3, p, f"{prefix}.branch3x3_2")
    b7 = _conv(x, p, f"{prefix}.branch7x7x3_1")
    for i in range(2, 5):
        b7 = _conv(b7, p, f"{prefix}.branch7x7x3_{i}")
    return torch.cat([b3, b7, _max_pool(x)], 1)


def _block_e(x, p, prefix, pool: str):
    b1 = _conv(x, p, f"{prefix}.branch1x1")
    b3 = _conv(x, p, f"{prefix}.branch3x3_1")
    b3 = torch.cat([_conv(b3, p, f"{prefix}.branch3x3_2a"),
                    _conv(b3, p, f"{prefix}.branch3x3_2b")], 1)
    bd = _conv(x, p, f"{prefix}.branch3x3dbl_1")
    bd = _conv(bd, p, f"{prefix}.branch3x3dbl_2")
    bd = torch.cat([_conv(bd, p, f"{prefix}.branch3x3dbl_3a"),
                    _conv(bd, p, f"{prefix}.branch3x3dbl_3b")], 1)
    # FIDInceptionE_2 (Mixed_7c) uses a max pool here to match TF-Inception
    bp = (F.max_pool2d(x, 3, stride=1, padding=1) if pool == "max"
          else _avg_pool(x))
    bp = _conv(bp, p, f"{prefix}.branch_pool")
    return torch.cat([b1, b3, bd, bp], 1)


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 3, 299, 299] float32 in [0, 1] -> [B, 2048] features."""
    h = x * 2.0 - 1.0  # TF-Inception input scaling (normalize_input)
    h = _conv(h, params, "Conv2d_1a_3x3")
    h = _conv(h, params, "Conv2d_2a_3x3")
    h = _conv(h, params, "Conv2d_2b_3x3")
    h = _max_pool(h)
    h = _conv(h, params, "Conv2d_3b_1x1")
    h = _conv(h, params, "Conv2d_4a_3x3")
    h = _max_pool(h)
    for prefix in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        h = _block_a(h, params, prefix)
    h = _block_b(h, params, "Mixed_6a")
    for prefix in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        h = _block_c(h, params, prefix)
    h = _block_d(h, params, "Mixed_7a")
    h = _block_e(h, params, "Mixed_7b", pool="avg")
    h = _block_e(h, params, "Mixed_7c", pool="max")
    return h.mean(dim=(2, 3))  # adaptive avg pool -> [B, 2048]


@contextlib.contextmanager
def full_f32():
    """cuDNN convs and cuBLAS products in IEEE f32 for the block (TF32 off),
    the caller's flags restored after: FID features are defined in f32, and
    PyTorch lets cuDNN use TF32 by default."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


# ---------------------------------------------------------------------------
# clean-mode resize + extractor factory
# ---------------------------------------------------------------------------


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter, a = -0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@functools.lru_cache(maxsize=16)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64: PIL's bicubic resampling of one axis
    (``precompute_coeffs`` in its ``Resample.c``) as a matrix. Per output
    pixel i: center (i + 0.5) * scale, support 2 * max(scale, 1), the
    window [int(center - support + 0.5), int(center + support + 0.5))
    clipped to the input, weights bicubic((j - center + 0.5) / max(scale,
    1)) normalised to sum 1."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        w = _bicubic((np.arange(lo, hi) - center + 0.5) * ss)
        total = 0.0
        for v in w.tolist():  # PIL's order of summation
            total += v
        m[i, lo:hi] = w / total if total != 0.0 else w
    m.setflags(write=False)
    return m


@functools.lru_cache(maxsize=16)
def _resize_matrix_on(in_size: int, out_size: int, device: torch.device):
    """``resize_matrix`` on ``device``, copied there once."""
    return torch.tensor(resize_matrix(in_size, out_size), device=device)


def clean_resize(batch_u8, size: int = INPUT_SIZE) -> torch.Tensor:
    """clean-fid's "clean" resize of [B, H, W, 3] uint8 (a tensor on any
    device, or an array) -> [B, 3, size, size] float32 in roughly [0, 1],
    on the batch's device. PIL's float ("F") bicubic per channel, as the
    JAX package computes it through PIL: the horizontal pass in float64,
    rounded to float32 (PIL stores an F image between its passes), the
    vertical pass in float64, float32, then / 255. Deliberately NOT
    clipped: bicubic overshoots at sharp edges and clean-fid feeds the
    unclipped floats to its extractor."""
    x = torch.as_tensor(batch_u8)
    _b, h, w, _c = x.shape
    dev = x.device
    horiz = _resize_matrix_on(w, size, dev)
    vert = _resize_matrix_on(h, size, dev)
    x = x.permute(0, 3, 1, 2).to(torch.float64)  # [B, 3, H, W]
    t = torch.matmul(x, horiz.T).to(torch.float32).to(torch.float64)
    out = torch.matmul(vert, t).to(torch.float32)
    return out / 255.0


def _extract_fn(params, device):
    def extract(batch_u8: np.ndarray) -> np.ndarray:  # [B, H, W, 3] uint8
        x = torch.from_numpy(np.ascontiguousarray(batch_u8))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        with torch.no_grad(), full_f32():
            feats = forward(params, clean_resize(x))
        return feats.cpu().numpy()

    return extract


@functools.lru_cache(maxsize=2)
def _cached_extractor(path: str, device: torch.device):
    return _extract_fn(load_params(path, device), device)


def inception_extractor(device):
    """(extract, tag) on ``device`` when a local checkpoint exists, else
    None. ``extract``: [B, H, W, 3] uint8 -> [B, 2048] float32 numpy.

    The tag is the JAX package's, "inception-jax": it only names the stats
    file, and this is the same network on the same folded weights, whose
    features agree with the JAX forward's within 5e-4 of their largest
    magnitude (tests/test_torch_inception.py). So a stats file made with
    either package scores the other's folder."""
    path = default_weights_path()
    if path is None:
        return None
    try:
        return _cached_extractor(path, torch.device(device)), "inception-jax"
    except Exception as exc:  # unreadable / wrong checkpoint: fall through
        import sys

        print(f"[fid] could not load {path}: {exc}", file=sys.stderr)
        return None
