"""Offline check of a candidate pt_inception FID weights file, then a
forward on the card.

    python -m infodiffusion_tpu_torch.tools.verify_inception_weights
        [weights.pth] [--device cpu]     # default: $INFODIFF_INCEPTION_WEIGHTS

1. identity: the file's SHA-256; the canonical release
   (``pt_inception-2015-12-05-6726825d.pth``) starts with ``6726825d``.
   A mismatch is a warning: a re-saved copy of the same tensors scores
   the same.
2. schema: every tensor the loader folds exists with its exact shape
   (``metrics/inception.py``: ``expected_state_dict_schema``,
   ``verify_state_dict_schema``).
3. load and forward: ``load_params`` on the device, then the port's
   InceptionV3 on a deterministic [2, 3, 299, 299] batch must give finite
   [2, 2048] features.

Prints one JSON verdict line with the JAX package's keys
(``tools/verify_inception_weights.py``); the exit code is 0 only when the
file is usable (schema and forward).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from infodiffusion_tpu_torch.metrics import inception as inc
from infodiffusion_tpu_torch.tools import resolve_device


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify(path: str, device=None) -> dict:
    verdict = {
        "path": path,
        "canonical_filename": inc.CANONICAL_WEIGHTS_FILENAME,
        "sha256": None,
        "canonical_identity": False,
        "schema_ok": False,
        "forward_ok": None,
        "problems": [],
        "usable": False,
    }
    if not os.path.exists(path):
        verdict["problems"].append(f"file does not exist: {path}")
        return verdict
    digest = file_sha256(path)
    verdict["sha256"] = digest
    verdict["canonical_identity"] = digest.startswith(
        inc.CANONICAL_SHA256_PREFIX)
    if not verdict["canonical_identity"]:
        verdict["problems"].append(
            f"warning: sha256 {digest[:8]}... does not start with "
            f"{inc.CANONICAL_SHA256_PREFIX} \u2014 not the canonical release "
            "bytes (a re-saved state_dict of the same tensors is still "
            "usable; scores are only citable as pytorch-fid-exact if the "
            "tensors match the release)")
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - torch's message is the verdict
        verdict["problems"].append(f"torch.load failed: {e}")
        return verdict
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    ok, problems = inc.verify_state_dict_schema(
        {k: v.numpy() for k, v in obj.items() if hasattr(v, "numpy")})
    verdict["schema_ok"] = ok
    verdict["problems"].extend(problems)
    if not ok:
        return verdict
    device = resolve_device(device)
    params = inc.load_params(path, device)
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1, (2, inc.INPUT_SIZE, inc.INPUT_SIZE, 3)).astype(
            np.float32)).permute(0, 3, 1, 2).to(device)
    with torch.no_grad(), inc.full_f32():
        feats = inc.forward(params, x)
    finite = bool(torch.isfinite(feats).all())
    verdict["forward_ok"] = (tuple(feats.shape) == (2, inc.FEATURE_DIM)
                             and finite)
    if not verdict["forward_ok"]:
        verdict["problems"].append(
            f"forward produced shape {tuple(feats.shape)}, "
            f"finite={finite}")
    verdict["usable"] = verdict["forward_ok"]
    return verdict


def main(argv=None, device: Optional[str] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("path", nargs="?",
                        default=os.environ.get("INFODIFF_INCEPTION_WEIGHTS"))
    parser.add_argument("--device", default=device,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if not args.path:
        print("usage: verify_inception_weights <weights.pth> (or set "
              "INFODIFF_INCEPTION_WEIGHTS)", file=sys.stderr)
        return 2
    verdict = verify(args.path, args.device)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["usable"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
