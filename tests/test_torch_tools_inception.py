"""``tools.verify_inception_weights`` on a fixture checkpoint
(``metrics.inception.random_state_dict``): its verdict has the JAX tool's
keys and the same answers, its exit code is 0 on the fixture (the forward
runs, here on the CPU) and 1 with a tensor missing, as the JAX tool's."""

from __future__ import annotations

import json
import os
import sys

import torch

from infodiffusion_tpu_torch.metrics import inception
from infodiffusion_tpu_torch.tools import verify_inception_weights as port

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _jax_tool():
    sys.path.insert(0, TOOLS)
    try:
        import verify_inception_weights as jax_tool
    finally:
        sys.path.remove(TOOLS)
    return jax_tool


def test_verdict_and_exit_codes_match_jax(tmp_path, capsys):
    jax_tool = _jax_tool()
    sd = inception.random_state_dict(seed=4)
    good = tmp_path / "pt_inception-candidate.pth"
    torch.save(sd, good)
    broken = tmp_path / "pt_inception-broken.pth"
    torch.save({k: v for k, v in sd.items()
                if k != "Mixed_6e.branch7x7_1.conv.weight"}, broken)

    assert port.main([str(good), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = jax_tool.verify(str(good), forward=False)
    assert set(got) == set(want)
    assert got["forward_ok"] is True and got["usable"] is True
    for key in ("path", "canonical_filename", "sha256",
                "canonical_identity", "schema_ok", "problems"):
        assert got[key] == want[key], key

    assert port.main([str(broken), "--device", "cpu"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert jax_tool.main([str(broken)]) == 1
    want = json.loads(capsys.readouterr().out)
    assert got == want
    assert any("missing tensor: Mixed_6e.branch7x7_1.conv.weight" in p
               for p in got["problems"])

    missing = str(tmp_path / "none.pth")
    assert port.main([missing, "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out) == port.verify(missing)
