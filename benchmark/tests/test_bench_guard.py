"""No module of the benchmark imports JAX, Flax or the JAX package
(compared by whole top-level name, so the port ``infodiffusion_tpu_torch``
passes), and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "infodiffusion_tpu"}
PORT = "infodiffusion_tpu_torch"


def imported_names(path: Path):
    """(top-level name, line) of every import in a source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".", 1)[0], node.lineno


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    bad = [(n, line) for n, line in imported_names(path) if n in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        bad = [(n, line) for n, line in imported_names(path) if n == PORT]
        assert not bad, f"{path} imports the port: {bad}"


def test_guard_compares_whole_names(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import infodiffusion_tpu_torch.ops\n"
                     "from infodiffusion_tpu.x import y\n")
    names = [n for n, _ in imported_names(probe)]
    assert names == ["infodiffusion_tpu_torch", "infodiffusion_tpu"]
    assert [n in FORBIDDEN for n in names] == [False, True]


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from benchmark import harness as H

    assert H.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "infodiffusion_tpu.fake",
                        types.ModuleType("infodiffusion_tpu.fake"))
    monkeypatch.setitem(sys.modules, "infodiffusion_tpu_torch_fake",
                        types.ModuleType("infodiffusion_tpu_torch_fake"))
    found = H.forbidden_modules()
    assert "infodiffusion_tpu.fake" in found
    assert "infodiffusion_tpu_torch_fake" not in found
