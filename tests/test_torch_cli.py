"""The port's command line against the JAX package's: the same flags,
defaults, choices and required markers; every ``scripts/*.sh`` command and
the verify recipe parse to the same ``Config`` field by field; the flags
that need more than one device raise; with no card and without
``INFODIFF_FORCE_CPU=1`` a run raises; ``__main__`` runs the CLI only as a
script."""

import dataclasses
import glob
import os
import re
import shlex
import subprocess
import sys

import pytest

from infodiffusion_tpu import cli as jcli
from infodiffusion_tpu_torch import cli as pcli
from infodiffusion_tpu_torch import runner as prunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the verify recipe (README.md, the port's command line), step by step
RECIPE_COMMON = ("--model diff --prior regular --dataset mnist --a_dim 32 "
                 "--data_dir synthetic --diffusion_steps 50 --batch_size 16 "
                 "--r_seed 7 -e 1")
RECIPE = [
    f"{RECIPE_COMMON} --mode train --save_epochs 1",
    f"{RECIPE_COMMON} --mode save_latent",
    f"{RECIPE_COMMON} --mode train_latent_ddim --save_epochs 1",
    f"{RECIPE_COMMON} --mode eval_fid --is_latent --deterministic "
    f"--sampling_number 16",
]


def _script_commands():
    """(script, argv, require_mode) of every run.py and
    eval_disentanglement.py command in scripts/*.sh."""
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "scripts", "*.sh"))):
        with open(path) as f:
            for line in f:
                words = shlex.split(line, comments=True)
                for entry, require in (("run.py", True),
                                       ("eval_disentanglement.py", False)):
                    if entry in words:
                        argv = words[words.index(entry) + 1:]
                        out.append((os.path.basename(path), argv, require))
    return out


SCRIPT_COMMANDS = _script_commands()


def _signature(parser):
    return sorted(
        (tuple(a.option_strings), a.dest, repr(a.default), a.required,
         tuple(a.choices) if a.choices else None, getattr(a, "type", None)
         and a.type.__name__, a.nargs, a.const)
        for a in parser._actions)


@pytest.mark.parametrize("require_mode", [True, False])
def test_parser_matches_jax(require_mode):
    assert _signature(pcli.build_parser(require_mode)) == _signature(
        jcli.build_parser(require_mode))


def _help_flags(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    options = out.stdout.split("options:", 1)[1]  # past the usage line
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w]*)", options))


def test_help_lists_run_py_flags():
    want = _help_flags([sys.executable, "run.py", "--help"])
    assert "--turbo" in want and "-e" in want
    assert _help_flags([sys.executable, "-m", "infodiffusion_tpu_torch",
                        "--help"]) == want


def test_scripts_parse_to_the_same_config():
    assert len(SCRIPT_COMMANDS) >= 9
    for name, argv, require in SCRIPT_COMMANDS + [
            ("verify recipe", shlex.split(c), True) for c in RECIPE]:
        j = jcli.build_parser(require).parse_args(argv)
        p = pcli.build_parser(require).parse_args(argv)
        want = dataclasses.asdict(jcli.Config(**vars(j)))
        got = dataclasses.asdict(pcli.Config(**vars(p)))
        assert got == want, (name, argv)


# in one process with no process group, what the JAX runner does on one
# device: these raise (no group to join, --pp outside train_latent_ddim,
# a 'seq' group wider than the run), the others are no-ops there
MULTI_DEVICE_RAISES = {
    "--multihost": "MASTER_ADDR|RANK|WORLD_SIZE",
    "--pp 2": "train_latent_ddim",
    "--sp 2": "'seq' mesh wants 2 devices",
}


@pytest.mark.parametrize("flags", [["--mesh_devices", "2"], ["--multihost"],
                                   ["--fsdp"], ["--tp", "2"], ["--pp", "2"],
                                   ["--sp", "2"]])
def test_multi_device_flags_raise(flags, monkeypatch):
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "INFODIFF_MULTIHOST"):
        monkeypatch.delenv(key, raising=False)
    match = MULTI_DEVICE_RAISES.get(" ".join(flags))
    if match is None:
        cfg = pcli.parse_args(shlex.split(RECIPE[0]) + flags)
        plan = prunner.parallel_plan(cfg)
        assert plan.mesh is None and plan.pp_mesh is None
        assert plan.rows is None
        return
    with pytest.raises((ValueError, RuntimeError), match=match):
        pcli.main(shlex.split(RECIPE[0]) + flags)


def test_one_device_values_of_those_flags_pass():
    cfg = pcli.parse_args(shlex.split(RECIPE[0]) + [
        "--mesh_devices", "1", "--tp", "1", "--pp", "1", "--sp", "1"])
    plan = prunner.parallel_plan(cfg)
    assert (plan.mesh, plan.pp_mesh, plan.rows) == (None, None, None)


def test_no_card_without_force_cpu_raises(monkeypatch):
    monkeypatch.delenv("INFODIFF_FORCE_CPU", raising=False)
    assert not prunner.torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="INFODIFF_FORCE_CPU"):
        prunner.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(shlex.split(RECIPE[1]))
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    assert prunner.resolve_device().type == "cpu"


def test_turbo_int8x_flag():
    """``--turbo int8x`` parses to the tier, as JAX's
    test_cli_turbo_int8x_flag has it; an unknown tier is argparse's
    error."""
    for tier in ("int8x", "int8"):
        assert pcli.parse_args(shlex.split(RECIPE[0]) + [
            "--turbo", tier]).turbo == tier
    with pytest.raises(SystemExit):
        pcli.parse_args(shlex.split(RECIPE[0]) + ["--turbo", "fp4"])


@pytest.mark.parametrize("mode,batch", [("disentangle", 1),
                                        ("latent_quality", 1),
                                        ("interpolate", 2), ("eval", 16)])
def test_dispatch_batch_size_overrides(mode, batch, monkeypatch):
    seen = []
    monkeypatch.setattr(prunner, "evaluate",
                        lambda cfg, device=None: seen.append(cfg))
    pcli.main(shlex.split(RECIPE_COMMON) + ["--mode", mode])
    assert [c.batch_size for c in seen] == [batch]


def test_main_module_runs_only_as_a_script():
    code = "import infodiffusion_tpu_torch.__main__; print('imported')"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.strip() == "imported", out.stderr
    out = subprocess.run([sys.executable, "-m", "infodiffusion_tpu_torch"],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 2 and "required" in out.stderr
