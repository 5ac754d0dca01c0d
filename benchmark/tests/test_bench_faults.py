"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the control of each kind of cell comes
out not correct too. At a tiny size on the CPU, past the harness's look
for a card, with the cells' own limits."""

from __future__ import annotations

import time
from unittest import mock

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import patched_table, tiny_files

TRAIN = ["infodiff64.train.b512", "vanilla64.train.b512"]
GEN = ["infodiff64.gen.b512", "vanilla64.gen.b512"]


def run(cell, seed=2**31 + 29, **kw):
    files = tiny_files(cell)
    with patched_table(files):
        return run_cell(cell, seed, 0.3, False, torch.device("cpu"),
                        files=files, t_start=time.perf_counter(), **kw)


def _unchanged_state():
    """The optimizer's step leaves parameters and moments as they were."""
    from infodiffusion_tpu_torch.train import state as S

    def update(self, params, grads, state, norm=None):
        return S.global_norm([g.to(torch.float32) for g in grads])

    return mock.patch.object(S.ClipAdamW, "update", update)


def _half_batch():
    """The loss over the first half of the batch, its mean over those."""
    from infodiffusion_tpu_torch.models import wrappers as W

    patches = []
    for cls in (W.InfoDiff, W.Diff):
        orig = cls.loss_fn

        def loss_fn(self, x, *a, _orig=orig, **k):
            return _orig(self, x[: x.shape[0] // 2], *a, **k)

        patches.append(mock.patch.object(cls, "loss_fn", loss_fn))
    return patches


def _answers_rolled(process_cls_name):
    """Each request gets its neighbour's answer: the sampler's output
    rolled by one row where it is produced."""
    from infodiffusion_tpu_torch.diffusion import samplers as SM

    cls = getattr(SM, process_cls_name)
    orig = cls.sampling

    def sampling(self, *a, **k):
        return torch.roll(orig(self, *a, **k), 1, dims=0)

    return mock.patch.object(cls, "sampling", sampling)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_sound_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_train_state_unchanged_is_caught(cell):
    with _unchanged_state():
        out = run(cell)
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAIN)
def test_train_half_batch_is_caught(cell):
    p1, p2 = _half_batch()
    with p1, p2:
        out = run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", GEN)
def test_gen_answer_altered_is_caught(cell):
    with _answers_rolled("DiffusionProcess"):
        out = run(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["image_gap"]["value"] > out["checks"][
        "image_gap"]["limit"]


def test_gen_latent_altered_is_caught():
    with _answers_rolled("LatentDiffusionProcess"):
        out = run("infodiff64.gen.b512")
    assert out["checks"]["latent_gap"]["value"] > out["checks"][
        "latent_gap"]["limit"]
    assert not out["correct"]


@pytest.mark.parametrize("cell", GEN)
def test_gen_control_int8_separates(cell):
    """The control, the program's own int8 tier in the program's place,
    reads far above a sound run at this size (float32 here; at the cell's
    own size it fails the limits: ``test_bench_control.py``)."""
    sound = run(cell)["checks"]
    ctl = run(cell, turbo="int8")["checks"]
    for k in sound:
        assert ctl[k]["value"] > 100 * sound[k]["value"], (k, ctl, sound)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_fp8_is_not_correct(cell):
    """The control: the reference put in the program's place, its products
    on fp8 operands, compared as a run compares the program."""
    from benchmark import port
    from benchmark.reference import model as RM
    from benchmark.reference import precision
    from benchmark.reference import train as RT
    from benchmark.traffic.train import gap_numbers

    files = tiny_files(cell)
    cfg, tr = files["config"], files["traffic"]
    seed = 2**31 + 41
    with patched_table(files):
        pc = port.port_config(cfg, tr["batch_size"], seed % (1 << 32))
        shapes = port.leaf_shapes(port.build(pc, "cpu"))
    imgs = port.images(cfg["dataset_images"], cfg["input_size"],
                       cfg["input_channels"], port.sub_seed(seed, port.DATA),
                       "cpu")
    RM.strict_f32()
    rc = dict(cfg, arch=dict(cfg["arch"], T=cfg["T"]))
    w0 = port.make_weights(shapes, port.sub_seed(seed, port.WEIGHTS), "cpu")
    kw = dict(n_steps=tr["check_steps"], batch=tr["batch_size"],
              block=tr["ref_block"], device="cpu", draw_dtype=torch.float32)
    ref = RT.run_steps(rc, w0, imgs, seed % (1 << 32), **kw)
    fp8 = RT.run_steps(rc, w0, imgs, seed % (1 << 32), q=precision.fp8, **kw)
    nums = gap_numbers(fp8, ref)
    limits = files["cell"]["limits"]
    assert any(nums[k] > limits[k] for k in limits), nums
