"""The control of each cell's comparison comes out not correct at the
cell's own size on the card: the reference with fp8 operands in the
training step's place, the port's own int8 tier in generation's. Skips
without a card; ``benchmark/control.py`` gives the readings of more
seeds."""

from __future__ import annotations

import pytest

from benchmark import harness as H

CELLS = [w["name"] for w in H.benchmark_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    from benchmark import control

    files = H.cell_files(cell)
    limits = files["cell"]["limits"]
    device = torch.device("cuda", 0)
    seed = 2**31 + 77
    if files["traffic"]["kind"] == "train":
        nums = control.train_readings(files, seed, device)["control_fp8"]
    else:
        nums = control.gen_readings(cell, files, seed, 8.0,
                                    device)["control_int8"]
    assert any(nums[k] > limits[k] for k in limits), nums
