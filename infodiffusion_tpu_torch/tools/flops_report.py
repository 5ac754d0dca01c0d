"""FLOP count of the flagship CelebA-64 InfoDiff on the port's plain path:
GFLOP per sample of the forward (the DDIM denoiser body) and per
DDIM-100 sample, and GFLOP per image of the full train step (the loss,
its backward, the clip and AdamW), each split by op class.

    python -m infodiffusion_tpu_torch.tools.flops_report [--size 64]
        [--train-imgs-per-s R] [--ddim-samples-per-s R] [--card NAME]
        [--train-batch 128]

The count runs ``torch.utils.flop_counter.FlopCounterMode`` over the
model's plain PyTorch path on the ``meta`` device (no memory, no
arithmetic), or on the CPU where an op has no meta kernel, so it reads
the same work whatever kernel runs each op on the card: it is the basis
of a model-FLOPs utilisation. A multiply-add is 2 FLOPs. Two conventions
are printed:

- ``valid_taps`` (the basis): convolutions counted as XLA's cost analysis
  counts them, only the taps that land inside the unpadded input; the
  padding taps multiply by zero and are no work the model needs (the JAX
  package's ``tools/flops_report.py`` reports that count, with XLA's
  elementwise FLOPs besides, which neither convention here counts);
- ``all_taps`` (for information): torch's, every tap of every
  convolution.

Achieved TFLOP/s is printed only for a rate measured on the card and
passed in, beside the H100 SXM's dense bf16 peak. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import A_DIM, flagship_config
from infodiffusion_tpu_torch.train.state import make_optimizer
from infodiffusion_tpu_torch.train.step import loss_and_grads

aten = torch.ops.aten
PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16 (NVIDIA's data sheet)
DDIM_STEPS = 100
FORWARD_BATCH = 64  # the JAX tool's batches (the forward's FLOPs a
TRAIN_BATCH = 128   # sample do not depend on its batch; the MMD's do)


def _valid_taps(n: int, k: int, s: int, p: int, d: int, o: int) -> int:
    """Of the o*k (output, tap) pairs along one dim, those whose input
    index lies inside [0, n)."""
    return sum(1 for i in range(o) for j in range(k)
               if 0 <= i * s - p + j * d < n)


def _conv_macs(x_shape, w_shape, out_shape, stride, padding, dilation,
               transposed) -> int:
    """Multiply-adds of a convolution over the valid taps only."""
    if transposed:
        raise NotImplementedError("the valid-tap count of a transposed conv")
    macs = x_shape[0] * w_shape[0] * w_shape[1]
    for i, k in enumerate(w_shape[2:]):
        macs *= _valid_taps(x_shape[2 + i], k, stride[i], padding[i],
                            dilation[i], out_shape[2 + i])
    return macs


CONVENTIONS = ("valid_taps", "all_taps")
MFU_BASIS = "valid_taps"


def _by_class(counts, n: int) -> Dict[str, float]:
    """GFLOP per sample by op class (the aten op's name)."""
    out = {str(op).replace("aten.", ""): flops / n / 1e9
           for op, flops in sorted(counts.items(), key=lambda kv: str(kv[0]))}
    out["total"] = sum(out.values())
    return out


def count(run, n: int) -> Dict[str, Dict[str, float]]:
    """GFLOP per sample of ``run()`` over ``n`` samples, by op class, in
    both conventions (one pass: the convolutions' valid taps are summed
    beside torch's count)."""
    valid = defaultdict(int)

    def conv(x_shape, w_shape, bias, stride, padding, dilation, transposed,
             *args, out_shape=None, **kwargs) -> int:
        valid[aten.convolution] += 2 * _conv_macs(
            x_shape, w_shape, out_shape, stride, padding, dilation,
            transposed)
        return conv_flop_count(x_shape, w_shape, out_shape, transposed)

    def conv_backward(grad_out_shape, x_shape, w_shape, bias, stride,
                      padding, dilation, transposed, output_padding, groups,
                      output_mask, out_shape=None, **kwargs) -> int:
        # each (output, tap) pair is one multiply-add of the input's
        # gradient and one of the weight's, as torch's formula counts them
        grads = int(output_mask[0]) + int(output_mask[1])
        valid[aten.convolution_backward] += 2 * _conv_macs(
            x_shape, w_shape, grad_out_shape, stride, padding, dilation,
            transposed) * grads
        return conv_flop_count(x_shape, w_shape, grad_out_shape,
                               transposed) * grads

    with FlopCounterMode(display=False, custom_mapping={
            aten.convolution: conv,
            aten.convolution_backward: conv_backward}) as counter:
        run()
    counts = counter.get_flop_counts().get("Global", {})
    return {"valid_taps": _by_class({**counts, **valid}, n),
            "all_taps": _by_class(counts, n)}


def _model(size: int, device: str):
    torch.manual_seed(0)
    return build_model(flagship_config(size), dtype=torch.float32,
                       device=device)


def forward_counts(batch: int = FORWARD_BATCH, size: int = 64,
                   device: str = "meta", model=None,
                   a_dim: int = A_DIM) -> Dict:
    """GFLOP per sample of one InfoDiff forward (the flagship, or
    ``model`` with its ``a_dim``), in both conventions."""
    net = (model or _model(size, device)).eval()
    dev = next(net.parameters()).device
    x = torch.zeros(batch, size, size, 3, device=dev)
    t = torch.zeros(batch, dtype=torch.long, device=dev)
    a = torch.zeros(batch, a_dim, device=dev)

    def run():
        with torch.no_grad():
            net(x, t, a)

    return count(run, batch)


def train_step_counts(batch: int = TRAIN_BATCH, size: int = 64,
                      device: str = "meta", model=None,
                      a_dim: int = A_DIM) -> Dict:
    """GFLOP per image of one train step: the loss with injected draws
    (dropout off: it adds no product), its backward, the clip and AdamW
    (elementwise: no FLOP in either convention)."""
    net = (model or _model(size, device)).train()
    dev = next(net.parameters()).device
    params = dict(net.named_parameters())
    tx = make_optimizer(1e-4, 50, 1000)
    x = torch.zeros(batch, size, size, 3, device=dev)
    draws = dict(t=torch.zeros(batch, dtype=torch.long, device=dev),
                 eps=torch.zeros_like(x),
                 reparam_eps=torch.zeros(batch, a_dim, device=dev),
                 prior_samples=torch.zeros(batch, a_dim, device=dev))

    def run():
        opt = tx.init(params)
        _, _, grads = loss_and_grads(net, x, 0, deterministic=True, **draws)
        tx.update(params, grads, opt)

    return count(run, batch)


def counts_on(fn, **kw) -> Dict:
    """``fn`` on ``meta``, or on the CPU where an op has no meta kernel
    (never on the card, whose kernels the counter cannot see); says which
    device counted."""
    try:
        return {"counted_on": "meta", **fn(device="meta", **kw)}
    except NotImplementedError:
        return {"counted_on": "cpu", **fn(device="cpu", **kw)}


def achieved(rate: Optional[float], gflop: float, card: Optional[str]):
    """TFLOP/s of ``rate`` (per second, measured on the card) at ``gflop``
    each, against the dense bf16 peak; None without a rate."""
    if rate is None:
        return None
    tflops = rate * gflop / 1e3
    return {"rate": rate, "card": card, "tflops": tflops,
            "peak_tflops": PEAK_BF16_TFLOPS,
            "peak": "H100 SXM dense bf16", "share": tflops / PEAK_BF16_TFLOPS}


def main(size: int = 64, train_imgs_per_s: Optional[float] = None,
         ddim_samples_per_s: Optional[float] = None,
         card: Optional[str] = None, train_batch: int = TRAIN_BATCH) -> Dict:
    fwd = counts_on(forward_counts, size=size)
    train = counts_on(train_step_counts, batch=train_batch, size=size)
    params = sum(p.numel() for p in _model(size, "meta").parameters())
    basis = fwd[MFU_BASIS]["total"]
    out = {
        "model": f"CelebA-64 InfoDiff at {size}px", "params": params,
        "forward_gflop_per_sample": fwd,
        "ddim100_gflop_per_sample": {c: fwd[c]["total"] * DDIM_STEPS
                                     for c in CONVENTIONS},
        "train_step_gflop_per_image": train,
        "mfu_basis": MFU_BASIS,
        "ddim100_achieved": achieved(ddim_samples_per_s,
                                     basis * DDIM_STEPS, card),
        "train_achieved": achieved(train_imgs_per_s,
                                   train[MFU_BASIS]["total"], card),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--train-imgs-per-s", type=float, default=None,
                        help="a train rate measured on the card")
    parser.add_argument("--ddim-samples-per-s", type=float, default=None,
                        help="a DDIM-100 rate measured on the card")
    parser.add_argument("--card", default=None,
                        help="the card and power limit of those rates")
    parser.add_argument("--train-batch", type=int, default=TRAIN_BATCH,
                        help="the MMD's share per image depends on it")
    args = parser.parse_args()
    main(args.size, args.train_imgs_per_s, args.ddim_samples_per_s,
         args.card, args.train_batch)
