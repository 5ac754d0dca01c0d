"""Training traffic: one caller drives the port's train step in a closed
loop, as ``runner._train_loop`` drives it. Seeded uint8 CelebA-shaped
images go through the port's loader (``data/loader.py``: the dataset's
flip and shuffle flags, uint8 to the card, normalised there) into the
step from ``train/step.py`` ``make_train_step`` with the port's optimizer;
the loss and the other metrics are fetched to the host every ``log_every``
steps, as the runner fetches them. No checkpoint is written.

Set-up builds the one train state that the window then drives. Its first
``check_steps`` steps go through the window's own loop body and feed; the
loss of each, the first gradient as the optimizer took it (its first
moment over 1 - b1) and each leaf's norm of the parameters' change after
them are kept for the comparison with the reference, which follows the
same steps on its own after the window (``gap_numbers``).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark import harness as H
from benchmark import port
from benchmark.reference import model as RM
from benchmark.reference import train as RT


def gap_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of a training comparison; a cell's ``limits`` name the
    ones it compares, the rest are printed as diagnostics.

    By leaf, each against the larger of the leaf's reference norm and the
    median leaf's: the gap between the two norms of the first gradient as
    the optimizer took it (``grad_gap``) and of the parameters' change
    after the checked steps (``change_gap``), and the norm of the first
    gradients' difference (``grad_diff``); each by its worst leaf and its
    median leaf (``_median``). ``loss_gap`` is the worst step's relative
    loss gap. Leaves whose reference gradient is under a thousandth of the
    median leaf's (zero but for rounding, as a bias before a
    normalisation) are left out."""
    names = list(ref["grad_norms"])
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    g_med = float(np.median([ref["grad_norms"][n] for n in names]))
    kept = [n for n in names if ref["grad_norms"][n] >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][n] for n in kept]))
    gaps = {
        "grad_gap": {n: abs(prog["grad_norms"][n] - ref["grad_norms"][n])
                     / max(ref["grad_norms"][n], g_med) for n in kept},
        "change_gap": {n: abs(prog["change"][n] - ref["change"][n])
                       / max(ref["change"][n], c_med) for n in kept},
        "grad_diff": {n: float((prog["grads"][n].double()
                                - ref["grads"][n].double()).norm())
                      / max(ref["grad_norms"][n], g_med) for n in kept},
    }
    out = {"loss_gap": loss}
    for name, by_leaf in gaps.items():
        worst = max(by_leaf, key=by_leaf.get)
        out[name] = by_leaf[worst]
        out[name + "_median"] = float(np.median(list(by_leaf.values())))
        out[name + "_worst_leaf"] = worst
    return out


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.tr = run.traffic
        self.B = self.tr["batch_size"]
        self.spans = {"step_host_s": [], "loader_wait_s": []}

    # -- the loop body: one runner iteration ------------------------------

    def _next_batch(self):
        try:
            batch = next(self.it)
        except StopIteration:  # a new epoch, as the runner's epoch loop
            self.epoch += 1
            self.i = 0
            self.it = iter(self.loader)
            batch = next(self.it)
        return batch[0] if isinstance(batch, tuple) else batch

    def _finish(self, metrics):
        if self.i % self.log_every == 0:
            vals = self.fetch(metrics)
            if not math.isfinite(vals["loss"]):
                raise FloatingPointError(f"non-finite loss {vals['loss']} "
                                         f"at step {self.state.step}")
        self.i += 1

    def body(self):
        batch = self._next_batch()
        self.state, metrics = self.step_fn(self.state, batch, self.epoch)
        self._finish(metrics)
        return metrics

    def body_timed(self):
        """The same body with host clocks around the loader and the step's
        enqueue (traced runs only)."""
        t0 = time.perf_counter()
        batch = self._next_batch()
        t1 = time.perf_counter()
        self.state, metrics = self.step_fn(self.state, batch, self.epoch)
        t2 = time.perf_counter()
        self.spans["loader_wait_s"].append(t1 - t0)
        self.spans["step_host_s"].append(t2 - t1)
        self._finish(metrics)
        return metrics

    # -- set-up -------------------------------------------------------------

    def setup(self):
        from infodiffusion_tpu_torch.data.datasets import (
            ArrayDataset,
            dataset_flags,
        )
        from infodiffusion_tpu_torch.data.loader import DataLoader
        from infodiffusion_tpu_torch.runner import _fetch
        from infodiffusion_tpu_torch.train.state import (
            create_train_state,
            make_optimizer,
        )
        from infodiffusion_tpu_torch.train.step import make_train_step

        run, cfg, dev = self.run, self.cfg, self.run.device
        self.fetch = _fetch
        self.log_every = self.tr["log_every"]
        pc = port.port_config(cfg, self.B, run.r_seed)
        self.images = port.images(cfg["dataset_images"], cfg["input_size"],
                                  cfg["input_channels"],
                                  port.sub_seed(run.seed, port.DATA), dev)
        run.phase("data")
        flip, shuffle = dataset_flags(pc.dataset)
        self.loader = DataLoader(ArrayDataset(self.images), self.B,
                                 device=dev, shuffle=shuffle, flip=flip,
                                 seed=pc.r_seed)
        model = port.build(pc, dev)
        self.shapes = port.leaf_shapes(model)
        port.load_weights(model, port.make_weights(
            self.shapes, port.sub_seed(run.seed, port.WEIGHTS), dev))
        tx = make_optimizer(pc.learning_rate, pc.epochs,
                            max(len(self.loader), 1))
        self.state = create_train_state(model.train(), pc.r_seed, tx,
                                        ema=pc.ema_decay > 0)
        self.step_fn = make_train_step(model, tx, ema_decay=pc.ema_decay)
        self.epoch, self.i = 0, 0
        self.it = iter(self.loader)
        run.phase("model")

        params = list(self.state.params.values())
        p0 = [p.detach().clone() for p in params]
        losses = []
        for k in range(self.tr["check_steps"]):
            losses.append(self.body()["loss"])
            if k == 0:
                run.phase("first_step")
            if k == 0:
                mu = self.state.opt_state.mu
                g1 = torch.stack(torch._foreach_norm(mu)) / (1.0 - tx.b1)
                first = [m.detach().cpu() / (1.0 - tx.b1) for m in mu]
        change = torch.stack(torch._foreach_norm(torch._foreach_sub(
            [p.detach() for p in params], p0)))
        del p0
        names = [n for n, _ in self.shapes]
        self.prog = {"losses": [float(x) for x in losses],
                     "grad_norms": dict(zip(names, g1.double().tolist())),
                     "change": dict(zip(names, change.double().tolist())),
                     "grads": dict(zip(names, first))}
        for _ in range(self.tr["warmup_steps"]):
            self.body()
        run.marks.sync()
        run.phase("warmup")

    # -- the window -----------------------------------------------------------

    def window(self) -> dict:
        """Steps back to back until ``seconds`` have passed on the host
        clock, then one synchronize. Only the loop and its marks run."""
        marks, seconds = self.run.marks, self.run.seconds
        body = self.body_timed if self.run.trace else self.body
        ends = []
        start = marks.mark()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            body()
            ends.append(marks.mark())
        marks.sync()
        total_ms = marks.ms(start, ends[-1])
        steps_ms = [marks.ms(a, b) for a, b in zip([start] + ends[:-1], ends)]
        self.rate = len(ends) * self.B / (total_ms / 1e3)
        q = [H.percentile(steps_ms, p) for p in (10, 25, 50, 75, 90)]
        self.window_diag = {"step_ms_p10_25_50_75_90": q}
        return {"attempted": len(ends), "failed": 0,
                "metrics": {"train_imgs_per_s": self.rate,
                            "train_step_ms_p90": H.percentile(steps_ms, 90)}}

    # -- the traced steps ---------------------------------------------------

    def profile(self, capture) -> dict:
        n = self.tr["profile_steps"]

        def steps():
            for _ in range(n):
                self.body()

        out = capture(steps, warm=self.body)
        out["steps"] = n
        return out

    # -- the comparison -----------------------------------------------------

    def check(self) -> Dict[str, float]:
        run, dev = self.run, self.run.device
        self.it.close()
        del self.state, self.step_fn, self.it, self.loader
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        RM.strict_f32()
        rc = dict(self.cfg, arch=dict(self.cfg["arch"], T=self.cfg["T"]))
        w0 = port.make_weights(self.shapes,
                               port.sub_seed(run.seed, port.WEIGHTS), dev)
        draw = (torch.bfloat16 if self.cfg["dtype"] == "bfloat16"
                else torch.float32)
        ref = RT.run_steps(rc, w0, self.images, run.r_seed,
                           self.tr["check_steps"], self.B,
                           self.tr["ref_block"], dev, draw)
        return gap_numbers(self.prog, ref)

    def layer_data(self) -> dict:
        return {"kind": "train", "spans": self.spans, "rate": self.rate,
                "batch": self.B}
