"""Generation traffic: one caller asks for batches of images back to back
in a closed loop, as ``runner._mode_eval_fid`` composes them. For InfoDiff
a batch is the latent prior's trajectory (``LatentDiffusionProcess
.sampling``, K4 over the full grid) and then DDIM with that latent
(``DiffusionProcess.sampling``); for the vanilla model DDIM alone. Each
batch's uint8 codes go back to the host with one batch in flight
(``runner._fid_codes``, ``runner._to_host_async``): the host waits for a
batch's codes only once the next batch is queued. No PNG is written.

The starting noise of both legs and the prior's per-step draws are made
for each batch from the seed and handed to the port (the same draws its
own generator would make, in the same calls), so the reference can take
the same inputs. Forward hooks on the image model record a CUDA event at
the start of each DDIM step.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness as H
from benchmark import port
from benchmark.reference import model as RM
from benchmark.reference import sample as RS


def row_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The worst row's relative L2 distance of ``p`` from ``r``."""
    p = p.double().flatten(1)
    r = r.double().flatten(1)
    return float(((p - r).norm(dim=1) / r.norm(dim=1)).max())


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.tr = run.traffic
        self.B = self.tr["batch_size"]
        self.info = self.cfg["model"] == "infodiff"
        self.spans = {"fwd_host_s": []}
        self.step_marks: List = []

    def _inputs(self, b: int, purpose: int = port.BATCH):
        """Batch ``b``'s draws: the prior's zT [B, a] and per-step noise
        [T, B, a] (InfoDiff), and the images' xT [B, H, W, C]."""
        cfg, dev = self.cfg, self.run.device
        g = torch.Generator(device=dev).manual_seed(
            port.sub_seed(self.run.seed, purpose, b))
        zT = noises = None
        if self.info:
            zT = torch.randn((self.B, cfg["a_dim"]), generator=g, device=dev)
            noises = torch.randn((cfg["T"], self.B, cfg["a_dim"]),
                                 generator=g, device=dev)
        s = cfg["input_size"]
        xT = torch.randn((self.B, s, s, cfg["input_channels"]), generator=g,
                         device=dev)
        return zT, noises, xT

    def _pre(self, module, args):
        self.step_marks.append(self.run.marks.mark())

    def _pre_timed(self, module, args):
        self.step_marks.append(self.run.marks.mark())
        self.spans["fwd_host_s"].append(time.perf_counter())

    def setup(self):
        from infodiffusion_tpu_torch.diffusion.samplers import (
            DiffusionProcess,
            LatentDiffusionProcess,
        )
        from infodiffusion_tpu_torch.runner import _fid_codes, _to_host_async

        run, cfg, dev = self.run, self.cfg, self.run.device
        self.codes, self.to_host = _fid_codes, _to_host_async
        pc = port.port_config(cfg, self.B, run.r_seed,
                              turbo=run.turbo or "off")
        model = port.build(pc, dev)
        self.shapes = port.leaf_shapes(model)
        port.load_weights(model, port.make_weights(
            self.shapes, port.sub_seed(run.seed, port.WEIGHTS), dev))
        self.latent = None
        if self.info:
            lat = port.build(pc, dev, latent=True)
            self.lat_shapes = port.leaf_shapes(lat)
            port.load_weights(lat, port.make_weights(
                self.lat_shapes, port.sub_seed(run.seed,
                                               port.LATENT_WEIGHTS), dev))
            self.latent = LatentDiffusionProcess(pc, lat)
        self.process = DiffusionProcess(pc, model)
        run.phase("model")
        self.hook = model.register_forward_pre_hook(
            self._pre_timed if run.trace else self._pre)
        # the cell's shapes: a whole prior trajectory, two DDIM steps and
        # the codes' copy, at the batch size
        zT, noises, xT = self._inputs(0, port.WARMUP)
        a = (self.latent.sampling(xT=zT, noises=noises) if self.info
             else None)
        x = self.process.sampling(sampling_number=self.B, xT=xT, a=a,
                                  num_steps=2)
        host, done = self.to_host(self.codes(x))
        if done is not None:
            done.synchronize()
        del zT, noises, xT, a, x, host
        self.step_marks.clear()
        self.spans["fwd_host_s"].clear()
        run.marks.sync()
        run.phase("warmup")

    def batch(self, b: int):
        """One batch: the prior, DDIM, the codes' copy queued. Returns (a,
        x, the mark after DDIM, the codes in flight)."""
        zT, noises, xT = self._inputs(b)
        a = (self.latent.sampling(xT=zT, noises=noises) if self.info
             else None)
        x = self.process.sampling(sampling_number=self.B, xT=xT, a=a)
        sampled = self.run.marks.mark()
        return a, x, sampled, self.to_host(self.codes(x))

    @staticmethod
    def _wait_codes(pending):
        """The program's own wait for a batch's codes on the host (its
        copy's event), as ``runner._save_fid_batch`` waits before writing
        the batch's PNGs."""
        if pending is not None and pending[1] is not None:
            pending[1].synchronize()

    def window(self) -> dict:
        """Batches back to back until ``seconds`` have passed on the host
        clock; the host waits for batch n's codes once batch n+1 is queued.
        Only the loop and its marks run."""
        marks, seconds = self.run.marks, self.run.seconds
        self.kept, sampled, done = [], [], []
        pending = None
        start = marks.mark()
        t0 = time.perf_counter()
        b = 0
        while time.perf_counter() - t0 < seconds:
            a, x, s_mark, queued = self.batch(b)
            done.append(marks.mark())
            self.kept.append((a, x))
            sampled.append(s_mark)
            self._wait_codes(pending)
            pending = queued
            b += 1
        self._wait_codes(pending)
        marks.sync()
        self.n_batches = b
        total_ms = marks.ms(start, done[-1])
        steps = self.cfg["sampling_steps"]
        steps_ms = []
        for i in range(b):
            m = self.step_marks[i * steps:(i + 1) * steps] + [sampled[i]]
            steps_ms += [marks.ms(u, v) for u, v in zip(m[:-1], m[1:])]
        self.rate = b * self.B / (total_ms / 1e3)
        self.window_diag = {"batch_ms": [
            marks.ms(u, v) for u, v in zip([start] + done[:-1], done)]}
        return {"attempted": b * self.B, "failed": 0,
                "metrics": {"gen_imgs_per_s": self.rate,
                            "gen_step_ms_p95": H.percentile(steps_ms, 95)}}

    def profile(self, capture) -> dict:
        """One more whole batch, traced."""
        self.step_marks.clear()

        def one():
            self._wait_codes(self.batch(self.n_batches)[3])

        out = capture(one)
        out["batches"] = 1
        return out

    def check(self) -> Dict[str, float]:
        """The sampled rows of the window's batches against the reference
        run from the same draws."""
        run, cfg, dev = self.run, self.cfg, self.run.device
        rng = np.random.default_rng(port.sub_seed(run.seed, port.CHECK))
        n = self.tr["check_rows"]
        picks = sorted(zip(rng.integers(0, self.n_batches, n).tolist(),
                           rng.integers(0, self.B, n).tolist()))
        a_p = (torch.stack([self.kept[b][0][r] for b, r in picks])
               if self.info else None)
        x_p = torch.stack([self.kept[b][1][r] for b, r in picks])
        self.hook.remove()
        del self.kept, self.process, self.latent
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        RM.strict_f32()
        rc = dict(cfg, arch=dict(cfg["arch"], T=cfg["T"]))
        zs, ns, xs = [], [], []
        for b in sorted({b for b, _ in picks}):
            zT, noises, xT = self._inputs(b)
            rows = [r for bb, r in picks if bb == b]
            xs.append(xT[rows])
            if self.info:
                zs.append(zT[rows])
                ns.append(noises[:, rows])
        xT = torch.cat(xs)
        P = port.make_weights(self.shapes,
                              port.sub_seed(run.seed, port.WEIGHTS), dev)
        out = {}
        a_r = None
        if self.info:
            PL = port.make_weights(
                self.lat_shapes, port.sub_seed(run.seed, port.LATENT_WEIGHTS),
                dev)
            a_r = RS.latent_ddpm(rc, PL, torch.cat(zs), torch.cat(ns, dim=1))
            out["latent_gap"] = row_gap(a_p, a_r)
        x_r = RS.ddim(rc, P, xT, a_r)
        out["image_gap"] = row_gap(x_p, x_r)
        return out

    def layer_data(self) -> dict:
        steps = self.cfg["sampling_steps"]
        t = self.spans["fwd_host_s"]
        # host seconds between the starts of consecutive DDIM steps of one
        # batch
        host = [t[i + 1] - t[i] for i in range(len(t) - 1)
                if (i + 1) % steps]
        return {"kind": "gen", "spans": {"fwd_host_s": host},
                "rate": self.rate, "batch": self.B}
