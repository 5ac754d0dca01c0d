#!/usr/bin/env python3
"""Drive the torch port's generation, training, int8, vanilla / two-phase /
VAE, 512px, ch-32 (mnist, chairs), command-line, evaluation,
reference-checkpoint / image-folder, parallel, remat and tool paths on one
NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port (``infodiffusion_tpu_torch``) still starts
on the card. Phases, each printing one line or a few, any failure raising:

1. device: a CUDA card, or exit non-zero (there is no CPU path); the card's
   name and power limit from nvidia-smi; TF32 off for the f32 phases.
2. build: the hand-written kernels in ``infodiffusion_tpu_torch/csrc``
   compiled with nvcc for sm_90a (build time, registers, spills), and
   warpgroup products in the SASS (cuobjdump) of every Hopper body: HGMMA
   (bf16 wgmma) in each bf16 K3b, K6 and K5 kernel and each bf16 and int8
   K4 kernel, IGMMA (s8) in each int8 conv kernel.
3. kernels: K1 (adagn), K2 (attention) and K4 (latent trajectory) each
   against its plain PyTorch version on the card, at the shapes of the
   flagship CelebA-64 InfoDiff (AuxiliaryUNet ch 64, ch_mult (1,2,2,2),
   attention at level 2, a_dim 256, T 1000), with errors and CUDA-event
   times of both, K2's launch (grid, block, shared memory, body, blocks
   per SM), K4's cluster plan and occupancy and its chain floor (19
   exchanges a step x the exchange round measured on the card); K1's
   launch plan per site (body, ranks, rows, threads, shared memory), each
   K1 call twice (bitwise the same), its CUDA-graph device time and, at
   the K=0 sites, F.group_norm's on the channels_last NCHW view (and the
   kernels it runs); the C entries of K1 and its backward refusing a plan
   not their own; the host us per K1 call (tools/adagn_rate.py); the
   latent sampler at a_dim 20 (f32, B=64) on its "torch" route, no K4 or
   K5 launch, against the CPU's same route, and the a_dim 256 prior on K4
   once a trajectory; then K4's errors at ragged B (1, 100), at a_dim 32
   B=64 and on the DDPM and reverse contracts at S=50 (f32, bf16, int8).
4. the slice, flagship size, bf16, random weights from a numpy seed:
   ``LatentDiffusionProcess.sampling`` (the full T=1000 latent trajectory,
   K4) then ``InfoDiffusionPipeline.generate(steps=100)`` (K1 and K2 in the
   UNet); checks shape, finiteness and that every kernel's launch count
   moved.
5. card against CPU: the same slice in f32 at batch 2 (T=1000 latents,
   then DDIM-10) with the same weights and draws, kernels on the card
   against the plain versions on the CPU.
6. training kernels: the K1 backward at every GroupNorm site of one
   training forward (backbone and Encoder; 64px at B=128 and 128px at
   B=64), with its plan, a bitwise repeat, its device time and, at the K=0
   sites, the event time of the autograd backward of F.group_norm; K3a (flash forward) at N=1024 B=64 (in bf16 with its launch
   plan and device time against SDPA's) and K3b (flash backward) at
   N=1024 B=64, N=256 B=128 and N=64 B=128 on both contracts (the Pallas
   backward's and the dense attention's autodiff, the main path's first),
   each against its plain version in f32 and bf16, with errors and
   CUDA-event times of both; in bf16 K3b's two launches
   (flash_bwd_launch_plan) and its device time on both contracts against
   SDPA's backward.
7. the training slice, bf16, dropout on, random weights from a numpy
   seed: ``create_train_state`` and ``make_train_step`` on the flagship
   InfoDiff (AuxiliaryUNet + Encoder, mmd 0.1, epochs 50) at 64px B=128
   (1 warm-up step, 5 timed) and at 128px B=64 (1 + 3): imgs/s, loss,
   grad norm, peak memory; checks a finite loss, that every parameter in
   the loss has a non-zero gradient and moved, and the launch counts (K3b
   exactly, per contract).
8. card against CPU, training: f32, 128px, B=2, the same weights and
   injected draws, ``deterministic=True``: the loss and every gradient
   leaf, then every parameter after one optimizer step on each device
   from the same (the CPU's) gradients.
9. int8 kernels: the chainless int8 conv (exact on the s32 contract and
   on the route's: scale, bias and a bf16 partial to bf16), K7 v1
   (relative L2, max error, the int8 flips counted through the kernel, at
   most the parent's count) and v2 (bitwise v1) at every distinct
   quantized conv site of one flagship forward at B=128, bf16, and K4's
   int8 weight stream at B=128 d=256 S=1000 (with its cluster plan), each
   against its plain version with CUDA-event times, the card's bound and,
   for the int8 conv, its launch plan, cuDNN's bf16 conv as a yardstick
   and the CUDA-graph device times of both contracts and of cuDNN. K7 per
   site: both bodies' launch plans (qconv_launch_plan: tile, images a
   tile, rows carried, ring, raw rows, weight stages, shared bytes, the
   registers ptxas gave the kernel, which every warpgroup holds), their
   CUDA-graph device times, each body bitwise a second call and K7
   bitwise the chainless int8 conv on K7's own int8 values; beside them
   the tier's default route at the site (the chain materialized,
   quantize_act, the int8 conv: tools/qconv_bench.py's yardstick). Then
   K7's branch-free divides against __fdiv_rn on every float of their
   range and its chain against the exact one on random and special
   values (qconv_chain_check), and the chain floor: the chain's SASS
   instructions an element over the SMs' issue rate.
10. the int8 slice, flagship, bf16, B=128:
   ``LatentDiffusionProcess(turbo='int8').sampling`` then
   ``DiffusionProcess(turbo='int8').sampling(num_steps=100)`` on the
   default route, with ``INFODIFF_ENABLE_FUSED_QCONV=1`` (K7) and with
   ``INFODIFF_QCONV_V2=1`` as well: latents/s, samples/s, the images'
   relative L2 against the bf16 slice from the same xT and a, exact
   launches per route; a torch.profiler breakdown of two default-route
   DDIM steps (device ms by kernel, idle share).
11. card against CPU, int8: f32, B=2, the quant state calibrated once on
   the CPU and carried across; latents T=1000 then DDIM-10 per route.
12. the vanilla / two-phase slice's kernels, each against its plain
   version in f32 and bf16 with CUDA-event times, bound and library time:
   K6 (fused shortcut) at every shortcut site of one flagship InfoDiff
   forward (13) and one vanilla UNet forward (15) at B=64 (in bf16 with
   its launch plan and CUDA-graph device time against torch.addmm's), and
   the host time per shortcut call on both routes at the vanilla sites;
   K5 (one LatentUNet forward) at B=128 d=256 with its cluster plan; K2 at
   C=256 (N=256), C=512 (N=64) and C=64 (N=64 and 256: the mnist and
   chairs InfoDiff), B=64, with its launch; K2' at the C=64 shapes
   (errors; in bf16 also its mean error under a tenth of K2's against w
   unrounded, which a K2' without its lo product would not be).
13. the new paths at full width, bf16, random weights: the flagship
   InfoDiff, the vanilla Diff (UNet ch 64, ch_mult (1,2,4,8), attention at
   level 2) and the VAE (a_dim 256, (1,2,4,8)): two-phase sampling (T=1000,
   split 500, B=32), vanilla DDIM-100 (B=64) on the default and the K6
   route (in turns: default, K6, K6, default; a torch.profiler breakdown of
   two steps of each), InfoDiff DDIM-100 on the K6 route, the pipeline's
   reconstruct
   (encode, 998 reverse steps, DDIM-100, B=32), the latent prior's
   per-forward route (K5, T=1000 sampling + reverse, B=128) and VAE decode
   (B=128, both routes): samples/s and launches per kernel and path, with
   the exact launch counts asserted.
14. card against CPU for those paths: f32, B=2, the same numpy weights,
   inputs and noises, diffusion_steps 20 and split_step 10 (full widths):
   two-phase sampling, InfoDiff reverse sampling, the latent per-forward
   route (sampling and reverse) and VAE decode.
15. high-resolution attention kernels, each against its plain version in
   f32 and bf16 with CUDA-event times, bound and SDPA's time (on the first
   of its flash, memory-efficient and math backends that takes the shape):
   K3c (online forward) at [8,16384,128] (the InfoDiff at 512px),
   [2,16384,256] and [8,4096,512] (the vanilla UNet at 512px) and
   [2,4096,64] (bf16: at the kernel's k tile and at JAX's); K3a at
   [8,4096,128] (the 512px middle block), [32,1024,256], [16,1024,512] and
   [8,1024,64], each bf16 shape with its launch plan (flash_launch_plan)
   and its device time against SDPA's; K3b on both contracts at
   [64,256,256], [64,64,512], [4,16384,128], [4,4096,128], [64,256,64] and
   [64,64,64] and at one ragged N per C ([2,200,64], [2,1000,128],
   [3,200,256], [2,100,512]), each bf16 shape with its launch plan and its
   device time on both contracts against SDPA's backward;
   K2 and K2' at [2,4096,128], beyond the resident strip (two passes); K2'
   (all f32) at [128,256,128] tb=8, its bf16 bound at the bf16 peak with
   its three products (q k^T, PV on w's hi and lo parts); then K1 (B=8 and
   4) and its backward (B=4) at the 512px paths' shapes, timed as in
   phases 3 and 6 (not in the kernels line), and K4 (B=8), errors only.
16. the 512px paths, bf16, random weights: bench.py's InfoDiff at
   INFODIFF_BENCH_SIZE=512 (latents T=1000 then DDIM-100 at B=8; encode
   B=8; make_train_step B=4, 1 + 2 steps), the vanilla Diff and the VAE
   training at 64px (B=64, 1 + 3), the vanilla UNet's DDIM-2 at 256px and
   512px (K3a and K3c at C=256/512), and both attention tools at reduced
   reps: rates, peak memory, exact launch counts per kernel and C (and
   K3b's per contract); each profile also sums K1's family (the adagn
   kernels, forward and backward).
17. card against CPU, f32: the 64px InfoDiff DDIM-10 at B=2 with the
   online route forced (the port's plan limit set in-process), one 512px
   InfoDiff forward at B=1 on the real route, the vanilla Diff's and the
   VAE's loss_and_grads at 64px B=2 per gradient leaf.
18. the InfoDiff at unets_channels 32 as ``with_dataset_config()`` builds
   it for mnist (32px, 1 channel) and chairs (64px), a_dim 32, bf16, random
   weights: its UNet and Encoder attend at C=64 (level 2 N=64 / 256, the
   middle block N=16 / 64, all K2; K3b backward). ``make_train_step``
   (1 + 3 steps) and DDIM-100, B=64; mnist's latent prior with turbo on the
   per-forward route (it warns and samples unquantized through K5), B=64;
   exact launches per kernel at C=64; then the mnist loss and every
   gradient leaf, f32, B=2, card against CPU.
19. the command line: ``python -m infodiffusion_tpu_torch``'s code path
   (``cli.main`` in-process, in a temporary directory) at the flagship's
   full width, bf16, on 512 synthetic celeba images: train -e 1 (4 steps
   at B=128), train -e 2 --resume (4 more), save_latent, train_latent_ddim,
   eval_fid --is_latent (the latent prior, then DDIM-100 at B=128, 128
   PNGs), interpolate and eval at DDIM-10; each mode's wall seconds and
   exact launches per kernel; checks the checkpoints (epoch 2 at step 8),
   the metrics' losses, the [512, 256] f32 latents (the first batch against
   the pipeline's encode on the saved checkpoint), the PNG counts and
   headers, and prints the loader's H2D bytes a batch.
20. the evaluation path, in phase 19's directory on its checkpoint: a
   schema-exact fixture InceptionV3 checkpoint from a numpy seed (it
   stands in for the real weights); the card's clean resize and features
   against the CPU's on 16 images with TF32 turned on globally (the
   extractor pins f32 itself); ``gen_fid_stats`` over 2,560 synthetic
   celeba PNGs; ``eval_fid --is_latent`` at DDIM-10 into 2,560 PNGs;
   ``calc_fid`` over them (FID and KID finite, FID > 0, the real folder
   against its own stats under 1e-3 of it); the seconds of decode, resize,
   forward (images/s), sqrtm and KID; ``attr_classification`` on 512
   images (its results.json) and TAD over phase 19's latents; exact
   launches per stage (the FID stages none).

21. a reference user's path (a trained ``.pth`` and a CelebA folder), at
   the flagship's full width, bf16: the native image library built on the
   card (which branch: libjpeg, else nvJPEG; PNG through zlib) and its
   build seconds; the committed fixtures (``tests/fixtures/celeba_jpeg``,
   178x218 JPEGs) decoded in the three modes against PIL's decode
   (``expected_u8.npz``: mean < 0.5, max <= 2 a pixel); the CMYK and the
   truncated fixture raising an IOError that names the file and PIL, with
   PIL blocked; ``--mode train`` (4 steps at B=128) through the CLI over a
   CelebA-layout folder of 512 JPEGs (the fixtures repeated), the native
   batcher serving every image (images/s of its calls); a reference
   ``.pth`` of a numpy-seeded flagship InfoDiff (with each AuxResBlock's
   dead ``crossattn.*`` keys and the sinusoid table) and of its LatentUNet
   prior; ``from_torch_checkpoint`` on the card, every parameter bitwise
   the source model's; the prior's trajectory then DDIM-100 at B=128,
   bitwise the source models' samples from the same generator;
   ``tools.convert_checkpoint`` .pth -> ``model-50`` for both models, then
   ``examples.generate`` on it (its pixels equal the pipeline's) and
   ``examples.traverse`` over the folder (one dimension); ``eval_fid
   --is_latent``, its PNGs through the native writer; ``CrossAttnBlock`` at
   B=128, N=256, C=128 against its plain path (f32 and bf16); exact
   launches per stage (training, generation and CrossAttnBlock make the
   kernels line's ``reference`` path).

22. the parallel layouts (``parallel/``): first a probe, in two processes
   that share the one card over gloo, of the collectives the two-rank
   checks call, each as the port calls it (all_reduce, list all_gather,
   list reduce_scatter, batch_isend_irecv), on CUDA tensors, its answer on
   a line of its own. Then, always, at world size 1 over
   NCCL (a FileStore rendezvous in this process), the flagship training
   step (64px, B=128, bf16) one-process, data-parallel and FSDP from the
   same weights: losses, grad norms and parameters against the
   one-process step (bitwise where the one-process step repeats itself
   bitwise), and exact launches per kernel of the two laid-out steps (K1
   124, K1-bwd 124, K2 12, K3b 12 on the dense contract, as phase 19
   counts them); ``python -m torch.distributed.run --nproc_per_node 1 -m
   infodiffusion_tpu_torch`` training the mnist recipe with ``--fsdp`` for
   one epoch, then resuming it for a second, with exactly one metrics file
   and one checkpoint per epoch written. Then two ranks on the card, each
   check only where the probe passed every collective it calls: the
   flagship step at B=128 split 64/64, data-parallel and FSDP (which
   splits parameters over the two ranks), against the one-process B=128
   step (losses and grad norm within 2e-3, the gradient within 1e-2
   relative L2), and the 2-way ring at the 512px attention's shape (B=1,
   N=16384, C=128, bf16) against the one-rank route (within 2e-2 of max
   |out|). A check the probe stops claims no result from the card.

23. ``INFODIFF_REMAT=1`` and the measurement tools (``tools/``). The
   remat check at 64px B=128 and 512px B=4, bf16, dropout on, from one set
   of weights: the loss (within 1e-3 relative) and the gradient (within
   1e-2 relative L2, beside the plain step against itself) of the
   remat step against the plain one; then 2 (1) train steps each way with
   their event time and peak memory; launches exactly the plain step's
   plus, for each forward kernel (K1, K2, K3a, K3c), its launches inside
   the ResBlocks once more (the recompute; counted by hooks on the
   blocks). Then every tool at reduced sizes: flops_report (with the
   plain 64px step's rate), memory_report (a typo refused; 64px, its train
   step with remat, the 512px sampler at B=8, DDIM-2), profile_sampler
   (DDIM-2 B=128, bf16 and int8) and profile_train (B=128) with their
   trace summaries, latent_turbo_bench (a_dim 32, 64, 256, B=256,
   T=1000, 5 reps: K4 exactly 21 a stream), pipeline_rehearsal (2,048
   JPEGs), turbo_fid_delta (1 epoch, 256 samples a tier),
   repr_learning_demo (1 epoch), trace_summary on the runner's trace of a
   CLI train under ``INFODIFF_PROFILE`` (the mnist recipe, 21 steps), and
   verify_inception_weights on a fixture (exit 0) and on it with a tensor
   missing (exit 1).

``--only 9,10`` runs phases 1, 2 and the ones listed (no kernels line);
``--only 20`` runs 19 first.

Every time is held to its bound: an event time, or a device time (K1,
K1-bwd, K2, K3a, K3b, K3c, SDPA and F.group_norm, from a CUDA graph of
calls on copies of the inputs that fill the L2 twice over, whose replay
must write every output), below the bound fails.

The line before the last is one JSON object with each kernel's launches
(summed over the counted runs of the main paths, and per path), error,
bf16 times, bound and library yardstick; the last is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.diffusion.samplers import (
    DiffusionProcess,
    LatentDiffusionProcess,
    TwoPhaseDiffusionProcess,
    strided_ddim_loop,
)
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.models.wrappers import Diff, InfoDiff, build_model
from infodiffusion_tpu_torch.nn.blocks import (
    Conv3,
    PieceConv3,
    ShortcutDense,
    _AffineChain,
)
from infodiffusion_tpu_torch.ops import quant as Q
from infodiffusion_tpu_torch.ops.cuda import adagn as K1
from infodiffusion_tpu_torch.ops.cuda import latent_mlp as K5
from infodiffusion_tpu_torch.ops.cuda import latent_traj as K4
from infodiffusion_tpu_torch.ops.cuda import qconv as K7
from infodiffusion_tpu_torch.ops.cuda import shortcut_fused as K6
from infodiffusion_tpu_torch.ops.cuda.adagn import (
    adagn_bwd_cuda,
    adagn_bwd_reference,
    adagn_cuda,
    adagn_plan_on,
    adagn_reference,
)
from infodiffusion_tpu_torch.ops.cuda import flash_attention as K3
from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_cuda,
    attention_plan,
    attention_reference,
    attention_tiled_cuda,
    attention_tiled_reference,
)
from infodiffusion_tpu_torch.ops.cuda.flash_attention import (
    attention_dense_bwd_reference,
    bwd_route,
    flash_attention_bwd_cuda,
    flash_attention_bwd_reference,
    flash_attention_cuda,
    flash_attention_online_cuda,
    flash_attention_online_reference,
    flash_bwd_launch_plan,
    flash_launch_plan,
)
from infodiffusion_tpu_torch.ops.cuda.latent_mlp import pack_latent_unet_params
from infodiffusion_tpu_torch.ops.cuda.library import (
    check_launch,
    library,
    library_path,
    stream_handle,
)
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from infodiffusion_tpu_torch.tools import (
    adagn_rate,
    env_set,
    flash_attn_bench,
    in_directory,
    microbench_attention,
    qconv_bench,
    run_cli,
    time_ms,
)
from infodiffusion_tpu_torch.tools.adagn_rate import films_of
from infodiffusion_tpu_torch.tools.adagn_rate import inputs as adagn_inputs
from infodiffusion_tpu_torch.tools.trace_summary import profile_step
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import (
    loss_and_grads,
    make_train_step,
    step_rngs,
)

A_DIM, T, SIZE = 256, 1000, 64
# bench.py's flagship DDIM-100 batch; the kernels are checked at the
# shapes the end-to-end run gives them
BATCH = 128
# the training runs: (image size, batch, timed steps), bench.py's train
# mode at 64px and at 128px
TRAIN_RUNS = ((64, 128, 5), (128, 64, 3))
LR = 1e-4  # bench.py's learning rate (the first step's, sched(0))
# parameters outside the loss at mmd 0.1, kld 0: zero gradient, and the
# 1e-4 x 1e-5 decay does not move an f32 value
NO_GRAD_PARAMS = {f"encoder.{m}.{p}" for m in ("fc_mu", "fc_var")
                  for p in ("weight", "bias")}
# the kernels of the generation path
GENERATION_KERNELS = ("adagn", "attention", "latent_traj")
# per-leaf comparisons take each leaf's max abs, floored at this share of
# the largest leaf's: some leaves are zero up to f32 noise (the key
# projection's bias under the softmax)
NOISE_FLOOR = 1e-4
# max |kernel - plain| / max |plain|: f32 differs by summation order only;
# bf16 by one rounding of the output (K1) or of the softmax weights (K2);
# K4 compounds the same over 1000 steps
TOL = {"f32": 1e-4, "bf16": 2e-2, "traj_f32": 1e-4, "traj_bf16": 1e-2,
       "slice": 2e-3}
# the int8 tier: the chainless conv is exact in s32; K7 against its plain
# version differs only where an ulp of expf (card) against torch's sigmoid
# lands a value on a .5 boundary and flips one int8 unit (relative L2 and
# max abs over the output's max abs); K4's int8 stream as its bf16 one;
# card against CPU by those flips, compounded over the steps
TOL.update({"int8_conv": 0.0, "qconv_l2": 1e-4, "qconv_max": 1e-2,
            "traj_int8": 1e-2, "slice_int8": 1e-2})
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the card's published peaks (H100 SXM, dense) and memory rate
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM = 3.35e12
# the card's L2 (H100: 50 MB): the device timer's calls rotate through
# copies of their inputs that fill it twice over, so each reads from HBM
L2_BYTES = 50 * 2**20
# K2' in bf16 against K2 on the same inputs, both against K2''s plain
# version (w unrounded): K2' rounds only its output, K2 also w, so K2''s
# mean abs error is ~1/700 of K2's at the phases' shapes (the two
# computed in f64 on the CPU); a K2' without its lo product computes K2's
# function and would read the same as K2
TILED_MEAN_SHARE = 0.1
# DDIM steps of the int8 slice on every route (bench.py's headline)
INT8_STEPS = 100
INT8_ROUTES = {
    "int8_default": {},
    "int8_fused": {"INFODIFF_ENABLE_FUSED_QCONV": "1"},
    "int8_fused_v2": {"INFODIFF_ENABLE_FUSED_QCONV": "1",
                      "INFODIFF_QCONV_V2": "1"},
}
INT8_ROUTE_KERNELS = {
    "int8_default": ("latent_traj_int8", "int8_conv", "adagn", "attention"),
    "int8_fused": ("latent_traj_int8", "qconv", "int8_conv", "adagn",
                   "attention"),
    "int8_fused_v2": ("latent_traj_int8", "qconv_v2", "int8_conv", "adagn",
                      "attention"),
}

# exact launches of one latent run and one DDIM-100 per route: per UNet
# forward 84 int8 convs on the default route; on the fused ones K7 takes
# 66 of them and 6 stay int8 convs; K2 6 a forward; K4's int8 stream once
INT8_LAUNCHES = {
    route: {"int8_conv": n_conv * INT8_STEPS, "qconv": k7 * INT8_STEPS,
            "qconv_v2": k7v2 * INT8_STEPS, "attention": 6 * INT8_STEPS,
            "latent_traj_int8": 1}
    for route, n_conv, k7, k7v2 in (("int8_default", 84, 0, 0),
                                    ("int8_fused", 6, 66, 0),
                                    ("int8_fused_v2", 6, 0, 66))}

KERNELS = {
    "adagn": dict(fn=adagn_cuda, route="cuda",
                  source="infodiffusion_tpu_torch/csrc/adagn.cu",
                  replaces="infodiffusion_tpu/ops/pallas/adagn.py:90"),
    "latent_traj": dict(fn=K4.latent_trajectory_cuda, route="cuda",
                        source="infodiffusion_tpu_torch/csrc/latent_traj.cu",
                        replaces="infodiffusion_tpu/ops/pallas/"
                                 "latent_traj.py:390"),
    "adagn_bwd": dict(fn=adagn_bwd_cuda, route="cuda",
                      source="infodiffusion_tpu_torch/csrc/adagn_bwd.cu",
                      replaces="XLA autodiff of "
                               "infodiffusion_tpu/ops/norm.py:293 (adagn)"),
}
# K2, K3a, K3b and K3c are each one kernel compiled per C: a line per C,
# counted from the wrapper's per-C launch count
_PER_C = {
    "attention": (attention_cuda, "F.scaled_dot_product_attention",
                  "attention.cu",
                  "infodiffusion_tpu/ops/pallas/attention.py:49"),
    "flash_attention": (flash_attention_cuda, "F.scaled_dot_product_attention",
                        "flash_attention.cu",
                        "infodiffusion_tpu/ops/pallas/flash_attention.py:274"),
    "flash_attention_bwd": (
        flash_attention_bwd_cuda, "backward of F.scaled_dot_product_attention",
        "flash_attention_bwd.cu",
        "infodiffusion_tpu/ops/pallas/flash_attention.py:315"),
    "flash_attention_online": (
        flash_attention_online_cuda, "F.scaled_dot_product_attention",
        "flash_attention_online.cu",
        "infodiffusion_tpu/ops/pallas/flash_attention.py:476 "
        "(_online_kernel :424)"),
}
for _name, (_fn, _lib_call, _src, _rep) in _PER_C.items():
    for _c in K3.CHANNELS:
        KERNELS[_name if _c == 128 else f"{_name}_c{_c}"] = dict(
            fn=_fn, route="cuda", library=_lib_call,
            count=lambda fn=_fn, c=_c: fn.launches_by_c[c],
            source=f"infodiffusion_tpu_torch/csrc/{_src}",
            replaces=_rep if _c == 128 else f"{_rep} (C={_c})")
KERNELS.update({
    "attention_tiled": dict(
        fn=attention_tiled_cuda, route="cuda",
        library="F.scaled_dot_product_attention on the f32 upcast",
        source="infodiffusion_tpu_torch/csrc/attention.cu",
        replaces="tools/microbench_attention.py:52 (_tiled_kernel :30)"),
    "qconv": dict(fn=K7.qconv_cuda, route="cuda",
                  source="infodiffusion_tpu_torch/csrc/qconv.cu",
                  replaces="infodiffusion_tpu/ops/pallas/qconv.py:244 "
                           "(_kernel, pallas_call :499)"),
    "qconv_v2": dict(fn=K7.qconv_v2_cuda, route="cuda",
                     source="infodiffusion_tpu_torch/csrc/qconv_v2.cu",
                     replaces="infodiffusion_tpu/ops/pallas/qconv.py:337 "
                              "(_kernel_v2, pallas_call :499)"),
    "int8_conv": dict(fn=K7.int8_conv_cuda, route="cuda",
                      library="F.conv2d in bf16 (cuDNN) at the same shape: "
                              "no PyTorch call computes the int8 conv",
                      # (bound by infodiff_int8_conv in csrc/qconv.cu)
                      source="infodiffusion_tpu_torch/csrc/"
                             "int8_conv_wgmma.cuh",
                      replaces="XLA int8 conv of "
                               "infodiffusion_tpu/ops/quant.py:142 "
                               "(int8_conv)"),
    "latent_traj_int8": dict(
        fn=K4.latent_trajectory_int8_cuda, route="cuda",
        source="infodiffusion_tpu_torch/csrc/latent_traj.cu",
        replaces="infodiffusion_tpu/ops/pallas/latent_traj.py:390 with "
                 ":89 (quantize_packed_weights)"),
    "shortcut_fused": dict(
        fn=K6.shortcut_fused_cuda, route="cuda",
        library="torch.addmm(h + bias, concat(pieces), W) (the bias add "
                "and the concat outside the timed window)",
        source="infodiffusion_tpu_torch/csrc/shortcut_fused.cu",
        replaces="infodiffusion_tpu/ops/pallas/shortcut_fused.py:159"),
    "latent_mlp": dict(
        fn=K5.latent_unet_forward_cuda, route="cuda",
        source="infodiffusion_tpu_torch/csrc/latent_mlp.cu",
        replaces="infodiffusion_tpu/ops/pallas/latent_mlp.py:201"),
})


# K3b's plain version per contract (ops/cuda/flash_attention.py bwd_route:
# 'flash' where JAX runs its Pallas backward, else 'dense')
BWD_PLAIN = {"flash": flash_attention_bwd_reference,
             "dense": attention_dense_bwd_reference}


def contract_key(contract: str) -> str:
    """The launch count of K3b on one contract, beside the kernels'."""
    return f"flash_attention_bwd.{contract}"


def reset_launches():
    for spec in KERNELS.values():
        fn = spec["fn"]
        fn.launches = 0
        if hasattr(fn, "launches_by_c"):
            fn.launches_by_c.update(dict.fromkeys(fn.launches_by_c, 0))
    by_contract = flash_attention_bwd_cuda.launches_by_contract
    by_contract.update(dict.fromkeys(by_contract, 0))


def read_launches():
    counts = {name: spec["count"]() if "count" in spec else spec["fn"].launches
              for name, spec in KERNELS.items()}
    for contract, n in flash_attention_bwd_cuda.launches_by_contract.items():
        counts[contract_key(contract)] = n
    return counts


class Bound:
    """The least time the card could take for a set of calls: per call the
    larger of its operations over the peak rate for their type and its
    bytes (each input read once, each output written once) over the memory
    rate, summed over the calls."""

    def __init__(self):
        self.ms = self.ops_ms = self.bytes_ms = 0.0

    def add(self, ops, nbytes, rate):
        o, b = ops / rate * 1e3, nbytes / HBM * 1e3
        self.ms += max(o, b)
        self.ops_ms += o
        self.bytes_ms += b
        return max(o, b)

    @property
    def by(self):
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, max abs error / max |want|), in f64 on ``got``'s
    device."""
    got = got.detach().double()
    want = want.detach().to(got.device, torch.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values")
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    return time_ms(fn, reps, torch.device("cuda")) / reps


def paired_ms(kernel, plain, reps: int, plain_reps=None):
    """Kernel and plain times taken in turns: plain, kernel, kernel, plain."""
    pr = plain_reps or reps
    p1 = cuda_ms(plain, pr)
    k1, k2 = cuda_ms(kernel, reps), cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, pr)
    return (k1 + k2) / 2, (p1 + p2) / 2


def sdpa_ms(q, k, v, reps, do=None):
    """One PyTorch call computing K2's / K3a's function, the yardstick the
    port never calls: ``F.scaled_dot_product_attention`` (its backward, K3b's
    yardstick, with ``do``) on q, k, v [B, N, C] viewed as one head
    [B, 1, N, C], on the first of its flash, memory-efficient and math
    backends that takes the shape. Returns (ms, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t.unsqueeze(1) for t in (q, k, v))
    if do is None:
        call = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    else:
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        do = do.unsqueeze(1)
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with sdpa_kernel([backend]), warnings.catch_warnings():
            warnings.simplefilter("ignore")  # why a backend declines
            try:
                if do is not None:
                    out = F.scaled_dot_product_attention(q, k, v)
                    call = lambda: torch.autograd.grad(  # noqa: E731
                        out, (q, k, v), do, retain_graph=True)
                ms = cuda_ms(call, reps)
            except RuntimeError:
                continue
        return ms, backend.name.lower()
    raise RuntimeError("no SDPA backend takes the shape")


def at_least(what, ms, bound_ms):
    """``ms``, which raises when it is below ``bound_ms``: no measurement
    of the work can be."""
    if not ms >= bound_ms:
        raise AssertionError(f"{what}: {ms:.5f} ms is below its bound "
                             f"{bound_ms:.5f} ms")
    return ms


def attention_work(B, N, C, e, products=2):
    """(operations, bytes) of softmax(q k^T) v on [B, N, C] of ``e``-byte
    elements: ``products`` [N, N, C] products (q k^T and PV; K2' in bf16
    runs PV twice, on w's hi and lo parts), q, k and v read and the output
    written once."""
    return 2 * products * B * N * N * C, 4 * B * N * C * e


def device_ms(what, fn, args, bound_ms, reps: int = 20):
    """Milliseconds of device time per call of ``fn(*args)``: at least
    ``reps`` calls, on copies of ``args`` that fill the L2 twice over (each
    call reads its inputs from HBM, as the bound assumes), captured in one
    CUDA graph and replayed between CUDA events, so the host's launch cost,
    which the event times above hold where a call is short, drops out.
    Raises where the replay left a call's output unwritten (the outputs
    are set to NaN before it) or off the eager call's, or where the reading
    is below ``bound_ms``. ``fn`` may return a tuple of outputs (K3b's
    dq, dk, dv): each is checked. Integer outputs are set to their type's
    least value instead of NaN."""
    def outputs(x):
        return x if isinstance(x, tuple) else (x,)

    want = [t.float() for t in outputs(fn(*args))]
    nbytes = sum(t.numel() * t.element_size() for t in args)
    copies = max(1, math.ceil(2 * L2_BYTES / nbytes))
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(copies - 1)]
    calls = max(reps, copies)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        outs = [outputs(fn(*sets[i % copies])) for i in range(calls)]
    graph.replay()  # the first replay uploads the graph
    for out in outs:
        for t in out:
            t.fill_(math.nan if t.is_floating_point()
                    else torch.iinfo(t.dtype).min)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    bad = [i for i, out in enumerate(outs)
           if not all(torch.allclose(t.float(), w, rtol=1e-2, atol=1e-2)
                      for t, w in zip(out, want))]
    if bad:
        raise AssertionError(f"{what}: the graph's replay did not write the "
                             f"output of calls {bad[:8]} of {calls} "
                             f"(reading {ms:.5f} ms)")
    del outs, sets, graph
    return at_least(f"{what}, device time", ms, bound_ms)


def k2_device_str(q, k, v) -> str:
    """Device ms of K2 and of SDPA on the same inputs, each held to K2's
    bound at the shape."""
    B, N, C = q.shape
    bound = Bound()
    bound.add(*attention_work(B, N, C, q.element_size()), PEAK["bf16"])
    shape = f"[{B},{N},{C}]"
    k2 = device_ms(f"K2 {shape}", attention_cuda, (q, k, v), bound.ms)
    sdpa = device_ms(f"SDPA {shape}", F.scaled_dot_product_attention,
                     tuple(t.unsqueeze(1) for t in (q, k, v)), bound.ms)
    return (f"device {k2:.4f} ms against SDPA's {sdpa:.4f} ms (bound "
            f"{bound.ms:.4f})")


def check_tiled(q, k, v, tb, tag, results) -> str:
    """K2' against its plain version; in bf16 also its mean abs error
    against that of K2 on the same inputs (``TILED_MEAN_SHARE``)."""
    got = attention_tiled_cuda(q, k, v, tb)
    want = attention_tiled_reference(q, k, v, tb)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(got, want)
    results.record("attention_tiled", tag, abs_e, rel_e, TOL[tag])
    line = f"rel err {rel_e:.2e} (abs {abs_e:.2e})"
    if q.dtype == torch.bfloat16:
        want = want.double()
        mine = (got.double() - want).abs().mean().item()
        k2s = (attention_cuda(q, k, v).double() - want).abs().mean().item()
        if not mine < TILED_MEAN_SHARE * k2s:
            raise AssertionError(
                f"K2' {tag} {tuple(q.shape)}: mean abs error {mine:.3e} "
                f"against w unrounded is not under {TILED_MEAN_SHARE} of "
                f"K2's {k2s:.3e}")
        line += (f"; mean abs error against w unrounded {mine:.2e}, K2's "
                 f"{k2s:.2e}")
    return line


def flash_plan_str(B, N, C) -> str:
    """The bf16 launch of K3a and K3c at [B, N, C] (flash_launch_plan)."""
    p = flash_launch_plan(B, N, C, torch.bfloat16)
    return (f"{p['blocks']} blocks x {p['threads']} threads, BQ {p['bq']} on "
            f"{p['warpgroups']} consumer warpgroups, BK {p['bk']}, "
            f"{p['stages']} stages, {p['smem'] / 1024:.1f} KB")


def flash_device_str(label, kernel, q, k, v, bound_ms, event_ratio) -> str:
    """Device ms of a bf16 K3a / K3c call and of SDPA on the same inputs,
    each held to the bound, and the ratios to SDPA (device, events)."""
    B, N, C = q.shape
    shape = f"[{B},{N},{C}]"
    dev = device_ms(f"{label} {shape}", kernel, (q, k, v), bound_ms)
    sdpa = device_ms(f"SDPA {shape}", F.scaled_dot_product_attention,
                     tuple(t.unsqueeze(1) for t in (q, k, v)), bound_ms)
    return (f"device {dev:.4f} ms against SDPA's {sdpa:.4f} ms ({dev / sdpa:.2f}"
            f"x SDPA; events {event_ratio:.2f}x)")


def bwd_plan_str(B, N, C) -> str:
    """K3b's two bf16 launches at [B, N, C] (flash_bwd_launch_plan)."""
    p = flash_bwd_launch_plan(B, N, C, torch.bfloat16)
    r, c = p["rows"], p["cols"]
    return (f"rows {r['blocks']} blocks x {r['threads']} threads, BQ "
            f"{r['bq']} on {r['warpgroups']} consumer warpgroups, BK "
            f"{r['bk']}, {r['stages']} stages, {r['smem'] / 1024:.1f} KB; "
            f"cols {c['blocks']} x {c['threads']}, {c['bk']} keys on "
            f"{c['warpgroups']}, q tile {c['bq']}, {c['stages']} stages, "
            f"{c['smem'] / 1024:.1f} KB")


def bwd_work(B, N, C, e):
    """(operations, bytes) of the attention backward on [B, N, C] of
    ``e``-byte elements: the logits recomputed, dp, dq, dk and dv (five
    [N, N, C] products); q, k, v, do read and dq, dk, dv written once."""
    return 10 * B * N * N * C, 7 * B * N * C * e


def bwd_device_str(q, k, v, do) -> str:
    """Device ms of bf16 K3b on both contracts and of SDPA's backward on
    the same inputs (its forward and backward in one graph, less its
    forward), each held to the bound."""
    B, N, C = q.shape
    bound = Bound()
    bound.add(*bwd_work(B, N, C, q.element_size()), PEAK["bf16"])
    fwd = Bound()
    fwd.add(*attention_work(B, N, C, q.element_size()), PEAK["bf16"])
    shape = f"[{B},{N},{C}]"
    dev = {c: device_ms(f"K3b {c} {shape}", functools.partial(
        flash_attention_bwd_cuda, contract=c), (q, k, v, do), bound.ms)
        for c in BWD_PLAIN}

    def sdpa_fwd_bwd(q, k, v, do):
        q, k, v = (t.unsqueeze(1).detach().requires_grad_(True)
                   for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v)
        return torch.autograd.grad(out, (q, k, v), do.unsqueeze(1))

    both = device_ms(f"SDPA forward and backward {shape}", sdpa_fwd_bwd,
                     (q, k, v, do), bound.ms)
    only_fwd = device_ms(f"SDPA {shape}", F.scaled_dot_product_attention,
                         tuple(t.unsqueeze(1) for t in (q, k, v)), fwd.ms)
    sdpa = both - only_fwd
    return (f"device dense {dev['dense']:.4f} ms, flash {dev['flash']:.4f} "
            f"ms against SDPA's backward {sdpa:.4f} ms ({both:.4f} with its "
            f"forward; bound {bound.ms:.4f})")


def check_bwd_contracts(label, name, tag, q, k, v, do, reps, results,
                        plain_reps=None):
    """K3b on both contracts against their plain versions, the main path's
    (bwd_route) first; returns (kernel ms, plain ms) of the main path's
    contract and the line's text."""
    B, N, C = q.shape
    route = bwd_route(N, C, q.dtype)
    parts, main = [], None
    for contract in (route, *(c for c in BWD_PLAIN if c != route)):
        plain = BWD_PLAIN[contract]
        got = flash_attention_bwd_cuda(q, k, v, do, contract=contract)
        torch.cuda.synchronize()
        want = plain(q, k, v, do)
        errs = []
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            abs_e, rel_e = rel_err(a, b)
            results.record(name, f"{tag} {contract} {what}", abs_e, rel_e,
                           TOL[tag])
            errs.append(f"{what} {rel_e:.2e}")
        del got, want
        km, pm = paired_ms(
            lambda: flash_attention_bwd_cuda(q, k, v, do, contract=contract),
            lambda: plain(q, k, v, do), reps, plain_reps)
        main = main or (km, pm)
        parts.append(f"{contract}{' (main path)' if contract == route else ''}"
                     f": rel err {', '.join(errs)}; {km:.4f} ms vs plain "
                     f"{pm:.4f} ms")
    if q.dtype == torch.bfloat16:
        parts.append(f"{bwd_plan_str(B, N, C)}; {bwd_device_str(q, k, v, do)}")
    return main[0], main[1], f"[{label}] {tag} B={B} N={N} C={C}: " + "; ".join(
        parts)


def plan_str(B, N, C, dtype, tiled=False) -> str:
    """The launch of K2 (of K2' with ``tiled``) at [B, N, C]: grid, block,
    shared memory, body and resident blocks per SM."""
    p = attention_plan(B, N, C, dtype, tiled)
    return (f"{p['blocks']} blocks x {p['threads']} threads, BQ {p['bq']}, "
            f"{p['smem'] / 1024:.1f} KB, "
            f"{'one-pass strip' if p['strip'] else 'two passes'}, "
            f"{p['per_sm']} per SM")


def init_weights_(model: torch.nn.Module, seed: int,
                  bias_std: float = 0.0) -> torch.nn.Module:
    """Xavier-uniform weights (the tail conv included, so eps is not ~0),
    unit norm scales and biases of std ``bias_std``, all from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                receptive = int(np.prod(p.shape[2:]))
                fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.copy_(torch.from_numpy(
                    rng.uniform(-bound, bound, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.copy_(torch.from_numpy(
                    (bias_std * rng.randn(*p.shape)).astype(np.float32)))
            else:
                p.fill_(1.0)
    return model


def flagship(dtype, device, seed=0):
    cfg = Config(model="diff", dataset="celeba", a_dim=A_DIM,
                 diffusion_steps=T, deterministic=True).with_dataset_config()
    img = InfoDiff(T=T, a_dim=A_DIM, shape=cfg.shape,
                   unets_channels=cfg.unets_channels, dtype=dtype)
    lat = Diff(T=T, shape=cfg.latent_shape, is_latent=True, dtype=dtype)
    init_weights_(img, seed)
    init_weights_(lat, seed + 1)
    return cfg, img.to(device).eval(), lat.to(device).eval()


def train_model(dtype, device, size, seed=0, bias_std=0.0):
    """The flagship InfoDiff as bench.py's train mode builds it (mmd 0.1,
    kld 0, epochs 50) for ``size``-pixel images."""
    model = InfoDiff(T=T, a_dim=A_DIM, shape=(3, size, size),
                     unets_channels=64, encoder_channels=64, mmd_weight=0.1,
                     epochs=50, dtype=dtype)
    return init_weights_(model, seed, bias_std).to(device)


def zero_draws(n, size, device):
    """Injected draws for a deterministic loss at batch ``n``."""
    return dict(t=torch.zeros(n, dtype=torch.long, device=device),
                eps=torch.zeros(n, size, size, 3, device=device),
                reparam_eps=torch.zeros(n, A_DIM, device=device),
                prior_samples=torch.zeros(n, A_DIM, device=device))


# ------------------------------------------------------------------ phases


def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for cuDNN convs and matmuls")
    return smi


def build() -> None:
    t0 = time.perf_counter()
    lib = library()
    lines = lib.build_log.splitlines()
    regs = [int(w) for line in lines if "Used" in line
            for w, nxt in zip(line.split(), line.split()[1:])
            if nxt.startswith("registers")]
    spills, kernel = [], "?"
    for line in lines:
        if "Function properties for" in line:
            kernel = line.split()[-1]  # the mangled name
        elif any(int(n) for n in re.findall(r"(\d+) bytes spill", line)):
            spills.append(f"{kernel}: {line.strip()}")
    print(f"[build] nvcc {lib.build_seconds:.1f} s (load "
          f"{time.perf_counter() - t0:.1f} s); {len(regs)} kernels, max "
          f"{max(regs) if regs else '?'} registers; spills: "
          f"{spills if spills else 'none'}")
    counts = gmma_counts(library_path())
    for what, op, bodies in GMMA_BODIES:
        n = {f: c[op] for f, c in counts.items() if bodies(f)}
        if not n or min(n.values()) == 0:
            raise AssertionError(f"{what} kernels without {op}: {n}")
        print(f"[build] cuobjdump -sass: {op} in all {len(n)} {what} kernels "
              f"({min(n.values())}-{max(n.values())} each)")
    old = [f for f, c in counts.items() if "qconv" in f and c["IMMA"]]
    if old:  # K7 runs on the warpgroup core only: no mma.sync body left
        raise AssertionError(f"K7 kernels with mma.sync (IMMA): {old}")
    print("[build] cuobjdump -sass: no IMMA (mma.sync) in any K7 kernel")


# the warpgroup products each Hopper body must compile to, by kernel name:
# (what, SASS mnemonic, which functions)
GMMA_BODIES = (
    ("bf16 K3b rows", "HGMMA",
     lambda f: f.startswith("_ZN9flash_bwd") and "rows_kernel" in f),
    ("bf16 K3b cols", "HGMMA",
     lambda f: f.startswith("_ZN9flash_bwd") and "cols_kernel" in f),
    ("int8 conv", "IGMMA", lambda f: f.startswith("_ZN10int8_wgmma")),
    ("K7 v1", "IGMMA", lambda f: "qconv_v1_kernel" in f),
    ("K7 v2", "IGMMA", lambda f: "qconv_v2_kernel" in f),
    ("bf16 K6", "HGMMA", lambda f: "shortcut_wgmma_kernel" in f),
    ("bf16 K4", "HGMMA", lambda f: "latent_traj_bf16_kernel" in f),
    ("int8 K4", "HGMMA", lambda f: "latent_traj_int8_kernel" in f),
    ("bf16 K5", "HGMMA", lambda f: "latent_mlp_bf16_kernel" in f),
)


def gmma_counts(lib_path) -> dict:
    """Warpgroup product instructions (HGMMA: bf16 wgmma; IGMMA: s8) and
    s8 mma.sync ones (IMMA) per kernel in the built library's SASS."""
    counts = {}
    for fn, lines in sass_functions(lib_path).items():
        counts[fn] = {op: sum(f" {op}" in line for line in lines)
                      for op in ("HGMMA", "IGMMA", "IMMA")}
    return counts


def sass_functions(lib_path) -> dict:
    """Each kernel's SASS instruction lines in the built library, by
    cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib_path)],
        capture_output=True, text=True, check=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = []
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            funcs[fn].append(line)
    return funcs


def adagn_plan_str(B, hw, c, k, dtype, device, backward=False) -> str:
    """K1's (``backward``: its backward's) launch plan at a site."""
    p = adagn_plan_on(device, B, hw, c, k, dtype, backward=backward)
    where = (f"{p['ranks']} rank{'s' if p['ranks'] > 1 else ''} x "
             f"{p['rows']} rows" if p["body"] == "resident"
             else f"{p['splits']} splits x {p['rows']} rows")
    return (f"{p['body']} {where}, {p['threads']} threads, {p['smem']} B "
            f"shared")


def as_nchw(x):
    """x [B, HW, C] as the channels_last NCHW tensor [B, C, HW, 1] (a
    view) that torch.nn.functional.group_norm takes."""
    return x.permute(0, 2, 1).unsqueeze(-1)


def group_norm_kernels(x, gamma, beta) -> str:
    """The device kernels one ``F.group_norm`` call on the channels_last
    view of x runs (torch.profiler): whether it copies x first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.group_norm(as_nchw(x), 32, gamma, beta)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    return "; ".join(n[:60] for n in names)


def check_adagn(sites, device, reps, results, B=BATCH, line=True):
    """K1 at every (HW, C, K) of ``sites`` at batch ``B``, each against its
    plain version, each twice (bitwise the same); with ``reps``, CUDA-event
    ms of both and in bf16 the plan, the CUDA-graph device ms and, at the
    K=0 sites, F.group_norm's on the channels_last view, summed into the
    kernels line where ``line``. ``reps=0`` checks the errors only."""
    g = torch.Generator(device=device).manual_seed(1)
    for tag, dtype in DTYPES.items():
        ms = plain_ms = dev_ms = gn_ms = gn_dev = k0_ms = k0_dev = 0.0
        last_k0 = None
        bnd = Bound()
        e = torch.finfo(dtype).bits // 8
        for hw, c, k in sites:
            bound = bnd.add(8 * B * hw * c, (2 * B * hw * c + 2 * k * B * c)
                            * e + 8 * c, PEAK["f32"])
            x, gamma, beta, proj = adagn_inputs(B, hw, c, k, g, device, dtype)
            args = (x, 32, gamma, beta, films_of(proj))
            got = adagn_cuda(*args)
            again = adagn_cuda(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"K1 {tag} B={B} HW={hw} C={c} K={k}: "
                                     f"two calls differ")
            abs_e, rel_e = rel_err(got, adagn_reference(*args))
            del got, again
            line_ = (f"[K1 adagn] {tag} B={B} HW={hw} C={c} K={k}: rel err "
                     f"{rel_e:.2e} (abs {abs_e:.2e}), bitwise repeatable; "
                     f"{adagn_plan_str(B, hw, c, k, dtype, device)}")
            if reps:
                km, pm = paired_ms(lambda: adagn_cuda(*args),
                                   lambda: adagn_reference(*args), reps)
                ms, plain_ms = ms + km, plain_ms + pm
                line_ += f"; {km:.4f} ms vs plain {pm:.4f} ms"
            if reps and dtype == torch.bfloat16:
                dm = device_ms(f"K1 HW={hw} C={c} K={k}",
                               lambda x, gm, bt, *pr: adagn_cuda(
                                   x, 32, gm, bt, films_of(pr)),
                               (x, gamma, beta, *proj), bound)
                dev_ms += dm
                line_ += f", device {dm:.4f} ms, bound {bound:.4f} ms"
                if k == 0:
                    gm_, bt_ = gamma.to(dtype), beta.to(dtype)
                    lm = cuda_ms(lambda: F.group_norm(as_nchw(x), 32, gm_,
                                                      bt_), reps)
                    ld = device_ms(f"F.group_norm HW={hw} C={c}",
                                   lambda x, gm, bt: F.group_norm(
                                       as_nchw(x), 32, gm, bt),
                                   (x, gm_, bt_), bound)
                    gn_ms, gn_dev = gn_ms + lm, gn_dev + ld
                    k0_ms, k0_dev = k0_ms + km, k0_dev + dm
                    last_k0 = (x, gamma, beta)
                    line_ += (f"; F.group_norm {lm:.4f} ms, device "
                              f"{ld:.4f} ms")
            print(line_)
            results.record("adagn", tag, abs_e, rel_e, TOL[tag])
            del x, proj, args
        if not reps:
            continue
        dev = f", device {dev_ms:.4f} ms" if dev_ms else ""
        print(f"[K1 adagn] {tag} B={B}: all {len(sites)} sites, one call "
              f"each: {ms:.4f} ms{dev} vs plain {plain_ms:.4f} ms, bound "
              f"{bnd.ms:.4f} ms ({bnd.by})")
        if gn_ms:
            kernels = (f"; its kernels at the last K=0 site: "
                       f"{group_norm_kernels(*last_k0)}" if line else "")
            print(f"[K1 adagn] {tag} B={B}, the K=0 sites: K1 {k0_ms:.4f} ms, "
                  f"device {k0_dev:.4f}; F.group_norm (channels_last NCHW "
                  f"view) {gn_ms:.4f} ms, device {gn_dev:.4f}{kernels}")
        del last_k0
        if line:
            results.time("adagn", tag, ms, plain_ms, bnd)
        torch.cuda.empty_cache()


def check_latent_route(device):
    """The latent sampler where the cluster core does not take a_dim: at
    a_dim 20, f32, B=64, T=1000 it takes the "torch" route (the samplers
    over the model's own forward, as JAX's XLA scan), launches neither K4
    nor K5, and agrees with the CPU's same route, same weights and draws;
    the flagship prior (a_dim 256, bf16) stays on K4, one launch a
    trajectory."""
    d, n = 20, 64
    cfg = Config(a_dim=d, diffusion_steps=T, deterministic=True)
    rng = np.random.RandomState(50)
    xT = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    noises = torch.from_numpy(rng.randn(T, n, d).astype(np.float32))
    outs = {}
    for dev in (device, torch.device("cpu")):
        lat = init_weights_(Diff(T=T, shape=(1, d, d), is_latent=True),
                            60).to(dev)
        proc = LatentDiffusionProcess(cfg, lat)
        if proc.route != "torch":
            raise AssertionError(f"a_dim {d}: route {proc.route}")
        out, dt, launches = timed(lambda: proc.sampling(
            xT=xT.to(dev), noises=noises.to(dev)))
        if dev.type == "cuda":
            expect(f"latent a_dim {d}", launches,
                   {"latent_traj": 0, "latent_mlp": 0})
            rate = n / dt
        outs[dev.type] = out
    if tuple(outs["cuda"].shape) != (n, d):
        raise AssertionError(f"latents {tuple(outs['cuda'].shape)}")
    abs_e, rel_e = rel_err(outs["cuda"], outs["cpu"])
    if not rel_e <= TOL["slice"]:
        raise AssertionError(f"latent a_dim {d}, card vs CPU: {rel_e:.3e}")
    fcfg, _, lat = flagship(torch.bfloat16, device)
    proc = LatentDiffusionProcess(fcfg, lat)
    _, _, launches = timed(lambda: proc.sampling(
        torch.Generator(device=device).manual_seed(51), sampling_number=16))
    expect(f"latent a_dim {A_DIM}", launches, {"latent_traj": 1})
    print(f"[latent route] a_dim {d} f32 B={n} T={T}: route 'torch' "
          f"({rate:.2f} latents/s), no K4 or K5 launch, finite, card vs CPU rel err "
          f"{rel_e:.2e} (abs {abs_e:.2e}, bar {TOL['slice']:.0e}); a_dim "
          f"{A_DIM} bf16: route '{proc.route}', K4 once a trajectory")


def check_foreign_plans(device):
    """The C entries of K1 and its backward refuse a plan that is not their
    own (here: the right one with twice the ranks), launching nothing."""
    lib = library().lib
    B, hw, c = 2, 4096, 64
    x = torch.zeros(B, hw, c, device=device)
    for name, backward, pointers in (("infodiff_adagn", False, 10),
                                     ("infodiff_adagn_bwd", True, 15)):
        plan, _, ints = K1._config(device.index, B, hw, c, 32, 0,
                                   torch.float32, (0,) * 4, 0, backward)
        bad = (ctypes.c_int * len(ints))(*ints)
        bad[15] = 2 * plan["ranks"]  # the config's ranks
        err = getattr(lib, name)(*[x.data_ptr()] * pointers,
                                 ctypes.addressof(bad), stream_handle())
        torch.cuda.synchronize()
        if err == 0:
            raise AssertionError(f"{name} took a plan that is not its own")
    print("[K1 adagn] the C entries refuse a foreign plan (forward and "
          "backward)")


def check_attention(device, reps, results):
    g = torch.Generator(device=device).manual_seed(2)
    for tag, dtype in DTYPES.items():
        ms = plain_ms = lib_ms = 0.0
        bnd = Bound()
        e = torch.finfo(dtype).bits // 8
        for n in (256, 64):
            bound = bnd.add(*attention_work(BATCH, n, 128, e), PEAK[tag])
            q, k, v = (torch.randn(BATCH, n, 128, generator=g,
                                   device=device).to(dtype) for _ in range(3))
            lib_ms += sdpa_ms(q, k, v, reps)[0]
            got = attention_cuda(q, k, v)
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, attention_reference(q, k, v))
            km, pm = paired_ms(lambda: attention_cuda(q, k, v),
                               lambda: attention_reference(q, k, v), reps)
            at_least(f"K2 {tag} N={n}", km, bound)
            ms, plain_ms = ms + km, plain_ms + pm
            dev = (f"; {k2_device_str(q, k, v)}" if dtype == torch.bfloat16
                   else "")
            print(f"[K2 attention] {tag} B={BATCH} N={n} C=128: rel "
                  f"err {rel_e:.2e} (abs {abs_e:.2e}); {km:.4f} ms vs plain "
                  f"{pm:.4f} ms, bound {bound:.4f} ms; "
                  f"{plan_str(BATCH, n, 128, dtype)}{dev}")
            results.record("attention", tag, abs_e, rel_e, TOL[tag])
        print(f"[K2 attention] {tag}: N=256 and 64 once each {ms:.4f} ms, "
              f"plain {plain_ms:.4f}, bound {bnd.ms:.4f} ({bnd.by}), "
              f"F.scaled_dot_product_attention {lib_ms:.4f}")
        results.time("attention", tag, ms, plain_ms, bnd, lib_ms)


def check_latent_traj(lat_models, device, reps, results, B=BATCH):
    """K4 at batch ``B``; ``reps=0`` checks the error only and leaves the
    kernel line's times as they are."""
    g = torch.Generator(device=device).manual_seed(3)
    sched = make_schedule(1e-5, 1e-2, T, device)
    for tag, model in lat_models.items():
        packed = pack_latent_unet_params(model.backbone, A_DIM,
                                         dtype=DTYPES[tag])
        xT = torch.randn(B, A_DIM, generator=g, device=device)
        args = K4.trajectory_inputs(packed, sched, xT, g, deterministic=True)
        got = K4.latent_trajectory_cuda(*args)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, K4.latent_trajectory_reference(*args))
        results.record("latent_traj", tag, abs_e, rel_e, TOL["traj_" + tag])
        plan = latent_plan_str(B, A_DIM, DTYPES[tag], "traj", device)
        if not reps:
            print(f"[K4 latent_traj] {tag} weights, B={B} d={A_DIM} S={T}: "
                  f"rel err {rel_e:.2e} (abs {abs_e:.2e}); {plan}")
            continue
        km, pm = paired_ms(lambda: K4.latent_trajectory_cuda(*args),
                           lambda: K4.latent_trajectory_reference(*args), reps)
        bnd = Bound()
        bnd.add(*latent_traj_work(packed["W"]), PEAK[tag])
        print(f"[K4 latent_traj] {tag} weights, B={BATCH} d={A_DIM} "
              f"S={T}: rel err {rel_e:.2e} (abs {abs_e:.2e}); {km:.2f} ms "
              f"vs plain {pm:.2f} ms, bound {bnd.ms:.3f} ms ({bnd.by}), "
              f"{chain_floor_str(T)}; {plan}")
        results.time("latent_traj", tag, km, pm, bnd)


# the exchanges in series of one latent step: per hidden layer the
# statistics and the hidden slice, then the x slice (csrc/latent_common.cuh)
EXCHANGES_PER_STEP = 2 * 9 + 1


def exchange_us(ranks: int, mode: int) -> float:
    """Microseconds a round of the cluster core's exchange takes in one
    cluster of ``ranks`` blocks (mode 1: st.async of 8 bytes to every peer,
    counted on its mbarrier, as a layer's statistics go; mode 0:
    barrier.cluster), from CUDA events around 1000 and 11000 rounds."""
    ms = []
    for rounds in (1000, 11000):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        err = library().lib.infodiff_cluster_exchange_probe(
            ranks, rounds, mode, stream_handle())
        end.record()
        end.synchronize()
        check_launch(err, "cluster_exchange_probe")
        ms.append(start.elapsed_time(end))
    return (ms[1] - ms[0]) / 10000 * 1e3


def chain_floor_str(steps: int) -> str:
    """K4's chain floor: ``steps`` x EXCHANGES_PER_STEP exchanges in series,
    each at least one exchange round of a 16-block cluster."""
    st, bar = exchange_us(16, 1), exchange_us(16, 0)
    return (f"chain floor {steps * EXCHANGES_PER_STEP * st / 1e3:.3f} ms "
            f"({EXCHANGES_PER_STEP} exchanges a step x {st:.3f} us a "
            f"st.async round, 16 ranks; barrier.cluster {bar:.3f} us)")


def latent_plan_str(B, d, dtype, kernel, device) -> str:
    """A K4 ("traj") or K5 ("mlp") launch's cluster plan beside the card's
    co-scheduling (cudaOccupancyMaxActiveClusters)."""
    p = K5.latent_plan_on(device, B, d, dtype, kernel)
    return (f"plan {p['clusters']} clusters of {p['ranks']} (card: "
            f"{p['max_active_clusters']} active), {p['rows']} rows a group, "
            f"{p['groups']} groups in {p['rounds']} rounds, {p['stages']} "
            f"stages of {p['stage_bytes']} B, {p['smem']} B shared")


def check_latent_traj_shapes(device, results):
    """K4 off the main path's shape, errors only: ragged batches (1, 100),
    the a_dim 32 prior at B=64 (S=T), and the DDPM and reverse contracts at
    S=50, each against its plain version."""
    g = torch.Generator(device=device).manual_seed(13)
    runs = [(B, A_DIM, T, dict(deterministic=True)) for B in (1, 100)]
    runs += [(64, 32, T, dict(deterministic=True))]
    runs += [(BATCH, A_DIM, 50, dict(deterministic=False)),
             (BATCH, A_DIM, 52, dict(deterministic=True, reverse=True))]
    models = {}
    for B, d, steps, kw in runs:
        if d not in models:
            models[d] = init_weights_(Diff(T=T, shape=(1, d, d),
                                           is_latent=True), 40 + d)
        sched = make_schedule(1e-5, 1e-2, steps, device)
        xT = torch.randn(B, d, generator=g, device=device)
        tags = ("f32", "bf16", "int8") if steps < T else ("f32", "bf16")
        for tag in tags:
            wd = torch.bfloat16 if tag == "int8" else DTYPES[tag]
            packed = pack_latent_unet_params(
                models[d].to(device).backbone, d, dtype=wd)
            name = "latent_traj"
            if tag == "int8":
                packed = K4.quantize_packed_weights(packed)
                name = "latent_traj_int8"
            args = K4.trajectory_inputs(packed, sched, xT, g, **kw)
            got = K4.latent_trajectory_cuda(*args)
            torch.cuda.synchronize()
            abs_e, rel_e = rel_err(got, K4.latent_trajectory_reference(*args))
            results.record(name, tag, abs_e, rel_e, TOL["traj_" + tag])
            contract = ("reverse" if kw.get("reverse") else "ddim"
                        if kw["deterministic"] else "ddpm")
            plan = latent_plan_str(B, d, packed["W"].dtype, "traj", device)
            print(f"[K4 latent_traj] {tag} weights, {contract} B={B} d={d} "
                  f"S={args[1].shape[0]}: rel err {rel_e:.2e} (abs "
                  f"{abs_e:.2e}); {plan}")


def latent_w_read(d: int, L: int) -> int:
    """Elements of the packed W [L, 5d, 4d] that K4 and K5 read: layer 0's
    rows for x [d, 4d], layers 1 to L-2 whole [5d, 4d], the last layer's
    eps columns [5d, d]."""
    return d * 4 * d + (L - 2) * 5 * d * 4 * d + 5 * d * d


def latent_traj_work(W):
    """(operations, bytes) of one K4 call at B=BATCH, d=A_DIM, S=T: layer 0
    is [B, d] x [d, 4d], layers 1-8 [B, 5d] x [5d, 4d], layer 9
    [B, 5d] x [5d, d]; it reads those parts of W once, the per-step FiLM
    rows and noise once."""
    B, d, S, L = BATCH, A_DIM, T, W.shape[0]
    ops = 2 * B * S * latent_w_read(d, L)
    nbytes = (latent_w_read(d, L) * W.element_size() + S * L * 4 * d * 4
              + S * B * d * 4 + 2 * B * d * 4 + 4 * L * 4 * d * 4)
    return ops, nbytes


# ------------------------------------------------------- training phases


def loss_sites(size, device):
    """The (HW, C, K) of every GroupNorm site one training forward
    (backbone and Encoder) of the ``size``-pixel InfoDiff hits: those of
    its UNet forward and its encode as well."""
    model = train_model(torch.float32, device, size)
    x = torch.zeros(1, size, size, 3, device=device)
    draws = zero_draws(1, size, device)
    return adagn_rate.gn_sites(model, lambda: model.loss_fn(
        x, deterministic=True, **draws))


def train_sites(device):
    """{size: (batch, sites)} per training run."""
    return {size: (batch, loss_sites(size, device))
            for size, batch, _ in TRAIN_RUNS}


def check_adagn_bwd(sites_by_size, device, reps, results, line=True):
    """The K1 backward at every site, per {size: (batch, sites)}, against
    its plain version, each twice (bitwise the same); with ``reps``,
    CUDA-event ms of both and in bf16 the plan, the CUDA-graph device ms
    and, at the K=0 sites, the event ms of the autograd backward of
    F.group_norm on the channels_last view (its forward and backward less
    its forward), summed into the kernels line where ``line``. ``reps=0``
    checks the errors only."""
    g = torch.Generator(device=device).manual_seed(4)
    names = ("dx", "dgamma", "dbeta")
    for tag, dtype in DTYPES.items():
        ms = plain_ms = dev_ms = gn_ms = k0_ms = k0_dev = 0.0
        n = 0
        bnd = Bound()
        e = torch.finfo(dtype).bits // 8
        for size, (B, sites) in sites_by_size.items():
            for hw, c, k in sites:
                bound = bnd.add(20 * B * hw * c, 3 * B * hw * c * e
                                + 4 * k * B * c * e + 16 * c, PEAK["f32"])
                x, gamma, beta, proj = adagn_inputs(B, hw, c, k, g, device,
                                                    dtype)
                dy = torch.randn(B, hw, c, generator=g, device=device).to(dtype)
                films = films_of(proj)
                _, stats = adagn_cuda(x, 32, gamma, beta, films,
                                      return_stats=True)
                args = (x, dy, 32, gamma, beta, films)
                got = adagn_bwd_cuda(*args, stats)
                again = adagn_bwd_cuda(*args, stats)
                torch.cuda.synchronize()
                flat = lambda r: [*r[:3], *(t for p in r[3] for t in p)]  # noqa: E731
                if not all(torch.equal(a, b) for a, b in zip(flat(got),
                                                             flat(again))):
                    raise AssertionError(f"K1 bwd {tag} {size}px HW={hw} "
                                         f"C={c} K={k}: two calls differ")
                want = adagn_bwd_reference(*args)
                outs = list(zip(names, got[:3], want[:3])) + [
                    (f"d{w}{j}", a, b) for j, (gp, wp) in
                    enumerate(zip(got[3], want[3]))
                    for w, a, b in zip("sb", gp, wp)]
                worst = 0.0
                for what, a, b in outs:
                    abs_e, rel_e = rel_err(a, b)
                    results.record("adagn_bwd", f"{tag} {what}", abs_e, rel_e,
                                   TOL[tag])
                    worst = max(worst, rel_e)
                del got, again, want, outs
                line_ = (f"[K1 bwd] {tag} {size}px B={B} HW={hw} C={c} K={k}: "
                         f"worst rel err {worst:.2e} over dx, dgamma, dbeta, "
                         f"dfilms, bitwise repeatable; "
                         f"{adagn_plan_str(B, hw, c, k, dtype, device, True)}")
                if reps:
                    km, pm = paired_ms(lambda: adagn_bwd_cuda(*args, stats),
                                       lambda: adagn_bwd_reference(*args),
                                       reps)
                    ms, plain_ms, n = ms + km, plain_ms + pm, n + 1
                    line_ += f"; {km:.4f} ms vs plain {pm:.4f} ms"
                if reps and dtype == torch.bfloat16:
                    dm = device_ms(
                        f"K1 bwd {size}px HW={hw} C={c} K={k}",
                        lambda x, dy, st, gm, bt, *pr: adagn_bwd_cuda(
                            x, dy, 32, gm, bt, films_of(pr), st)[:3],
                        (x, dy, stats, gamma, beta, *proj), bound)
                    dev_ms += dm
                    line_ += f", device {dm:.4f} ms, bound {bound:.4f} ms"
                    if k == 0:
                        lm = group_norm_bwd_ms(x, dy, gamma, beta, reps)
                        gn_ms, k0_ms, k0_dev = gn_ms + lm, k0_ms + km, \
                            k0_dev + dm
                        line_ += f"; autograd of F.group_norm {lm:.4f} ms"
                print(line_)
                del x, dy, stats, args, proj, films
            torch.cuda.empty_cache()
        if not reps:
            continue
        dev = f", device {dev_ms:.4f} ms" if dev_ms else ""
        print(f"[K1 bwd] {tag}: all {n} sites, one call each: {ms:.4f} ms"
              f"{dev} vs plain {plain_ms:.4f} ms, bound {bnd.ms:.4f} ms "
              f"({bnd.by})")
        if gn_ms:
            print(f"[K1 bwd] {tag}, the K=0 sites: K1 backward {k0_ms:.4f} "
                  f"ms, device {k0_dev:.4f}; the autograd backward of "
                  f"F.group_norm (channels_last NCHW view) {gn_ms:.4f} ms")
        if line:
            results.time("adagn_bwd", tag, ms, plain_ms, bnd)


def group_norm_bwd_ms(x, dy, gamma, beta, reps) -> float:
    """CUDA-event ms of the backward of F.group_norm on the channels_last
    view of x: its forward and backward through autograd less its forward,
    the yardstick of the K1 backward at a K=0 site."""
    xg = x.detach().requires_grad_(True)
    gm = gamma.to(x.dtype).requires_grad_(True)
    bt = beta.to(x.dtype).requires_grad_(True)
    fwd = lambda: F.group_norm(as_nchw(xg), 32, gm, bt)  # noqa: E731
    both = lambda: torch.autograd.grad(fwd(), (xg, gm, bt),  # noqa: E731
                                       as_nchw(dy))
    f1, b1 = cuda_ms(fwd, reps), cuda_ms(both, reps)
    b2, f2 = cuda_ms(both, reps), cuda_ms(fwd, reps)
    return (b1 + b2 - f1 - f2) / 2


def check_flash(device, reps, results):
    g = torch.Generator(device=device).manual_seed(5)
    for tag, dtype in DTYPES.items():
        B, N = 64, 1024
        q, k, v = (torch.randn(B, N, 128, generator=g, device=device)
                   .to(dtype) for _ in range(3))
        got = flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, attention_reference(q, k, v))
        results.record("flash_attention", tag, abs_e, rel_e, TOL[tag])
        km, pm = paired_ms(lambda: flash_attention_cuda(q, k, v),
                           lambda: attention_reference(q, k, v), reps)
        e = torch.finfo(dtype).bits // 8
        bnd = Bound()
        bnd.add(4 * B * N * N * 128, 4 * B * N * 128 * e, PEAK[tag])
        lib_ms = sdpa_ms(q, k, v, reps)[0]
        results.time("flash_attention", tag, km, pm, bnd, lib_ms)
        gflop = 4 * B * N * N * 128 / 1e9
        dev = (f"; {flash_plan_str(B, N, 128)}; " + flash_device_str(
            "K3a", flash_attention_cuda, q, k, v, bnd.ms, km / lib_ms)
            if dtype == torch.bfloat16 else "")
        print(f"[K3a flash fwd] {tag} B={B} N={N} C=128: rel err {rel_e:.2e} "
              f"(abs {abs_e:.2e}); {km:.4f} ms vs plain {pm:.4f} ms "
              f"({gflop / km:.1f} TFLOP/s counting 4BN^2C), bound "
              f"{bnd.ms:.4f} ms ({bnd.by}), F.scaled_dot_product_attention "
              f"{lib_ms:.4f} ms{dev}")
        ms = plain_ms = lib_ms = 0.0
        bnd = Bound()
        # the 128px level 2 (flash contract) and the 64px sites (dense)
        for B, N in ((64, 1024), (128, 256), (128, 64)):
            q, k, v, do = (torch.randn(B, N, 128, generator=g, device=device)
                           .to(dtype) for _ in range(4))
            bnd.add(*bwd_work(B, N, 128, e), PEAK[tag])
            lib_ms += sdpa_ms(q, k, v, reps, do)[0]
            km, pm, line = check_bwd_contracts(
                "K3b flash bwd", "flash_attention_bwd", tag, q, k, v, do, reps,
                results)
            ms, plain_ms = ms + km, plain_ms + pm
            print(line)
        print(f"[K3b flash bwd] {tag}: the three shapes once each, the main "
              f"path's contract, {ms:.4f} "
              f"ms, plain {plain_ms:.4f}, bound {bnd.ms:.4f} ({bnd.by}), "
              f"F.scaled_dot_product_attention backward {lib_ms:.4f}")
        results.time("flash_attention_bwd", tag, ms, plain_ms, bnd, lib_ms)


def leaf_errors(got: dict, want: dict):
    """Per-leaf max |got - want| over the leaf's max abs, floored at
    NOISE_FLOOR of the largest leaf's; leaves exactly zero in ``want`` must
    be exactly zero in ``got``. Returns {name: relative error}."""
    floor = NOISE_FLOOR * max(w.abs().max().item() for w in want.values())
    errs = {}
    for name, w in want.items():
        a = got[name].double().cpu()
        w = w.double().cpu()
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite values")
        if not w.any():
            if a.any():
                raise AssertionError(f"{name}: zero on the CPU, not on the "
                                     f"card")
            errs[name] = 0.0
            continue
        errs[name] = ((a - w).abs().max() / max(w.abs().max().item(), floor)
                      ).item()
    return errs


def train_run(size, batch, steps, device, smi, model=None, label=None,
              want=None, no_grad=NO_GRAD_PARAMS, profile=False, channels=3,
              contracts=None):
    """Drive ``make_train_step`` on ``model`` (default: the flagship
    InfoDiff for ``size``-pixel images of ``channels`` channels), 1
    warm-up step and ``steps`` timed;
    checks a finite loss, that every parameter but ``no_grad`` has a
    non-zero gradient and moved, and the launch counts of the timed steps
    (exactly ``want`` where given; K3b's per contract exactly
    ``contracts``), which it returns; with ``profile``, then the device's
    share of one more step."""
    if model is None:
        model = train_model(torch.bfloat16, device, size)
    label = label or f"{size}px"
    tx = make_optimizer(LR, 50, 1000)  # bench.py's train mode
    state = create_train_state(model, seed=0, tx=tx)
    step = make_train_step(model, tx)
    x = torch.from_numpy(np.random.RandomState(size).randn(
        batch, size, size, channels).astype(np.float32)).to(device)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, _ = step(state, x, 0)  # warm-up: cuDNN plans, first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, x, 0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{label}: non-finite metrics {metrics}")
    moved = {n for n, p in state.params.items() if not torch.equal(p, before[n])}
    if set(state.params) - moved != no_grad:
        raise AssertionError(f"{label}: parameters that did not move: "
                             f"{sorted(set(state.params) - moved)}")
    del before
    _, _, grads = loss_and_grads(model, x, 0, deterministic=False,
                                 rngs=step_rngs(0, state.step, device))
    zero = {n for (n, _), gr in zip(model.named_parameters(), grads)
            if not gr.any()}
    if zero != no_grad:
        raise AssertionError(f"{label}: zero gradients: {sorted(zero)}")
    del grads
    if want is None:
        needed = ["adagn", "adagn_bwd", "attention", "flash_attention_bwd"]
        if size >= 128:
            needed.append("flash_attention")
        idle = [name for name in needed if launches[name] == 0]
        if idle:
            raise AssertionError(f"{label}: kernels not launched: {idle}")
    else:
        expect(f"train {label}", launches, want)
    if contracts is not None:
        expect(f"train {label}, K3b per contract", launches,
               {contract_key(c): n for c, n in contracts.items()})
    moved_n = {k: v for k, v in launches.items() if v}
    print(f"[train bf16] {label} B={batch}: {steps} steps {dt:.3f} s = "
          f"{batch * steps / dt:.2f} imgs/s (host clock, synchronised; "
          f"{smi}); " + ", ".join(f"{k} {v:.5f}" for k, v in metrics.items())
          + f"; peak memory {peak / 2**30:.2f} GiB; all {len(state.params)} "
          f"parameters but {len(no_grad)} {sorted(no_grad) or ''} have a "
          f"non-zero gradient and moved; launches {moved_n}")
    if profile:
        profile_steps(lambda: step(state, x, 0), f"train {label} B={batch}, "
                      f"one step", smi)
    return launches


def train_card_vs_cpu(device):
    n, size = 2, 128
    rng = np.random.RandomState(50)
    x = torch.from_numpy(rng.randn(n, size, size, 3).astype(np.float32))
    draws = dict(
        t=torch.tensor([3, 700]),
        eps=torch.from_numpy(rng.randn(n, size, size, 3).astype(np.float32)),
        reparam_eps=torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32)),
        prior_samples=torch.from_numpy(
            rng.randn(n, A_DIM).astype(np.float32)),
    )
    outs = {}
    for dev in (torch.device("cpu"), device):
        model = train_model(torch.float32, dev, size, seed=60, bias_std=0.1)
        loss, _, grads = loss_and_grads(
            model, x.to(dev), 0, deterministic=True,
            **{k: v.to(dev) for k, v in draws.items()})
        names = [name for name, _ in model.named_parameters()]
        grads = dict(zip(names, grads))
        # both devices step from the CPU's gradients: AdamW's first step
        # moves each element by about lr whatever its gradient's size, so
        # an element whose gradient is noise would step either way
        source = outs["cpu"][1] if outs else grads
        step_grads = [source[k].to(dev) for k in names]
        tx = make_optimizer(LR, 50, 1000)
        params = dict(model.named_parameters())
        tx.update(params, step_grads, tx.init(params))
        outs[dev.type] = (loss.cpu(), {k: g.cpu() for k, g in grads.items()},
                          {k: p.detach().cpu() for k, p in params.items()})
        del model, grads, params, step_grads
    (loss_g, grads_g, params_g), (loss_c, grads_c, params_c) = (
        outs["cuda"], outs["cpu"])
    _, loss_e = rel_err(loss_g, loss_c)
    g_errs = leaf_errors(grads_g, grads_c)
    p_errs = leaf_errors(params_g, params_c)
    worst = max(loss_e, max(g_errs.values()), max(p_errs.values()))
    g_name = max(g_errs, key=g_errs.get)
    p_name = max(p_errs, key=p_errs.get)
    print(f"[train card vs CPU] f32 {size}px B={n}, injected draws: loss rel "
          f"err {loss_e:.2e}; worst of {len(g_errs)} gradient leaves "
          f"{g_errs[g_name]:.2e} ({g_name}); "
          f"{sum(not grads_c[k].any() for k in grads_c)} leaves exactly zero "
          f"on both; worst parameter after one AdamW step from the same "
          f"gradients {p_errs[p_name]:.2e} ({p_name}) (bar "
          f"{TOL['slice']:.0e} per leaf)")
    if not worst <= TOL["slice"]:
        raise AssertionError(f"train card vs CPU: {worst:.3e} over "
                             f"{TOL['slice']:.0e}")

def train_contracts(size, steps):
    """K3b's launches per contract in ``steps`` training steps of the
    flagship InfoDiff (UNet and Encoder, each 5 level-2 and 1 middle-block
    attention): at 64px every site is below the flash gate (dense); at
    128px level 2 (N = 1024) takes the flash contract, the middle block
    (N = 256) the dense."""
    calls = 2 * (ATTN_LVL + ATTN_MID) * steps
    flash = 2 * ATTN_LVL * steps if size == 128 else 0
    return {"flash": flash, "dense": calls - flash}


# ------------------------------------------------------- the int8 tier


def qconv_sites(model, run):
    """The distinct quantized convs one forward of ``model`` runs, as
    ``(chainless, fused)``: chainless (H, W, C, Cout, stride) of each int8
    conv's input (after the repeat; one per piece of an up block's first
    conv), fused (H, W, piece channels, Cout) of each ResBlock conv, the
    K7 sites."""
    chainless, fused = set(), set()
    handles = []
    for name, mod in model.named_modules():
        if not (isinstance(mod, Conv3) and mod.quantize):
            continue

        def hook(mod, args, resblock=bool(re.search(r"block_\d+\.conv\d$",
                                                      name))):
            _, c, h, w = args[0].shape
            cout = mod.weight.shape[0]
            splits = (list(args[1]) if len(args) > 1 and args[1] is not None
                      else [c])
            if isinstance(mod, PieceConv3):
                for ci in splits:
                    chainless.add((h, w, ci, cout, 1))
            else:
                chainless.add((h * mod.repeat, w * mod.repeat, c, cout,
                               mod.stride))
            if resblock:
                fused.add((h, w, tuple(splits), cout))

        handles.append(mod.register_forward_pre_hook(hook))
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return sorted(chainless), sorted(fused)


def int8_plan_str(B, h, w, c, cout, s) -> str:
    """The int8 conv's launch at one site (int8_conv_launch_plan)."""
    p = K7.int8_conv_launch_plan(B, h, w, K7.int8_conv_cin(c), cout, s)
    tile = (f"{p['ipt']} images of {p['th']}x{p['tw']}" if p["ipt"] > 1
            else f"{p['th']}x{p['tw']}")
    return (f"{p['blocks']} blocks x {p['threads']} threads over "
            f"{p['tiles']} tiles of {tile}, N {p['n']} x {p['nsplit']}, "
            f"weights {'resident' if p['resident'] else 'streamed'} "
            f"({p['stages']} stages of {p['w_stage'] / 1024:.1f} KB), "
            f"{p['smem'] / 1024:.1f} KB")


# ragged (B, H, W, Cin, Cout, stride): odd sizes, Cin padded to 32 or 64,
# Cout off the N tile and off a multiple of 4 (per-channel stores), Cout
# past one N tile (split, streamed weights), Cin past one weight panel
INT8_RAGGED = ((3, 7, 9, 32, 40, 1), (3, 5, 5, 64, 40, 2), (2, 9, 7, 3, 16, 1),
               (2, 6, 11, 160, 300, 2), (1, 20, 150, 96, 24, 1),
               (3, 1, 1, 32, 8, 2), (2, 5, 7, 32, 30, 1), (2, 4, 4, 40, 7, 2))


def int8_conv_inputs(B, h, w, c, cout, s, g, device):
    """Random int8 x [B, h, w, c] and k [3, 3, c, cout], and the route
    contract's f32 scale and bias and bf16 partial."""
    xq = torch.randint(-127, 128, (B, h, w, c), generator=g, device=device,
                       dtype=torch.int8)
    kq = torch.randint(-127, 128, (3, 3, c, cout), generator=g,
                       device=device, dtype=torch.int8)
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    scale = 1e-3 * torch.rand(cout, generator=g, device=device)
    bias = torch.randn(cout, generator=g, device=device)
    partial = torch.randn(B, ho, wo, cout, generator=g, device=device).to(
        torch.bfloat16)
    return xq, kq, scale, bias, partial


def check_int8_contracts(tag, xq, kq, s, scale, bias, partial, results):
    """The int8 conv exact against its plain version on the three
    contracts: s32 out, f32(acc) * scale + bias to bf16, and that with a
    bf16 partial added."""
    bf16 = torch.bfloat16
    want = Q.int8_conv_reference(xq, kq, s)
    for contract, kw in (
            ("s32", {}),
            ("route", dict(scale=scale, bias=bias, out_dtype=bf16)),
            ("partial", dict(scale=scale, bias=bias, partial=partial,
                             out_dtype=bf16))):
        got = K7.int8_conv_cuda(xq, kq, s, **kw)
        torch.cuda.synchronize()
        ref = K7.int8_conv_epilogue(want, **kw) if kw else want
        diff = float((got.double() - ref.double()).abs().max().item())
        results.record("int8_conv", f"{tag} {contract}", diff, diff,
                       TOL["int8_conv"])
        del got, ref


def check_int8_conv(sites, device, reps, results):
    """The chainless int8 conv at every distinct site, B=BATCH, on both
    contracts, each exact against its plain version: s32 out (earlier PRs'
    row), and the route's (``Conv3._int8``: f32(acc) * scale + bias to
    bf16; ``PieceConv3`` also adds a bf16 partial). Per site its plan, the
    CUDA-event times of both contracts beside the plain version's and
    cuDNN's bf16 conv (without and with its bias, bf16 out: no PyTorch
    call computes the int8 conv), and CUDA-graph device times of both
    contracts and of cuDNN's conv without bias (beside s32) and with it
    (beside the route's) on inputs rotated past the L2, each held to its
    bound. Then the ragged shapes (``INT8_RAGGED``), exact on the three
    contracts."""
    g = torch.Generator(device=device).manual_seed(7)
    B = BATCH
    bf16 = torch.bfloat16
    tot = dict.fromkeys(("s32", "route", "plain", "lib", "lib_route",
                         "dev_s32", "dev_route", "dev_lib", "dev_lib_route"),
                        0.0)
    bnd, bnd_route = Bound(), Bound()
    for h, w, c, cout, s in sites:
        xq, kq, scale, bias, partial = int8_conv_inputs(B, h, w, c, cout, s,
                                                        g, device)
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        tag = f"{h}x{w} C{c}->{cout} s{s}"
        check_int8_contracts(tag, xq, kq, s, scale, bias, partial, results)

        def route(xq, kq, scale, bias):
            return K7.int8_conv_cuda(xq, kq, s, scale=scale, bias=bias,
                                     out_dtype=bf16)

        km, pm = paired_ms(lambda: K7.int8_conv_cuda(xq, kq, s),
                           lambda: Q.int8_conv_reference(xq, kq, s), reps, 1)
        rm = cuda_ms(lambda: route(xq, kq, scale, bias), reps)
        xb = torch.randn(B, c, h, w, generator=g, device=device).to(
            bf16).contiguous(memory_format=torch.channels_last)
        wb = torch.randn(cout, c, 3, 3, generator=g, device=device).to(
            bf16).contiguous(memory_format=torch.channels_last)
        bb = bias.to(bf16)
        lm = cuda_ms(lambda: F.conv2d(xb, wb, stride=s, padding=1), reps)
        lrm = cuda_ms(lambda: F.conv2d(xb, wb, bb, stride=s, padding=1),
                      reps)
        ops = 2 * B * ho * wo * 9 * c * cout
        inputs = B * h * w * c + 9 * c * cout
        b_ms = bnd.add(ops, inputs + 4 * B * ho * wo * cout, PEAK["int8"])
        br_ms = bnd_route.add(ops, inputs + 8 * cout + 2 * B * ho * wo * cout,
                              PEAK["int8"])
        at_least(f"int8 conv {tag}", km, b_ms)
        at_least(f"int8 conv {tag} route contract", rm, br_ms)
        dk = device_ms(f"int8 conv {tag}", functools.partial(
            K7.int8_conv_cuda, stride=s), (xq, kq), b_ms)
        dr = device_ms(f"int8 conv {tag} route contract", route,
                       (xq, kq, scale, bias), br_ms)
        dl = device_ms(f"cuDNN bf16 conv {tag}", lambda x, k: F.conv2d(
            x, k, stride=s, padding=1), (xb, wb), 0.0)
        dlr = device_ms(f"cuDNN bf16 conv {tag} + bias", lambda x, k, b:
                        F.conv2d(x, k, b, stride=s, padding=1), (xb, wb, bb),
                        0.0)
        for k, v in (("s32", km), ("route", rm), ("plain", pm), ("lib", lm),
                     ("lib_route", lrm), ("dev_s32", dk), ("dev_route", dr),
                     ("dev_lib", dl), ("dev_lib_route", dlr)):
            tot[k] += v
        print(f"[int8 conv] B={B} {tag}: exact on s32, route and partial "
              f"contracts; {int8_plan_str(B, h, w, c, cout, s)}; s32 "
              f"{km:.4f} ms ({ops / km / 1e9:.1f} TOP/s), route {rm:.4f} ms "
              f"vs plain {pm:.4f} ms, bound s32 {b_ms:.4f} / route "
              f"{br_ms:.4f} ms, cuDNN bf16 conv {lm:.4f} (+ bias {lrm:.4f}) "
              f"ms; device s32 {dk:.4f} against cuDNN's {dl:.4f} ms, route "
              f"{dr:.4f} against cuDNN's with bias {dlr:.4f} ms")
        del xq, kq, xb, wb, partial
    print(f"[int8 conv] all {len(sites)} sites once: s32 {tot['s32']:.4f} "
          f"ms, route {tot['route']:.4f} ms vs plain {tot['plain']:.4f} ms, "
          f"bound s32 {bnd.ms:.4f} ms ({bnd.by}) / route {bnd_route.ms:.4f} "
          f"ms ({bnd_route.by}), cuDNN bf16 conv {tot['lib']:.4f} (+ bias "
          f"{tot['lib_route']:.4f}) ms; device s32 {tot['dev_s32']:.4f} "
          f"against cuDNN's {tot['dev_lib']:.4f} ms, route "
          f"{tot['dev_route']:.4f} against cuDNN's with bias "
          f"{tot['dev_lib_route']:.4f} ms")
    results.time("int8_conv", "bf16", tot["s32"], tot["plain"], bnd,
                 tot["lib"])
    for B, h, w, c, cout, s in INT8_RAGGED:
        tag = f"B={B} {h}x{w} C{c}->{cout} s{s}"
        xq, kq, scale, bias, partial = int8_conv_inputs(B, h, w, c, cout, s,
                                                        g, device)
        check_int8_contracts(tag, xq, kq, s, scale, bias, partial, results)
        print(f"[int8 conv] ragged {tag}: exact on s32, route and partial "
              f"contracts; {int8_plan_str(B, h, w, c, cout, s)}")


def kernel_q(run, pieces, A, Bv, s):
    """The int8 values K7's chain computes, read back through the kernel
    itself: identity weights on the centre tap with the act scales folded
    back out, so each output is its input's int8 value."""
    splits = [p.shape[-1] for p in pieces]
    ctot = sum(splits)
    sc = torch.cat([s[i].expand(c) for i, c in enumerate(splits)])
    ident = torch.zeros(3, 3, ctot, ctot, device=sc.device)
    ident[1, 1] = torch.diag(1.0 / sc)
    kmat, sw = K7._fold_pack(ident, s, splits)
    out = run(pieces, A, Bv, s, kmat, sw, torch.zeros(ctot, device=sc.device),
              torch.float32)
    return torch.round(out).to(torch.int8)


# int8 flips of K7's chain against chain_q at phase 9's inputs (seed 8, the
# flagship's 11 sites at B=128): the count the parent's K7 showed (PR 11's
# phase 9), which K7 may not exceed
PARENT_QCONV_FLIPS = 0


def kernel_registers(pattern: str) -> str:
    """The registers and spills ptxas reported for the kernels whose
    mangled name holds ``pattern`` (the build log)."""
    fn, regs, spills = None, set(), {0}
    for line in library().build_log.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            fn = line.split()[-1]
        elif fn and pattern in fn:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.add(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills.add(int(m.group(1)))
    return (f"{'/'.join(map(str, sorted(regs)))} registers a thread, "
            f"{max(spills)} bytes spilled")


def qconv_plan_str(B, h, w, splits, cout, v2: bool) -> str:
    """K7's launch at one site (qconv_launch_plan), bf16 pieces."""
    p = K7.qconv_launch_plan(B, h, w, sum(splits), cout, torch.bfloat16, v2)
    tile = (f"{p['ipt']} images of {p['th']}x{p['tw']}" if p["ipt"] > 1
            else f"{p['th']}x{p['tw']}")
    raw = (f", raw ring {p['raw_rows']} rows of "
           f"{p['raw_row_bytes'] / 1024:.1f} KB" if p["raw_rows"] else "")
    return (f"{p['blocks']} blocks x {p['threads']} threads over "
            f"{p['walks']} walks of {p['rps']} tiles of {tile} "
            f"({p['carry']} rows carried), Cout in {p['npass']} N tiles of "
            f"{p['n']}, window ring {p['ring']} rows{raw}, weights "
            f"{'resident' if p['resident'] else 'streamed'} ({p['stages']} "
            f"stages of {p['w_stage'] / 1024:.1f} KB), "
            f"{p['smem'] / 1024:.1f} KB")


def chain_floor_ms(elements: int) -> str:
    """K7's chain floor: its SASS instructions an element on the fast path
    (the chain8 probe kernel's instructions to its first EXIT, less the
    copy kernel's, over its eight elements) times ``elements`` over the
    SMs' issue rate (132 SMs x 4 schedulers x 32 lanes) at the card's
    maximum SM clock."""
    counts = {}
    for fn, lines in sass_functions(library_path()).items():
        if "chain8_kernel" in fn:
            n = next((i + 1 for i, ln in enumerate(lines) if " EXIT" in ln),
                     len(lines))
            counts["Lb1E" in fn] = n
    per = (counts[True] - counts[False]) / 8
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    ms = per * elements / (132 * 128 * mhz * 1e6) * 1e3
    return (f"chain floor {ms:.4f} ms ({per:.1f} SASS instructions an element "
            f"on the fast path x {elements / 1e6:.1f} M elements over 132 "
            f"SMs x 128 lanes at {mhz:.0f} MHz)")


def check_qconv_chain(s_values, device):
    """K7's branch-free divides against __fdiv_rn on every float of their
    range (1 / d for d in [1, 2^60); a / s for |a| in [2^-60, 2^60) at the
    scales ``s_values``) and its chain against the exact one on random and
    special values: raises on any mismatching bit."""
    bad = {"1/d": K7.qconv_chain_check(0, 1.0)}
    for s in s_values:
        bad[f"a/{s:.6g}"] = K7.qconv_chain_check(1, s)
    g = torch.Generator(device=device).manual_seed(3)
    x = 3 * torch.randn(1 << 22, generator=g, device=device)
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1e-40,
                            -1e-40, 1e30, -1e30, 88.0, -88.0, 87.4, -87.4,
                            3e38, -3e38, 1e-20], device=device)
    x[:special.numel() * 64] = special.repeat(64)
    ab = torch.cat([1.0 + 0.1 * torch.randn(8, generator=g, device=device),
                    0.1 * torch.randn(8, generator=g, device=device)])
    for s in (0.01, 1e-35, 1e25):
        bad[f"chain s={s:g}"] = K7.qconv_chain_check(2, s, x, ab)
    if any(bad.values()):
        raise AssertionError(f"K7's chain differs from its exact form: {bad}")
    print(f"[K7 qconv] fast divides bit for bit __fdiv_rn on every float of "
          f"their range (1/d; a/s at {len(s_values)} scales) and the chain "
          f"the exact one on {x.numel()} random and special values at 3 "
          f"scales: 0 mismatches")


def check_qconv(sites, device, reps, results):
    """K7 v1 and v2 at every ResBlock conv site, B=BATCH, bf16 pieces:
    v1 against the plain version (relative L2, max abs over max abs, the
    int8 flips counted through the kernel, at most the parent's), v2
    bitwise v1, each body bitwise a second call, K7 bitwise the chainless
    int8 conv on its own int8 values; both bodies' plans and CUDA-event
    and CUDA-graph device times beside the bound and the tier's default
    route at the site; then the chain's exactness and floor."""
    g = torch.Generator(device=device).manual_seed(8)
    B = BATCH
    f32 = torch.float32
    tot = dict.fromkeys(("v1", "v2", "plain", "dev1", "dev2", "route",
                         "dev_route"), 0.0)
    flips = total = 0
    scales = set()
    bnd = Bound()
    regs = {v2: kernel_registers("qconv_v2_kernel" if v2 else
                                 "qconv_v1_kernel") for v2 in (False, True)}
    for h, w, splits, cout in sites:
        ctot = sum(splits)
        pieces = [(0.5 * torch.randn(B, h, w, c, generator=g, device=device)
                   ).to(torch.bfloat16) for c in splits]
        A = 1.0 + 0.1 * torch.randn(B, ctot, generator=g, device=device)
        Bv = 0.1 * torch.randn(B, ctot, generator=g, device=device)
        absmax = torch.stack([p.float().abs().amax() * 1.2 for p in pieces])
        kernel = 0.2 * torch.randn(3, 3, ctot, cout, generator=g,
                                   device=device)
        bias = 0.1 * torch.randn(cout, generator=g, device=device)
        s_act = Q.act_scale(absmax)
        scales.update(float(v) for v in s_act)
        kmat, sw = K7._fold_pack(kernel, s_act, list(splits))
        args = (pieces, A, Bv, s_act, kmat, sw, bias)
        got = K7.qconv_cuda(*args, f32)
        got2 = K7.qconv_v2_cuda(*args, f32)
        again = (K7.qconv_cuda(*args, f32), K7.qconv_v2_cuda(*args, f32))
        torch.cuda.synchronize()
        want = K7.qconv_reference(pieces, A, Bv, absmax, kernel, bias, f32)
        l2 = ((got.double() - want.double()).norm()
              / want.double().norm()).item()
        abs_e, rel_e = rel_err(got, want)
        tag = f"{h}x{w} {list(splits)}->{cout}"
        if not l2 <= TOL["qconv_l2"]:
            raise AssertionError(f"qconv {tag}: relative L2 {l2:.3e} over "
                                 f"{TOL['qconv_l2']:.0e}")
        results.record("qconv", tag, abs_e, rel_e, TOL["qconv_max"])
        if not torch.equal(got, got2):
            raise AssertionError(f"qconv_v2 {tag}: not bitwise equal to v1")
        if not (torch.equal(got, again[0]) and torch.equal(got2, again[1])):
            raise AssertionError(f"qconv {tag}: a second call differs")
        results.record("qconv_v2", tag, abs_e, rel_e, TOL["qconv_max"])
        q_k = kernel_q(K7.qconv_cuda, pieces, A, Bv, s_act)
        kq = kmat.view(3, ctot, 3, cout).permute(2, 0, 1, 3).contiguous()
        if not torch.equal(got, K7.int8_conv_cuda(q_k, kq, 1, scale=sw,
                                                  bias=bias, out_dtype=f32)):
            raise AssertionError(f"qconv {tag}: not bitwise the chainless "
                                 f"int8 conv on its own int8 values")
        q_p = K7.chain_q(pieces, A, Bv, s_act)
        n_flip = int((q_k != q_p).sum())
        flips, total = flips + n_flip, total + q_p.numel()
        del got, got2, again, want, q_p, q_k, kq
        plain = lambda: K7.qconv_reference(pieces, A, Bv, absmax, kernel,
                                           bias)
        k1, pm = paired_ms(lambda: K7.qconv_cuda(*args), plain, reps, 1)
        k2 = cuda_ms(lambda: K7.qconv_v2_cuda(*args), reps)
        route = qconv_bench.default_route(absmax, kernel, bias, splits)
        rm = cuda_ms(lambda: route(pieces, A, Bv), reps)
        ops = 2 * B * h * w * 9 * ctot * cout
        b_ms = bnd.add(ops, B * h * w * (2 * ctot + 2 * cout) + 8 * B * ctot
                       + 9 * ctot * cout + 8 * cout, PEAK["int8"])
        at_least(f"K7 v1 B={B}", k1, b_ms)
        at_least(f"K7 v2 B={B}", k2, b_ms)
        n = len(pieces)

        def body(run):
            return lambda *t: run(list(t[:n]), t[n], t[n + 1], s_act, kmat,
                                  sw, bias)

        d1 = device_ms(f"K7 v1 {tag}", body(K7.qconv_cuda), (*pieces, A, Bv),
                       b_ms)
        d2 = device_ms(f"K7 v2 {tag}", body(K7.qconv_v2_cuda),
                       (*pieces, A, Bv), b_ms)
        dr = device_ms(f"default route {tag}", lambda *t: route(
            list(t[:n]), t[n], t[n + 1]), (*pieces, A, Bv), 0.0)
        for k, v in (("v1", k1), ("v2", k2), ("plain", pm), ("dev1", d1),
                     ("dev2", d2), ("route", rm), ("dev_route", dr)):
            tot[k] += v
        print(f"[K7 qconv] B={B} {tag}: rel L2 {l2:.2e}, max abs {rel_e:.2e} "
              f"of max; int8 flips {n_flip} of {B * h * w * ctot}; v2 == v1 "
              f"bitwise, each a second call's, K7 the chainless conv's on its "
              f"own int8 values; v1 "
              f"{qconv_plan_str(B, h, w, splits, cout, False)}; v2 "
              f"{qconv_plan_str(B, h, w, splits, cout, True)}; bf16 out: v1 "
              f"{k1:.4f} ms ({ops / k1 / 1e9:.1f} TOP/s), v2 {k2:.4f} ms, "
              f"plain {pm:.4f} ms, bound {b_ms:.4f} ms, default route "
              f"{rm:.4f} ms; device v1 {d1:.4f}, v2 {d2:.4f}, default route "
              f"{dr:.4f} ms")
        del pieces, args
    if flips > PARENT_QCONV_FLIPS:
        raise AssertionError(f"K7: {flips} int8 flips against chain_q, the "
                             f"parent's K7 {PARENT_QCONV_FLIPS}")
    print(f"[K7 qconv] all {len(sites)} sites once: v1 {tot['v1']:.4f} ms, "
          f"v2 {tot['v2']:.4f} ms, plain {tot['plain']:.4f} ms, bound "
          f"{bnd.ms:.4f} ms ({bnd.by}), default route {tot['route']:.4f} ms; "
          f"device v1 {tot['dev1']:.4f}, v2 {tot['dev2']:.4f}, default route "
          f"{tot['dev_route']:.4f} ms; int8 flips {flips} of {total} "
          f"({flips / max(total, 1):.2e}; the parent's {PARENT_QCONV_FLIPS}); "
          f"kernels: v1 {regs[False]}, v2 {regs[True]} (ptxas compiles every "
          f"warpgroup to the launch's share)")
    check_qconv_chain(sorted(scales), device)
    print(f"[K7 qconv] {chain_floor_ms(total)}")
    results.time("qconv", "bf16", tot["v1"], tot["plain"], bnd)
    results.time("qconv_v2", "bf16", tot["v2"], tot["plain"], bnd)


def check_latent_traj_int8(lat, device, results):
    g = torch.Generator(device=device).manual_seed(9)
    sched = make_schedule(1e-5, 1e-2, T, device)
    packed = K4.quantize_packed_weights(
        pack_latent_unet_params(lat.backbone, A_DIM, dtype=torch.bfloat16))
    xT = torch.randn(BATCH, A_DIM, generator=g, device=device)
    args = K4.trajectory_inputs(packed, sched, xT, g, deterministic=True)
    got = K4.latent_trajectory_int8_cuda(*args)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(got, K4.latent_trajectory_reference(*args))
    km, pm = paired_ms(lambda: K4.latent_trajectory_int8_cuda(*args),
                       lambda: K4.latent_trajectory_reference(*args), 1)
    bnd = Bound()
    bnd.add(*latent_traj_work(packed["W"]), PEAK["bf16"])
    print(f"[K4 latent_traj] int8 weights, B={BATCH} d={A_DIM} S={T}: rel "
          f"err {rel_e:.2e} (abs {abs_e:.2e}); {km:.2f} ms vs plain "
          f"{pm:.2f} ms, bound {bnd.ms:.3f} ms ({bnd.by}); "
          f"{latent_plan_str(BATCH, A_DIM, torch.int8, 'traj', device)}")
    results.record("latent_traj_int8", "int8", abs_e, rel_e,
                   TOL["traj_int8"])
    results.time("latent_traj_int8", "bf16", km, pm, bnd)


def rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).norm() / want.norm()).item()


def int8_slice(device, smi):
    """The int8 tier at the flagship's width, bf16, B=BATCH: the latent
    prior with the int8 weight stream, then DDIM through the W8A8 UNet,
    once per route. Returns each route's launch counts."""
    cfg, img, lat = flagship(torch.bfloat16, device)
    gen = torch.Generator(device=device)
    latent = LatentDiffusionProcess(cfg, lat, turbo="int8")
    plain = DiffusionProcess(cfg, img)
    t0 = time.perf_counter()
    turbo = DiffusionProcess(cfg, img, turbo="int8")
    torch.cuda.synchronize()
    print(f"[int8 slice] calibration (one B=32 forward): "
          f"{time.perf_counter() - t0:.3f} s, {len(turbo.quant)} entries")
    xT = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen.manual_seed(13),
                     device=device)
    lat_xT = torch.randn((BATCH, A_DIM), generator=gen.manual_seed(14),
                         device=device)
    a = latent.sampling(xT=lat_xT, generator=gen.manual_seed(15))
    steps = INT8_STEPS
    ref = plain.sampling(xT=xT, a=a, num_steps=steps).float()
    by_route = {}
    for route, env in INT8_ROUTES.items():
        with env_set(env):
            turbo.sampling(xT=xT, a=a, num_steps=2)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            lats = latent.sampling(gen.manual_seed(16), sampling_number=BATCH)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            images = turbo.sampling(xT=xT, a=a, num_steps=steps).float()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            launches = read_launches()
            if route == "int8_default":  # where its device time goes
                profile_steps(lambda: turbo.sampling(xT=xT, a=a, num_steps=2),
                              f"int8 default DDIM, 2 steps, B={BATCH}", smi,
                              top=8)
        if tuple(images.shape) != (BATCH, SIZE, SIZE, 3):
            raise AssertionError(f"{route}: images {tuple(images.shape)}")
        if not (torch.isfinite(images).all() and torch.isfinite(lats).all()):
            raise AssertionError(f"{route}: non-finite output")
        idle = [k for k in INT8_ROUTE_KERNELS[route] if launches[k] == 0]
        if idle:
            raise AssertionError(f"{route}: kernels not launched: {idle}")
        expect(route, launches, INT8_LAUNCHES[route])
        moved = {k: v for k, v in launches.items() if v}
        print(f"[int8 slice] {route} B={BATCH}: latents (T={T}, int8 "
              f"weights) {t1 - t0:.3f} s = {BATCH / (t1 - t0):.2f} latents/s; "
              f"DDIM-{steps} 64px {t2 - t1:.3f} s = "
              f"{BATCH / (t2 - t1):.2f} samples/s (host clock, synchronised; "
              f"{smi}); images rel L2 against the bf16 slice from the same "
              f"xT and a: {rel_l2(images, ref):.4f}; launches "
              f"{moved}")
        by_route[route] = launches
        del images, lats
    return by_route


def _to(args, dev):
    """A conv's recorded arguments on ``dev`` (tensors, chains, splits)."""
    out = []
    for a in args:
        if isinstance(a, _AffineChain):
            a = _AffineChain(tuple(p.to(dev) for p in a.pieces), a.A.to(dev),
                             a.B.to(dev))
        elif isinstance(a, torch.Tensor):
            a = a.to(dev)
        out.append(a)
    return out


def int8_card_vs_cpu(device):
    """The int8 tier on the card against the CPU: f32, B=2, the same
    weights, the same quant state (calibrated once on the CPU, carried
    across), TF32 off. Latents T=1000 with the int8 stream; then every
    quantized conv of the first DDIM forward on each route, fed on the card
    the very inputs it had on the CPU; then DDIM-10 run free on each route,
    beside the CPU's own spread under a 1e-6 change of xT."""
    n = 2
    rng = np.random.RandomState(40)
    lat_xT = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    noises = torch.from_numpy(rng.randn(T, n, A_DIM).astype(np.float32))
    img_xT = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    nudge = 1.0 + 1e-6 * torch.from_numpy(
        rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    cx = torch.from_numpy(rng.randn(8, SIZE, SIZE, 3).astype(np.float32))
    ca = torch.from_numpy(rng.randn(8, A_DIM).astype(np.float32))
    routes = {"int8_default": {},
              "int8_fused": {"INFODIFF_FORCE_FUSED_QCONV": "1"},
              "int8_fused_v2": {"INFODIFF_FORCE_FUSED_QCONV": "1",
                                "INFODIFF_QCONV_V2": "1"}}
    cpu_route = lambda r: "int8_fused" if r == "int8_fused_v2" else r  # noqa
    quant = None
    outs, sites = {}, {}
    for dev in (torch.device("cpu"), device):
        cfg, img, lat = flagship(torch.float32, dev, seed=30)
        if quant is None:
            Q.calibrate(img, (SIZE, SIZE, 3), a_dim=A_DIM, T=T, x=cx, a=ca)
            quant = Q.quant_state(img)
        else:
            Q.load_quant_state(img, quant)
        latents = LatentDiffusionProcess(cfg, lat, turbo="int8").sampling(
            xT=lat_xT.to(dev), noises=noises.to(dev))
        sched = make_schedule(1e-5, 1e-2, T, dev)
        outs[(dev.type, "latents")] = latents.cpu()
        convs = {name: mod for name, mod in img.named_modules()
                 if isinstance(mod, Conv3) and mod.quantize}
        for route, env in routes.items():
            if dev.type == "cpu" and route == "int8_fused_v2":
                continue  # v2 is a schedule of the card's kernel
            handles = []
            if dev.type == "cpu":  # record each conv's first call
                for name, mod in convs.items():
                    def record(mod, args, out, key=(route, name)):
                        if key not in sites:
                            sites[key] = (_to(args, "cpu"), out.cpu())
                    handles.append(mod.register_forward_hook(record))
            with env_set(env), torch.no_grad():
                y = strided_ddim_loop(img, sched, img_xT.to(dev), None,
                                      latents, num_steps=10)
                outs[(dev.type, route)] = y.cpu()
                if dev.type == "cpu" and route == "int8_default":
                    outs["nudged"] = strided_ddim_loop(
                        img, sched, img_xT * nudge, None, latents,
                        num_steps=10)
                if dev.type != "cpu":
                    worst = (0.0, "")
                    for (r, name), (args, want) in sites.items():
                        if r != cpu_route(route):
                            continue
                        got = convs[name](*_to(args, dev))
                        worst = max(worst, (rel_err(got, want)[1], name))
                    outs[("layers", route)] = worst
            for h in handles:
                h.remove()
        del img, lat
    _, lat_e = rel_err(outs[("cuda", "latents")], outs[("cpu", "latents")])
    layer_e = max(outs[("layers", r)][0] for r in routes)
    per_layer = "; ".join(
        f"{r} worst {outs[('layers', r)][0]:.2e} ({outs[('layers', r)][1]})"
        for r in routes)
    free = "; ".join(
        f"{r} {rel_l2(outs[('cuda', r)], outs[('cpu', cpu_route(r))]):.2e}"
        for r in routes)
    floor = rel_l2(outs["nudged"], outs[("cpu", "int8_default")])
    n_sites = sum(1 for r, _ in sites if r == "int8_default")
    print(f"[int8 card vs CPU] f32 B={n}, the quant state calibrated on the "
          f"CPU and carried across: latents T={T} (int8 stream) max abs "
          f"error over max abs {lat_e:.2e}; each of the {n_sites} quantized "
          f"convs of the first DDIM forward fed the CPU's inputs, max abs "
          f"error over max abs: {per_layer} (bar {TOL['slice_int8']:.0e}: "
          f"an f32 ulp can flip an int8 unit). DDIM-10 run free, relative "
          f"L2 card vs CPU: {free}; the CPU against itself with xT changed "
          f"by 1e-6: {floor:.2e} (no bar: int8 rounding carries an ulp-level "
          f"difference into a whole int8 unit, and the flips spread through "
          f"the later layers and steps)")
    for what, e in (("latents", lat_e), ("quantized convs", layer_e)):
        if not e <= TOL["slice_int8"]:
            raise AssertionError(f"int8 card vs CPU {what}: {e:.3e} over "
                                 f"{TOL['slice_int8']:.0e}")

# ------------------------------------- the vanilla / two-phase / VAE slice

# the vanilla / VAE widths: ch 64, pick_ch_mult('vanilla' | 'vae', 64)
SLICE_BATCH = {"two_phase": 32, "ddim": 64, "reconstruct": 32, "latent": 128,
               "vae": 128, "kernels": 64}
DDIM_STEPS = 100
SPLIT_STEP = 500
# phase 14's depth cut (the widths stay full)
SMALL_T, SMALL_SPLIT = 20, 10
K6_ROUTE = {"INFODIFF_ENABLE_FUSED_SHORTCUT": "1"}
K5_ROUTE = {"INFODIFF_ENABLE_FUSED_LATENT": "1"}


def slice_cfg(model: str, **kw) -> Config:
    kw = {"diffusion_steps": T, "deterministic": True,
          "split_step": SPLIT_STEP, **kw}
    return Config(model=model, dataset="celeba", a_dim=A_DIM,
                  **kw).with_dataset_config()


def slice_model(model: str, dtype, device, seed=0, **kw):
    """``build_model`` for ``model`` ('diff', 'vanilla' or 'vae') at the
    CelebA-64 widths, xavier weights from a numpy seed."""
    cfg = slice_cfg(model, **kw)
    return cfg, init_weights_(build_model(cfg, dtype=dtype, device=device),
                              seed).eval()


def shortcut_sites(model, run):
    """(H, W, piece channels, N) of every shortcut call that ``run()``, one
    forward of ``model``, makes, in order."""
    sites = []

    def hook(mod, args):
        x, h = args[0], args[1]
        pieces = args[2] if len(args) > 2 and args[2] is not None else [x]
        sites.append((h.shape[2], h.shape[3],
                      tuple(p.shape[1] for p in pieces), h.shape[1]))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, ShortcutDense)]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return sites


def forward_sites(device):
    """{model: shortcut sites of one forward} for the flagship InfoDiff's
    backbone, the vanilla UNet and the VAE's decoder (B=1, f32)."""
    x = torch.zeros(1, SIZE, SIZE, 3, device=device)
    t = torch.zeros(1, dtype=torch.long, device=device)
    a = torch.zeros(1, A_DIM, device=device)
    _, img, _ = flagship(torch.float32, device)
    _, van = slice_model("vanilla", torch.float32, device)
    _, vae = slice_model("vae", torch.float32, device)
    return {"infodiff": shortcut_sites(img, lambda: img(x, t, a)),
            "vanilla": shortcut_sites(van, lambda: van(x, t)),
            "vae_decoder": shortcut_sites(vae, lambda: vae.decode(a))}


def shortcut_plan_str(M, cs, n) -> str:
    """K6's bf16 launch at one site (shortcut_launch_plan)."""
    p = K6.shortcut_launch_plan(M, cs[0], cs[1] if len(cs) > 1 else 0, n,
                                torch.bfloat16)
    w = "resident" if p["resident"] else (
        "streamed by TMA" if p["tma"] else "streamed")
    return (f"{p['blocks']} blocks x {p['threads']} threads over "
            f"{p['tiles']} tiles of 128 rows x {p['nw']} columns, {p['kt']} "
            f"K tiles, W {w}, {p['stages']} stages, "
            f"{p['smem'] / 1024:.1f} KB")


# ragged (rows, piece channels, N): rows off the 128-row tile, K tiles that
# straddle the pieces (c0 % 64 != 0) with W resident and with W streamed
# by cp.async, N off the column tile with W resident, streamed by TMA
K6_RAGGED = ((130, (40, 24), 64), (100, (72, 56), 640), (257, (128, 64), 64),
             (70, (24,), 200), (143, (64, 96), 328), (100, (64,), 384))


def check_shortcut(sites, device, reps, results):
    """K6 at every shortcut site of one InfoDiff and one vanilla UNet
    forward, B=64, against its plain version; times beside torch.addmm over
    the concatenated pieces; in bf16 each site's plan and the CUDA-graph
    device times of K6 and of torch.addmm on inputs rotated past the L2.
    Then the ragged shapes (``K6_RAGGED``) against the plain version."""
    g = torch.Generator(device=device).manual_seed(21)
    B = SLICE_BATCH["kernels"]
    for tag, dtype in DTYPES.items():
        ms = plain_ms = lib_ms = dev_ms = dev_lib = 0.0
        bnd = Bound()
        e = torch.finfo(dtype).bits // 8
        for hh, ww, cs, n in sites:
            M, ctot = B * hh * ww, sum(cs)
            what = f"{hh}x{ww} {list(cs)}->{n}"
            args = shortcut_inputs((B, hh, ww), cs, n, dtype, g, device)
            h, pieces, weight, bias = args
            abs_e, rel_e = check_shortcut_once(f"{tag} {what}", args, results)
            km, pm = paired_ms(lambda: K6.shortcut_fused_cuda(*args),
                               lambda: K6.shortcut_fused_reference(*args),
                               reps)
            cat = torch.cat(pieces, -1).reshape(M, ctot)
            hb = (h.float() + bias).to(dtype).reshape(M, n)
            wt = weight.to(dtype).T
            lm = cuda_ms(lambda: torch.addmm(hb, cat, wt), reps)
            ops = 2 * M * ctot * n
            b_ms = bnd.add(ops, (M * (ctot + 2 * n) + ctot * n) * e + 4 * n,
                           PEAK[tag])
            at_least(f"K6 {tag} {what}", km, b_ms)
            ms, plain_ms, lib_ms = ms + km, plain_ms + pm, lib_ms + lm
            line = (f"[K6 shortcut] {tag} B={B} {what}: rel err {rel_e:.2e} "
                    f"(abs {abs_e:.2e}); {km:.4f} ms vs plain {pm:.4f} ms, "
                    f"bound {b_ms:.4f} ms, torch.addmm {lm:.4f} ms")
            if dtype == torch.bfloat16:
                dk = device_ms(f"K6 {what}", lambda h, w, b, *ps:
                               K6.shortcut_fused_cuda(h, ps, w, b),
                               (h, weight, bias, *pieces), b_ms)
                dl = device_ms(f"torch.addmm {what}", torch.addmm,
                               (hb, cat, wt), b_ms)
                dev_ms, dev_lib = dev_ms + dk, dev_lib + dl
                line += (f"; {shortcut_plan_str(M, cs, n)}; device {dk:.4f} "
                         f"ms against torch.addmm's {dl:.4f}")
            print(line)
            del h, pieces, cat, hb
        dev = (f"; device {dev_ms:.4f} ms against torch.addmm's "
               f"{dev_lib:.4f}" if dtype == torch.bfloat16 else "")
        print(f"[K6 shortcut] {tag}: all {len(sites)} sites once: {ms:.4f} "
              f"ms vs plain {plain_ms:.4f} ms, bound {bnd.ms:.4f} ms "
              f"({bnd.by}), torch.addmm {lib_ms:.4f} ms{dev}")
        results.time("shortcut_fused", tag, ms, plain_ms, bnd, lib_ms)
        for rows, cs, n in K6_RAGGED:
            what = f"ragged {rows} rows {list(cs)}->{n}"
            _, rel_e = check_shortcut_once(
                f"{tag} {what}",
                shortcut_inputs((rows,), cs, n, dtype, g, device), results)
            plan = (f"; {shortcut_plan_str(rows, cs, n)}"
                    if dtype == torch.bfloat16 else "")
            print(f"[K6 shortcut] {tag} {what}: rel err {rel_e:.2e}{plan}")


def shortcut_inputs(lead, cs, n, dtype, g, device):
    """K6's arguments: h [*lead, n] and pieces [*lead, c] in ``dtype``, an
    f32 weight [n, sum(cs)] and bias [n]."""
    h = torch.randn(*lead, n, generator=g, device=device).to(dtype)
    pieces = [torch.randn(*lead, c, generator=g, device=device).to(dtype)
              for c in cs]
    weight = (torch.randn(n, sum(cs), generator=g, device=device)
              / math.sqrt(sum(cs)))
    bias = 0.1 * torch.randn(n, generator=g, device=device)
    return h, pieces, weight, bias


def check_shortcut_once(what, args, results):
    """K6 on ``args`` against its plain version at the dtype's bar; a weight
    in h's dtype (the kernel's other load path: an f32 one it rounds
    itself) must give bitwise the same output. Returns (abs, rel) error."""
    h, pieces, weight, bias = args
    got = K6.shortcut_fused_cuda(*args)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(got, K6.shortcut_fused_reference(*args))
    tag = "bf16" if h.dtype == torch.bfloat16 else "f32"
    results.record("shortcut_fused", what, abs_e, rel_e, TOL[tag])
    if not torch.equal(K6.shortcut_fused_cuda(
            h, pieces, weight.to(h.dtype), bias), got):
        raise AssertionError(f"K6 {what}: a {h.dtype} weight gives another "
                             f"output than f32")
    return abs_e, rel_e


def shortcut_host_us(sites, device, reps=50):
    """Host microseconds per ``ShortcutDense`` call at each of ``sites``,
    bf16, B=2 (small enough that the card keeps ahead of the host, so the
    host clock reads the host's own cost), on the default and the K6 route
    in turns (default, K6, K6, default), beside the per-call weight copy
    an earlier K6 wrapper made (the Flax-layout transpose, cast and made
    contiguous)."""
    bf16, B = torch.bfloat16, 2
    g = torch.Generator(device=device).manual_seed(24)
    calls = []
    for hh, ww, cs, n in sites:
        mod = ShortcutDense(sum(cs), n, bf16).to(device)
        nchw = lambda c: torch.randn(  # noqa: E731
            B, hh, ww, c, generator=g, device=device).to(bf16).permute(
                0, 3, 1, 2)
        pieces = [nchw(c) for c in cs]
        x = torch.cat(pieces, 1) if len(pieces) > 1 else pieces[0]
        calls.append((mod, x, nchw(n), pieces if len(pieces) > 1 else None))

    def per_call_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / (reps * len(calls)) * 1e6

    def shortcuts():
        for mod, x, h, pieces in calls:
            mod(x, h, pieces)

    def copies():
        for mod, *_ in calls:
            mod.weight.T.to(bf16).contiguous()

    us = {"default": [], "k6": []}
    with torch.no_grad():
        for route in ("default", "k6", "k6", "default"):
            with env_set(K6_ROUTE if route == "k6" else {}):
                us[route].append(per_call_us(shortcuts))
        copy_us = per_call_us(copies)
    print(f"[K6 host] bf16 B={B}, {len(calls)} sites, host us per shortcut "
          f"call, in turns: default {us['default'][0]:.2f}, K6 "
          f"{us['k6'][0]:.2f}, K6 {us['k6'][1]:.2f}, default "
          f"{us['default'][1]:.2f}; the earlier wrapper's per-call weight "
          f"transpose copy alone {copy_us:.2f}")


def latent_mlp_work(W):
    """(operations, bytes) of one K5 call at B=BATCH, d=A_DIM: the L layer
    products (as K4's per step) and the L-1 FiLM products [B, d] x [d, 4d]
    (the last layer has none). It reads what those need once: the parts of
    W of ``latent_w_read``, Wc of layers 0 to L-2, the f32 rows (the bias of
    the last layer's d columns; no FiLM bias, gamma or beta there) and x,
    s; it writes out [B, d]."""
    B, d, L = BATCH, A_DIM, W.shape[0]
    w_elems = latent_w_read(d, L) + (L - 1) * d * 4 * d
    ops = 2 * B * w_elems
    rows = (L - 1) * 4 * d * 4 + d
    nbytes = w_elems * W.element_size() + rows * 4 + 3 * B * d * 4
    return ops, nbytes


def check_latent_mlp(lat_models, device, reps, results):
    g = torch.Generator(device=device).manual_seed(22)
    for tag, model in lat_models.items():
        packed = pack_latent_unet_params(model.backbone, A_DIM,
                                         dtype=DTYPES[tag])
        x = torch.randn(BATCH, A_DIM, generator=g, device=device)
        t = torch.randint(0, T, (BATCH,), generator=g, device=device)
        s = K5.silu_time_embedding(packed, t).contiguous()
        args = (x, s, packed["W"], packed["Wc"], packed["B"], packed["Bc"],
                packed["G"], packed["Be"])
        got = K5.latent_unet_forward_cuda(*args)
        torch.cuda.synchronize()
        abs_e, rel_e = rel_err(got, K5.latent_unet_forward_reference(*args))
        km, pm = paired_ms(lambda: K5.latent_unet_forward_cuda(*args),
                           lambda: K5.latent_unet_forward_reference(*args),
                           reps)
        bnd = Bound()
        bnd.add(*latent_mlp_work(packed["W"]), PEAK[tag])
        print(f"[K5 latent_mlp] {tag} weights, B={BATCH} d={A_DIM}, t per "
              f"row: rel err {rel_e:.2e} (abs {abs_e:.2e}); {km:.4f} ms vs "
              f"plain {pm:.4f} ms, bound {bnd.ms:.4f} ms ({bnd.by}); "
              f"{latent_plan_str(BATCH, A_DIM, DTYPES[tag], 'mlp', device)}")
        results.record("latent_mlp", tag, abs_e, rel_e, TOL["traj_" + tag])
        results.time("latent_mlp", tag, km, pm, bnd)


def check_attention_wide(device, reps, results):
    """K2 at the vanilla UNet's and the VAE's C=256 (N=256) and C=512
    (N=64), and at the InfoDiff's C=64 at ch 32 (mnist N=64, chairs N=256,
    the C=64 line their sum), B=64; K2' at the C=64 shapes, errors only."""
    g = torch.Generator(device=device).manual_seed(23)
    B = SLICE_BATCH["kernels"]
    for c, ns in ((256, (256,)), (512, (64,)), (64, (64, 256))):
        name = f"attention_c{c}"
        for tag, dtype in DTYPES.items():
            e = torch.finfo(dtype).bits // 8
            ms = plain_ms = lib_ms = 0.0
            bnd = Bound()
            for n in ns:
                q, k, v = (torch.randn(B, n, c, generator=g, device=device)
                           .to(dtype) for _ in range(3))
                got = attention_cuda(q, k, v)
                torch.cuda.synchronize()
                abs_e, rel_e = rel_err(got, attention_reference(q, k, v))
                results.record(name, tag, abs_e, rel_e, TOL[tag])
                km, pm = paired_ms(lambda: attention_cuda(q, k, v),
                                   lambda: attention_reference(q, k, v), reps)
                lm = sdpa_ms(q, k, v, reps)[0]
                bound = bnd.add(*attention_work(B, n, c, e), PEAK[tag])
                at_least(f"K2 {tag} [{B},{n},{c}]", km, bound)
                ms, plain_ms, lib_ms = ms + km, plain_ms + pm, lib_ms + lm
                dev = (f"; {k2_device_str(q, k, v)}"
                       if dtype == torch.bfloat16 else "")
                print(f"[K2 attention] {tag} B={B} N={n} C={c}: rel err "
                      f"{rel_e:.2e} (abs {abs_e:.2e}); {km:.4f} ms vs plain "
                      f"{pm:.4f} ms, bound {bound:.4f} ms, "
                      f"F.scaled_dot_product_attention {lm:.4f} ms; "
                      f"{plan_str(B, n, c, dtype)}{dev}")
                if c == 64:  # K2' at the same shapes (timed in phase 15)
                    print(f"[K2' tiled] {tag} B={B} N={n} C={c} "
                          f"tb={TILED_TB}: "
                          f"{check_tiled(q, k, v, TILED_TB, tag, results)}")
            results.time(name, tag, ms, plain_ms, bnd, lib_ms)


# phase 15: the high-resolution attention kernels at the shapes of the
# 512px InfoDiff (K3c C=128 at N=16384, K3a at its middle block's N=4096,
# K3b at both in training), the vanilla UNet at 512px (K3c C=256 at level
# 2, C=512 in the middle block), at 128px / 256px (K3a C=256 / 512) and at
# 64px (K3b C=256 / 512); at C=64, K3a and K3c where the ch-32 InfoDiff's
# level 2 would take them (128px N=1024 on K3a, 256px N=4096 with the
# online route) and K3b at the mnist / chairs training shapes (N=64 and
# 256, one line); K2 beyond its resident strip (the two-pass body), and
# K2' at the microbenchmark's first shape
ONLINE_SHAPES = ((8, 16384, 128), (2, 16384, 256), (8, 4096, 512),
                 (2, 4096, 64))
PRIMARY_SHAPES = ((8, 4096, 128), (32, 1024, 256), (16, 1024, 512),
                  (8, 1024, 64))
BWD_SHAPES = ((64, 256, 256), (64, 64, 512), (4, 16384, 128),
              (4, 4096, 128), (64, 256, 64), (64, 64, 64))
# K3b at N no tile divides, one per C (TMA's zero fill and the masks on
# rows and columns past N), on both contracts whichever bwd_route picks
BWD_RAGGED = ((2, 200, 64), (2, 1000, 128), (3, 200, 256), (2, 100, 512))
STREAM_SHAPE = (2, 4096, 128)
TILED_SHAPE, TILED_TB = (128, 256, 128), 8


def kernel_name(base: str, c: int) -> str:
    return base if c == 128 else f"{base}_c{c}"


def check_flash_wide(device, reps, results):
    g = torch.Generator(device=device).manual_seed(25)
    fwd = [("K3c online", "flash_attention_online", flash_attention_online_cuda,
            flash_attention_online_reference, s) for s in ONLINE_SHAPES] + [
        ("K3a flash fwd", "flash_attention", flash_attention_cuda,
         attention_reference, s) for s in PRIMARY_SHAPES] + [
        ("K2 attention, two passes", "attention", attention_cuda,
         attention_reference, STREAM_SHAPE)]
    # the C=128 lines keep phase 3's (K2) and phase 6's (K3a, K3b) times
    keep = {"attention", "flash_attention", "flash_attention_bwd"}
    bf16 = torch.bfloat16
    for tag, dtype in DTYPES.items():
        e = torch.finfo(dtype).bits // 8
        timing = {}  # name -> [ms, plain ms, Bound, library ms], summed

        def add_time(name, km, pm, work, lm):
            t = timing.setdefault(name, [0.0, 0.0, Bound(), 0.0])
            t[0], t[1], t[3] = t[0] + km, t[1] + pm, t[3] + lm
            return t[2].add(*work, PEAK[tag])

        for label, base, kernel, plain, (B, N, C) in fwd:
            name = kernel_name(base, C)
            q, k, v = (torch.randn(B, N, C, generator=g, device=device)
                       .to(dtype) for _ in range(3))
            got = kernel(q, k, v)
            torch.cuda.synchronize()
            jax_tiles = ""
            if kernel is flash_attention_online_cuda and dtype == bf16:
                # held at the kernel's own k tile; against JAX's tiles at
                # the same bar, where p's rounding differs
                bk = flash_launch_plan(B, N, C, dtype)["bk"]
                abs_e, rel_e = rel_err(got, plain(q, k, v))
                results.record(name, f"{tag} JAX's tiles", abs_e, rel_e,
                               TOL[tag])
                jax_tiles = f"; against JAX's k tiles {rel_e:.2e}"
                plain = functools.partial(plain, block_k=bk)
            abs_e, rel_e = rel_err(got, plain(q, k, v))
            results.record(name, tag, abs_e, rel_e, TOL[tag])
            del got
            km, pm = paired_ms(lambda: kernel(q, k, v),
                               lambda: plain(q, k, v), reps)
            lm, backend = sdpa_ms(q, k, v, reps)
            bound = add_time(name, km, pm, attention_work(B, N, C, e), lm)
            at_least(f"{label} {tag} [{B},{N},{C}]", km, bound)
            plan = ""
            if kernel is attention_cuda:
                plan = f"; {plan_str(B, N, C, dtype)}"
                if dtype == bf16:
                    plan += f"; {k2_device_str(q, k, v)}"
            elif dtype == bf16:
                plan = (f"; {flash_plan_str(B, N, C)}; " + flash_device_str(
                    label, kernel, q, k, v, bound, km / lm))
            print(f"[{label}] {tag} B={B} N={N} C={C}: rel err {rel_e:.2e} "
                  f"(abs {abs_e:.2e}){jax_tiles}; {km:.4f} ms vs plain "
                  f"{pm:.4f} ms "
                  f"({4 * B * N * N * C / km / 1e9:.1f} TFLOP/s counting "
                  f"4BN^2C), bound {bound:.4f} ms, "
                  f"F.scaled_dot_product_attention ({backend}) {lm:.4f} ms"
                  f"{plan}")
            del q, k, v
            torch.cuda.empty_cache()
        for B, N, C in BWD_SHAPES + BWD_RAGGED:
            name = kernel_name("flash_attention_bwd", C)
            q, k, v, do = (torch.randn(B, N, C, generator=g, device=device)
                           .to(dtype) for _ in range(4))
            km, pm, line = check_bwd_contracts(
                "K3b flash bwd", name, tag, q, k, v, do, reps, results,
                1 if N > 4096 else None)
            lm, backend = sdpa_ms(q, k, v, reps, do)
            bound = add_time(name, km, pm, bwd_work(B, N, C, e), lm)
            at_least(f"K3b {tag} [{B},{N},{C}]", km, bound)
            print(f"{line}; bound {bound:.4f} ms, backward of "
                  f"F.scaled_dot_product_attention ({backend}) {lm:.4f} ms")
            del q, k, v, do
            torch.cuda.empty_cache()
        for name, (km, pm, bnd, lm) in timing.items():
            if name not in keep:
                results.time(name, tag, km, pm, bnd, lm)
        # K2' at the resident-limit-exceeding N (its two-pass body), errors
        B, N, C = STREAM_SHAPE
        q, k, v = (torch.randn(B, N, C, generator=g, device=device).to(dtype)
                   for _ in range(3))
        print(f"[K2' tiled, two passes] {tag} B={B} N={N} C={C} tb={B}: "
              f"{check_tiled(q, k, v, B, tag, results)}; "
              f"{plan_str(B, N, C, dtype, tiled=True)}")
        B, N, C = TILED_SHAPE
        q, k, v = (torch.randn(B, N, C, generator=g, device=device).to(dtype)
                   for _ in range(3))
        err = check_tiled(q, k, v, TILED_TB, tag, results)
        km, pm = paired_ms(lambda: attention_tiled_cuda(q, k, v, TILED_TB),
                           lambda: attention_tiled_reference(q, k, v,
                                                             TILED_TB), reps)
        qf, kf, vf = (t.float() for t in (q, k, v))
        lm, backend = sdpa_ms(qf, kf, vf, reps)
        bnd = Bound()
        # f32: q k^T and PV in f32; bf16: q k^T and PV on w's hi and lo
        # parts on the bf16 tensor cores
        if dtype == torch.bfloat16:
            bnd.add(*attention_work(B, N, C, e, products=3), PEAK["bf16"])
        else:
            bnd.add(*attention_work(B, N, C, e), PEAK["f32"])
        at_least(f"K2' {tag}", km, bnd.ms)
        dev = device_ms(f"K2' {tag}", lambda *a: attention_tiled_cuda(
            *a, TILED_TB), (q, k, v), bnd.ms)
        print(f"[K2' tiled] {tag} B={B} N={N} C={C} tb={TILED_TB}: {err}; "
              f"{km:.4f} ms vs plain {pm:.4f} ms, bound {bnd.ms:.4f} ms "
              f"({bnd.by}), F.scaled_dot_product_attention ({backend}) on "
              f"the f32 upcast {lm:.4f} ms; "
              f"{plan_str(B, N, C, dtype, tiled=True)}; device {dev:.4f} ms")
        results.time("attention_tiled", tag, km, pm, bnd, lm)
        del q, k, v, qf, kf, vf


def timed(run):
    """(result, host seconds, launches) of ``run()``, counted from zero,
    synchronised on both ends."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def expect(path, launches, want):
    """Fail unless each kernel in ``want`` launched exactly that often."""
    wrong = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
    if wrong:
        raise AssertionError(f"{path}: launches (got, want) {wrong}")


def report(path, out, n, dt, launches, smi, what="samples"):
    if not torch.isfinite(out).all():
        raise AssertionError(f"{path}: non-finite output")
    moved = {k: v for k, v in launches.items() if v}
    print(f"[{path}] B={n}: {dt:.3f} s = {n / dt:.2f} {what}/s (host "
          f"clock, synchronised; {smi}); out {tuple(out.shape)}, std "
          f"{out.float().std().item():.3f}; launches {moved}")


def profile_steps(run, label, smi, top=6):
    """Device time against wall time of ``run()`` (after one warm-up), and
    the kernels that took the most of it, from the summary of its
    torch.profiler trace (``tools.trace_summary.profile_step``)."""
    prof = profile_step(run, torch.device("cuda"), top=top)
    head = ", ".join(f"{key[:40]} {ms:.2f}" for key, ms in prof["kernels"])
    print(f"[profile] {label}: device {prof['device_ms']:.2f} ms in "
          f"{prof['wall_ms']:.2f} ms wall (device idle {prof['idle']:.0%}; "
          f"{smi}); most device ms: {head}; K1 family (forward and "
          f"backward) {prof['adagn_ms']:.2f} ms")


def slice_paths(device, smi, sites):
    """Phase 13: each new path once at full width, bf16; returns each
    path's launch counts."""
    bf16 = torch.bfloat16
    cfg, img, lat = flagship(bf16, device)
    cfg = dataclasses.replace(cfg, split_step=SPLIT_STEP)
    vcfg, van = slice_model("vanilla", bf16, device, seed=2)
    _, vae = slice_model("vae", bf16, device, seed=3)
    gen = torch.Generator(device=device)
    n_img, n_van, n_dec = (len(sites[k]) for k in
                           ("infodiff", "vanilla", "vae_decoder"))
    # K2 launches per forward: 2 down + 3 up blocks attend at level 2 and
    # the first middle block at level 3
    attn_lvl, attn_mid = 5, 1
    by_path = {}
    B = SLICE_BATCH["two_phase"]
    for model, c in ((img, cfg), (van, vcfg)):  # warm-up: cuDNN plans
        DiffusionProcess(c, model).sampling(gen.manual_seed(0), B,
                                            num_steps=2)
    two = TwoPhaseDiffusionProcess(cfg, img, van)
    out, dt, n = timed(lambda: two.sampling(gen.manual_seed(31), B))
    report("two_phase", out, B, dt, n, smi)
    uncond = SPLIT_STEP + 1
    expect("two_phase", n, {
        "attention": (T - uncond) * (attn_lvl + attn_mid),
        "attention_c256": uncond * attn_lvl, "attention_c512": uncond,
        "shortcut_fused": 0})
    by_path["two_phase"] = n

    B = SLICE_BATCH["ddim"]
    xT = torch.randn((B, SIZE, SIZE, 3), generator=gen.manual_seed(32),
                     device=device)
    a = torch.randn((B, A_DIM), generator=gen.manual_seed(33), device=device)
    routes = {"vanilla_ddim": ({}, 0), "vanilla_ddim_k6": (K6_ROUTE, n_van)}
    proc = DiffusionProcess(vcfg, van)
    proc.sampling(xT=xT, num_steps=2)
    rates = {route: [] for route in routes}
    # in turns, default, K6, K6, default: the host's spread between calls
    # is larger than the difference; the first run of each route is counted
    for route in ("vanilla_ddim", "vanilla_ddim_k6", "vanilla_ddim_k6",
                  "vanilla_ddim"):
        env, k6 = routes[route]
        with env_set(env):
            out, dt, n = timed(lambda: proc.sampling(xT=xT,
                                                     num_steps=DDIM_STEPS))
        rates[route].append(B / dt)
        if route in by_path:
            continue
        report(route, out, B, dt, n, smi)
        expect(route, n, {"attention_c256": DDIM_STEPS * attn_lvl,
                          "attention_c512": DDIM_STEPS,
                          "shortcut_fused": DDIM_STEPS * k6})
        by_path[route] = n
        with env_set(env):
            profile_steps(lambda: proc.sampling(xT=xT, num_steps=2),
                          f"{route} B={B}, 2 DDIM steps", smi)
    print("[vanilla_ddim turns] samples/s, default, K6, K6, default: "
          + ", ".join(f"{r:.2f}" for r in (rates["vanilla_ddim"][0],
                                            *rates["vanilla_ddim_k6"],
                                            rates["vanilla_ddim"][1])))
    with env_set(K6_ROUTE):
        proc = DiffusionProcess(cfg, img)
        proc.sampling(xT=xT, a=a, num_steps=2)
        out, dt, n = timed(lambda: proc.sampling(xT=xT, a=a,
                                                 num_steps=DDIM_STEPS))
    report("infodiff_ddim_k6", out, B, dt, n, smi)
    expect("infodiff_ddim_k6", n, {
        "attention": DDIM_STEPS * (attn_lvl + attn_mid),
        "shortcut_fused": DDIM_STEPS * n_img})
    by_path["infodiff_ddim_k6"] = n

    B = SLICE_BATCH["reconstruct"]
    x0 = torch.from_numpy(np.random.RandomState(34).uniform(
        -1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)).to(device)
    pipe = InfoDiffusionPipeline(cfg, img)
    out, dt, n = timed(lambda: pipe.reconstruct(x0, steps=DDIM_STEPS))
    report("reconstruct", out, B, dt, n, smi)
    # the Encoder attends at level 2 (C=128) too: 5 + 1 per encode
    expect("reconstruct", n, {
        "attention": (1 + T - 2 + DDIM_STEPS) * (attn_lvl + attn_mid),
        "shortcut_fused": 0})
    by_path["reconstruct"] = n

    B = SLICE_BATCH["latent"]
    with env_set(K5_ROUTE):
        latent = LatentDiffusionProcess(cfg, lat)
        if not latent.per_forward:
            raise AssertionError("latent_fwd: the per-forward route is off")

        def latent_run():
            z = latent.sampling(gen.manual_seed(35), sampling_number=B)
            return torch.cat([z, latent.reverse_sampling(z)])

        out, dt, n = timed(latent_run)
    report("latent_fwd", out, B, dt, n, smi, "latents (sampling + reverse)")
    expect("latent_fwd", n, {"latent_mlp": T + T - 2, "latent_traj": 0})
    by_path["latent_fwd"] = n

    B = SLICE_BATCH["vae"]
    a = torch.randn((B, A_DIM), generator=gen.manual_seed(36), device=device)
    for route, env, k6 in (("vae_decode", {}, 0),
                           ("vae_decode_k6", K6_ROUTE, n_dec)):
        with env_set(env), torch.no_grad():
            vae.decode(a)
            out, dt, n = timed(lambda: vae.decode(a))
        report(route, out, B, dt, n, smi)
        expect(route, n, {"attention_c256": attn_lvl, "attention_c512": 1,
                          "shortcut_fused": k6})
        by_path[route] = n
    return by_path


def slice_card_vs_cpu(device):
    """Phase 14: the new paths on the card against the CPU, f32, B=2, the
    same weights, inputs and noises; T=20, split 10."""
    n = 2
    rng = np.random.RandomState(60)
    xT = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    a = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    noises = torch.from_numpy(
        rng.randn(SMALL_T, n, SIZE, SIZE, 3).astype(np.float32))
    lat_xT = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    lat_noises = torch.from_numpy(
        rng.randn(SMALL_T, n, A_DIM).astype(np.float32))
    x0 = torch.from_numpy(rng.uniform(-1, 1, (n, SIZE, SIZE, 3))
                          .astype(np.float32))
    cpu = torch.device("cpu")
    small = dict(diffusion_steps=SMALL_T, split_step=SMALL_SPLIT,
                 deterministic=False)
    cfg, img = slice_model("diff", torch.float32, cpu, seed=61, **small)
    vcfg, van = slice_model("vanilla", torch.float32, cpu, seed=62, **small)
    _, vae = slice_model("vae", torch.float32, cpu, seed=63, **small)
    lat = init_weights_(Diff(T=SMALL_T, shape=cfg.latent_shape,
                             is_latent=True), 64).eval()
    outs = {}
    for key, dev in (("cpu", cpu), ("card", device)):
        if key == "card":
            img, van, vae, lat = (copy.deepcopy(m).to(dev)
                                  for m in (img, van, vae, lat))
        with torch.no_grad():
            enc_a = InfoDiffusionPipeline(cfg, img).encode(x0.to(dev))
        with env_set({"INFODIFF_FORCE_FUSED_LATENT": "1"}):
            latent = LatentDiffusionProcess(cfg, lat)
            z = latent.sampling(xT=lat_xT.to(dev), noises=lat_noises.to(dev))
            zr = latent.reverse_sampling(z)
        with torch.no_grad():
            dec = vae.decode(a.to(dev))
        outs[key] = {
            "two_phase": TwoPhaseDiffusionProcess(cfg, img, van).sampling(
                xT=xT.to(dev), a=a.to(dev), noises=noises.to(dev)),
            "reverse_sampling": DiffusionProcess(cfg, img).reverse_sampling(
                x0.to(dev), enc_a),
            "latent_fwd": z, "latent_fwd_reverse": zr, "vae_decode": dec}
    errs = []
    for what, want in outs["cpu"].items():
        abs_e, rel_e = rel_err(outs["card"][what], want)
        errs.append(f"{what} {rel_e:.2e}")
        if not rel_e <= TOL["slice"]:
            raise AssertionError(f"slice card vs CPU {what}: {rel_e:.3e} "
                                 f"over {TOL['slice']:.0e}")
    print(f"[slice card vs CPU] f32 B={n}, T={SMALL_T}, split {SMALL_SPLIT}, "
          f"the same weights and draws, full widths: max abs error over max "
          f"abs: {'; '.join(errs)} (bar {TOL['slice']:.0e})")


# phase 16: bench.py's model at INFODIFF_BENCH_SIZE=512 (AuxiliaryUNet ch 64,
# ch_mult (1,2,2,2), attention at level 2 over N = 16384 tokens (K3c) and in
# the middle block over N = 4096 (K3a), a_dim 256, T 1000, Encoder ch 64,
# mmd 0.1); the vanilla Diff and the VAE training at 64px; the vanilla UNet
# at 256px (K3a at C = 256 / 512) and 512px (K3c at C = 256 / 512); the
# two attention tools
HIRES = 512
HIRES_BATCH = {"generate": 8, "encode": 8, "train": 4}
HIRES_DDIM_STEPS = 100
HIRES_TRAIN_STEPS = 2
WIDE_TRAIN_BATCH, WIDE_TRAIN_STEPS = 64, 3
# (image size, batch, route) of the vanilla UNet's high-resolution DDIM
VANILLA_HIRES = ((256, 4, "flash_attention"), (512, 2, "flash_attention_online"))
VANILLA_HIRES_STEPS = 2
# attention calls of one UNet or Encoder forward: level 2 (2 down + 3 up
# blocks in the UNet, the Encoder's too) and the first middle block
ATTN_LVL, ATTN_MID = 5, 1


def hires_paths(device, smi):
    """Phase 16: each path once at full width, bf16; returns each path's
    launch counts."""
    bf16 = torch.bfloat16
    by_path = {}
    cfg = dataclasses.replace(slice_cfg("diff"), input_size=HIRES)
    img = train_model(bf16, device, HIRES).eval()
    lat = init_weights_(Diff(T=T, shape=cfg.latent_shape, is_latent=True,
                             dtype=bf16), 1).to(device).eval()
    pipe = InfoDiffusionPipeline(cfg, img)
    gen = torch.Generator(device=device)
    B = HIRES_BATCH["generate"]
    pipe.generate(B, steps=1, generator=gen.manual_seed(40))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    a, dt_lat, n_lat = timed(lambda: LatentDiffusionProcess(cfg, lat).sampling(
        gen.manual_seed(41), sampling_number=B))
    steps = HIRES_DDIM_STEPS
    out, dt, n = timed(lambda: pipe.generate(B, a=a, steps=steps,
                                             generator=gen.manual_seed(42)))
    peak = torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (B, HIRES, HIRES, 3):
        raise AssertionError(f"generate_512px: images {tuple(out.shape)}")
    report("generate_512px", out, B, dt, n, smi)
    print(f"[generate_512px] latents T={T} B={B}: {dt_lat:.3f} s = "
          f"{B / dt_lat:.2f} latents/s; DDIM-{steps} peak memory "
          f"{peak / 2**30:.2f} GiB")
    profile_steps(lambda: pipe.generate(B, a=a, steps=2,
                                        generator=gen.manual_seed(45)),
                  f"generate_512px B={B}, 2 DDIM steps", smi)
    expect("latents_512px", n_lat, {"latent_traj": 1})
    expect("generate_512px", n, {"flash_attention_online": ATTN_LVL * steps,
                                 "flash_attention": ATTN_MID * steps,
                                 "attention": 0})
    by_path["generate_512px"] = {k: n[k] + n_lat[k] for k in n}

    B = HIRES_BATCH["encode"]
    x = torch.from_numpy(np.random.RandomState(43).uniform(
        -1, 1, (B, HIRES, HIRES, 3)).astype(np.float32)).to(device)
    with torch.no_grad():
        pipe.encode(x)  # warm-up
        out, dt, n = timed(lambda: pipe.encode(x))
    report("encode_512px", out, B, dt, n, smi, "imgs")
    expect("encode_512px", n, {"flash_attention_online": ATTN_LVL,
                               "flash_attention": ATTN_MID, "attention": 0})
    by_path["encode_512px"] = n
    del img, lat, pipe, x, out, a
    torch.cuda.empty_cache()

    s = HIRES_TRAIN_STEPS
    by_path["train_512px"] = train_run(
        HIRES, HIRES_BATCH["train"], s, device, smi, want={
            "flash_attention_online": 2 * ATTN_LVL * s,
            "flash_attention": 2 * ATTN_MID * s,
            "flash_attention_bwd": 2 * (ATTN_LVL + ATTN_MID) * s,
            "attention": 0}, profile=True,
        # level 2 (N = 16384) is beyond the backward plan, the middle
        # block (N = 4096) within it
        contracts={"flash": 2 * ATTN_MID * s, "dense": 2 * ATTN_LVL * s})
    torch.cuda.empty_cache()

    s = WIDE_TRAIN_STEPS
    for name, forwards in (("vanilla", 1), ("vae", 2)):  # the VAE: Enc + Dec
        _, model = slice_model(name, bf16, device)
        by_path[f"train_{name}"] = train_run(
            SIZE, WIDE_TRAIN_BATCH, s, device, smi, model=model.train(),
            label=f"{name} 64px", no_grad=set(), want={
                "attention_c256": forwards * ATTN_LVL * s,
                "attention_c512": forwards * ATTN_MID * s,
                "flash_attention_bwd_c256": forwards * ATTN_LVL * s,
                "flash_attention_bwd_c512": forwards * ATTN_MID * s,
                "attention": 0, "flash_attention_bwd": 0},
            contracts={"flash": 0,
                       "dense": forwards * (ATTN_LVL + ATTN_MID) * s})
        del model
        torch.cuda.empty_cache()

    s = VANILLA_HIRES_STEPS
    for size, B, route in VANILLA_HIRES:
        vcfg = dataclasses.replace(slice_cfg("vanilla"), input_size=size)
        van = init_weights_(build_model(vcfg, dtype=bf16, device=device),
                            2).eval()
        proc = DiffusionProcess(vcfg, van)
        xT = torch.randn((B, size, size, 3), generator=gen.manual_seed(44),
                         device=device)
        proc.sampling(xT=xT, num_steps=1)  # warm-up
        out, dt, n = timed(lambda: proc.sampling(xT=xT, num_steps=s))
        path = f"vanilla_ddim_{size}px"
        report(path, out, B, dt, n, smi)
        expect(path, n, {f"{route}_c256": ATTN_LVL * s,
                         f"{route}_c512": ATTN_MID * s})
        by_path[path] = n
        del van, proc, xT, out
        torch.cuda.empty_cache()
    return by_path


def tool_paths(device):
    """Phase 16, the attention tools at reduced reps, on the card."""
    by_path = {}
    _, _, n = timed(lambda: microbench_attention.main(device, reps=5))
    expect("microbench_tool K2'", n, {"attention_tiled": 2 * 3 * 6})
    by_path["microbench_tool"] = n
    for grad, configs in (("0", "1024x64,16384x2"), ("1", "16384x1")):
        with env_set({"INFODIFF_FAB_REPS": "3", "INFODIFF_FAB_GRAD": grad,
                      "INFODIFF_FAB_CONFIGS": configs}):
            _, _, n = timed(lambda: flash_attn_bench.main(device))
        if not n["flash_attention_online"]:
            raise AssertionError("flash_attn_bench: K3c not launched")
        by_path[f"flash_attn_bench{'_grad' if grad == '1' else ''}"] = n
    return by_path


class plan_limit:
    """Set the port's primary-plan limit (``_FWD_PLAN_LIMIT``) for a block,
    as ``tests/test_flash_attention.py`` sets the JAX one."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        self.saved = K3._FWD_PLAN_LIMIT
        K3._FWD_PLAN_LIMIT = self.value

    def __exit__(self, *exc):
        K3._FWD_PLAN_LIMIT = self.saved


def hires_card_vs_cpu(device):
    """Phase 17: f32, the same numpy weights and inputs on both devices:
    the 64px InfoDiff DDIM-10 at B=2 with the online route forced (the plan
    limit at 0, the gate at 64 tokens: K3c at the N = 256 sites, K2 at the
    N = 64 one, where the online tiles do not divide N), one 512px InfoDiff
    forward at B=1 on the real route, and the vanilla Diff's and the VAE's
    ``loss_and_grads`` at 64px B=2 per gradient leaf."""
    n = 2
    cpu = torch.device("cpu")
    rng = np.random.RandomState(70)
    xT = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    a = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    x512 = torch.from_numpy(rng.randn(1, HIRES, HIRES, 3).astype(np.float32))
    t512 = torch.tensor([417])
    a512 = torch.from_numpy(rng.randn(1, A_DIM).astype(np.float32))
    x0 = torch.from_numpy(rng.uniform(-1, 1, (n, SIZE, SIZE, 3))
                          .astype(np.float32))
    draws = {"vanilla": dict(
        t=torch.tensor([5, 901]),
        eps=torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))),
        "vae": dict(
        reparam_eps=torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32)),
        prior_samples=torch.from_numpy(
            rng.randn(n, A_DIM).astype(np.float32)))}
    outs, grads, errs = {}, {}, []
    for dev in (cpu, device):
        with env_set({"INFODIFF_FLASH_ATTN_MIN_TOKENS": "64"}), plan_limit(0):
            _, img, _ = flagship(torch.float32, dev, seed=71)
            reset_launches()
            with torch.no_grad():
                outs[("online_ddim", dev.type)] = strided_ddim_loop(
                    img, make_schedule(1e-5, 1e-2, T, dev), xT.to(dev), None,
                    a.to(dev), num_steps=10).cpu()
            if dev.type == "cuda":
                expect("online_ddim card", read_launches(), {
                    "flash_attention_online": 10 * ATTN_LVL,
                    "attention": 10 * ATTN_MID, "flash_attention": 0})
        del img
        img = train_model(torch.float32, dev, HIRES, seed=72, bias_std=0.1)
        reset_launches()
        with torch.no_grad():
            outs[("forward_512px", dev.type)] = img.eval()(
                x512.to(dev), t512.to(dev), a512.to(dev)).cpu()
        if dev.type == "cuda":
            expect("forward_512px card", read_launches(), {
                "flash_attention_online": ATTN_LVL,
                "flash_attention": ATTN_MID, "attention": 0})
        del img
        for name in ("vanilla", "vae"):
            _, model = slice_model(name, torch.float32, dev, seed=73)
            model = init_weights_(model, 73, bias_std=0.1)
            loss, _, g = loss_and_grads(
                model, x0.to(dev), 0, deterministic=True,
                **{k: v.to(dev) for k, v in draws[name].items()})
            outs[(f"{name}_loss", dev.type)] = loss.cpu()
            grads[(name, dev.type)] = {
                k: v.cpu() for (k, _), v in zip(model.named_parameters(), g)}
            del model, g
    for what in ("online_ddim", "forward_512px", "vanilla_loss", "vae_loss"):
        _, e = rel_err(outs[(what, "cuda")], outs[(what, "cpu")])
        errs.append((what, e))
    for name in ("vanilla", "vae"):
        leaf = leaf_errors(grads[(name, "cuda")], grads[(name, "cpu")])
        worst = max(leaf, key=leaf.get)
        errs.append((f"{name} gradient leaves (worst {worst})", leaf[worst]))
    print("[hires card vs CPU] f32, max abs error over max abs: " + "; ".join(
        f"{what} {e:.2e}" for what, e in errs) + f" (bar {TOL['slice']:.0e};"
        f" the online route forced for the 64px DDIM-10 at B={n}: K3c at "
        f"N=256, K2 at N=64)")
    for what, e in errs:
        if not e <= TOL["slice"]:
            raise AssertionError(f"hires card vs CPU {what}: {e:.3e} over "
                                 f"{TOL['slice']:.0e}")

# phase 18: the InfoDiff of the datasets with unets_channels 32 (mnist,
# fmnist and dsprites at 32px, chairs at 64px; config.py) as
# with_dataset_config() builds it, a_dim 32 (the verify recipe's), T 1000:
# its UNet and Encoder attend at C = 64, level 2 over N = 64 / 256 tokens
# and the middle block over N = 16 / 64, all below the 512-token gate (K2)
# and backward through K3b
C64_DATASETS = ("mnist", "chairs")
C64_A_DIM, C64_BATCH, C64_TRAIN_STEPS = 32, 64, 3


def c64_cfg(dataset: str) -> Config:
    return Config(model="diff", dataset=dataset, a_dim=C64_A_DIM,
                  diffusion_steps=T, deterministic=True).with_dataset_config()


def c64_paths(device, smi):
    """Phase 18: per dataset, ``make_train_step`` (1 + 3 steps) and
    DDIM-100 at B=64, bf16; then mnist's latent prior with turbo on the
    per-forward route (it warns and samples unquantized through K5); exact
    launches per kernel at C = 64. Returns each path's launch counts."""
    bf16 = torch.bfloat16
    by_path = {}
    gen = torch.Generator(device=device)
    fwd = ATTN_LVL + ATTN_MID  # K2 calls of one UNet or Encoder forward
    s, B = C64_TRAIN_STEPS, C64_BATCH
    for dataset in C64_DATASETS:
        cfg = c64_cfg(dataset)
        size, ch = cfg.input_size, cfg.input_channels
        model = init_weights_(build_model(cfg, dtype=bf16, device=device), 80)
        by_path[f"train_{dataset}"] = train_run(
            size, B, s, device, smi, model=model.train(),
            label=f"{dataset} {size}px", channels=ch, want={
                "attention_c64": 2 * fwd * s,
                "flash_attention_bwd_c64": 2 * fwd * s,
                "attention": 0, "flash_attention_bwd": 0},
            contracts={"flash": 0, "dense": 2 * fwd * s})
        pipe = InfoDiffusionPipeline(cfg, model.eval())
        a = torch.randn((B, cfg.a_dim), generator=gen.manual_seed(81),
                        device=device)
        pipe.generate(B, a=a, steps=2, generator=gen.manual_seed(82))
        out, dt, n = timed(lambda: pipe.generate(
            B, a=a, steps=DDIM_STEPS, generator=gen.manual_seed(83)))
        if tuple(out.shape) != (B, size, size, ch):
            raise AssertionError(f"{dataset}_ddim: images "
                                 f"{tuple(out.shape)}")
        path = f"{dataset}_ddim"
        report(path, out, B, dt, n, smi)
        expect(path, n, {"attention_c64": DDIM_STEPS * fwd, "attention": 0})
        by_path[path] = n
        del model, pipe, out
        torch.cuda.empty_cache()
    cfg = c64_cfg("mnist")
    lat = init_weights_(build_model(cfg, latent=True, dtype=bf16,
                                    device=device), 84).eval()
    with env_set(K5_ROUTE), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        latent = LatentDiffusionProcess(cfg, lat, turbo="int8")
    if not (latent.per_forward and any(
            "int8 weight stream" in str(w.message) for w in caught)):
        raise AssertionError("mnist latent turbo: the per-forward route "
                             "did not take it with a warning")
    out, dt, n = timed(lambda: latent.sampling(gen.manual_seed(85),
                                               sampling_number=B))
    path = "mnist_latent_turbo_fwd"
    report(path, out, B, dt, n, smi, "latents")
    expect(path, n, {"latent_mlp": T, "latent_traj": 0,
                     "latent_traj_int8": 0})
    by_path[path] = n
    return by_path


def c64_card_vs_cpu(device):
    """Phase 18: the mnist InfoDiff's loss and every gradient leaf, f32,
    B=2, the same weights and injected draws, card against CPU."""
    n, cfg = 2, c64_cfg("mnist")
    size, ch = cfg.input_size, cfg.input_channels
    rng = np.random.RandomState(86)
    x = torch.from_numpy(rng.randn(n, size, size, ch).astype(np.float32))
    draws = dict(
        t=torch.tensor([4, 733]),
        eps=torch.from_numpy(rng.randn(n, size, size, ch).astype(np.float32)),
        reparam_eps=torch.from_numpy(
            rng.randn(n, cfg.a_dim).astype(np.float32)),
        prior_samples=torch.from_numpy(
            rng.randn(n, cfg.a_dim).astype(np.float32)))
    outs = {}
    for dev in (torch.device("cpu"), device):
        model = init_weights_(build_model(cfg, dtype=torch.float32,
                                          device=dev), 87, bias_std=0.1)
        reset_launches()
        loss, _, grads = loss_and_grads(
            model, x.to(dev), 0, deterministic=True,
            **{k: v.to(dev) for k, v in draws.items()})
        outs[dev.type] = (loss.cpu(), {
            k: g.cpu() for (k, _), g in zip(model.named_parameters(), grads)})
        if dev.type == "cuda":
            calls = 2 * (ATTN_LVL + ATTN_MID)  # the UNet and the Encoder
            expect("mnist card", read_launches(), {
                "attention_c64": calls, "flash_attention_bwd_c64": calls,
                contract_key("dense"): calls, contract_key("flash"): 0})
        del model, grads
    _, loss_e = rel_err(outs["cuda"][0], outs["cpu"][0])
    errs = leaf_errors(outs["cuda"][1], outs["cpu"][1])
    worst = max(errs, key=errs.get)
    print(f"[mnist card vs CPU] f32 {size}px B={n}, injected draws: loss "
          f"rel err {loss_e:.2e}; worst of {len(errs)} gradient leaves "
          f"{errs[worst]:.2e} ({worst}) (bar {TOL['slice']:.0e} per leaf)")
    if not max(loss_e, errs[worst]) <= TOL["slice"]:
        raise AssertionError(f"mnist card vs CPU: {worst} "
                             f"{max(loss_e, errs[worst]):.3e} over "
                             f"{TOL['slice']:.0e}")


# phase 19: the user's entry path, ``python -m infodiffusion_tpu_torch``
# (cli.main in-process), at the flagship's full width (celeba: AuxiliaryUNet
# ch 64, ch_mult (1,2,2,2), attention at level 2, a_dim 256, T 1000), bf16,
# on INFODIFF_SYNTHETIC_N synthetic images
CLI_N, CLI_BATCH, CLI_STEPS = 512, 128, 10
CLI_COMMON = ["--model", "diff", "--prior", "regular", "--dataset", "celeba",
              "--a_dim", str(A_DIM), "--data_dir", "synthetic", "--bf16",
              "--batch_size", str(CLI_BATCH), "--r_seed", "7"]
# (label, flags): trains 4 steps, resumes for 4 more, encodes the 512
# images, trains the prior on their latents, then the latent prior and
# DDIM-100 at B=128 into 128 FID PNGs, interpolate and eval at DDIM-10
CLI_MODES = (
    ("train -e 1", ["--mode", "train", "-e", "1", "--save_epochs", "1"]),
    ("train -e 2 --resume", ["--mode", "train", "-e", "2", "--save_epochs",
                             "1", "--resume"]),
    ("save_latent", ["--mode", "save_latent", "-e", "2"]),
    ("train_latent_ddim", ["--mode", "train_latent_ddim", "-e", "2",
                           "--save_epochs", "2"]),
    ("eval_fid --is_latent", ["--mode", "eval_fid", "-e", "2", "--is_latent",
                              "--sampling_steps", "100",
                              "--sampling_number", str(CLI_BATCH)]),
    ("interpolate", ["--mode", "interpolate", "-e", "2", "--sampling_steps",
                     str(CLI_STEPS)]),
    ("eval", ["--mode", "eval", "-e", "2", "--sampling_steps",
              str(CLI_STEPS)]),
)


def flagship_sites(model):
    """(GroupNorm sites of the UNet, of the Encoder, attention blocks of the
    UNet, of the Encoder): K1 runs once at every GroupNorm (the ResBlock
    norms and the attention blocks' norm) of a forward, K2 once at every
    attention block (C=128: 256 tokens at level 2, 64 in the middle
    block)."""
    from infodiffusion_tpu_torch.nn.attention import _GN, AttnBlock
    from infodiffusion_tpu_torch.nn.blocks import _GNParams

    def count(module, kinds):
        return sum(isinstance(m, kinds) for m in module.modules())

    return (count(model.backbone, (_GNParams, _GN)),
            count(model.encoder, (_GNParams, _GN)),
            count(model.backbone, AttnBlock), count(model.encoder, AttnBlock))


def zero_launches():
    """A count of 0 for every kernel and each K3b contract."""
    total = dict.fromkeys(KERNELS, 0)
    total.update({contract_key(c): 0 for c in ("flash", "dense")})
    return total


def launch_counts(k1=0, k1_bwd=0, k2=0, dense=0, k4=0):
    """Every kernel's count (and K3b's per contract), the others 0."""
    return {"adagn": k1, "adagn_bwd": k1_bwd, "attention": k2,
            contract_key("dense"): dense, contract_key("flash"): 0,
            "latent_traj": k4, "flash_attention": 0,
            "latent_traj_int8": 0, "latent_mlp": 0, "qconv": 0,
            "int8_conv": 0, "shortcut_fused": 0}


def cli_expected(model):
    """Exact launches per mode of CLI_MODES, from the flagship's structure
    (``flagship_sites``): K1 and K2 at each site of a forward, K1-bwd once
    at each GroupNorm in the backward, K3b on the dense contract (below the
    512-token gate) once at each attention block in the backward; K4 once
    a latent trajectory. The latent prior's training runs no kernel."""
    gn_u, gn_e, at_u, at_e = flagship_sites(model)
    steps = CLI_N // CLI_BATCH  # a training epoch
    run = launch_counts

    train = run(k1=steps * (gn_u + gn_e), k1_bwd=steps * (gn_u + gn_e),
                k2=steps * (at_u + at_e), dense=steps * (at_u + at_e))
    reverse = T - 2  # DDIM encoding over idx 1 .. T-2
    evals = len(range(0, 16, CLI_BATCH))  # eval: 16 samples a batch step
    return {
        "train -e 1": train, "train -e 2 --resume": train,
        "save_latent": run(k1=steps * gn_e, k2=steps * at_e),
        "train_latent_ddim": run(),
        "eval_fid --is_latent": run(k1=100 * gn_u, k2=100 * at_u, k4=1),
        "interpolate": run(k1=gn_e + (reverse + CLI_STEPS) * gn_u,
                           k2=at_e + (reverse + CLI_STEPS) * at_u),
        "eval": run(k1=evals * CLI_STEPS * gn_u, k2=evals * CLI_STEPS * at_u),
    }


def png_shape(path):
    """(height, width, channels) of a PNG the port wrote, from its header,
    and whether its pixel rows inflate to that size."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    c = {0: 1, 2: 3, 6: 4}[ctype]
    idat, pos = b"", 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if depth != 8 or len(zlib.decompress(idat)) != h * (1 + w * c):
        raise AssertionError(f"{path}: pixel data does not match {h}x{w}x{c}")
    return h, w, c


def cli_path(device, smi, work):
    """Phase 19: run.py's command line through the port's own entry point,
    one mode after another in the directory ``work``; checks the
    checkpoints (epoch 2 at step 8), the metrics, the latents, the PNGs,
    the CLI's latents against the pipeline's encode of the same images,
    and the exact launches per mode. Returns the launches, summed."""
    from infodiffusion_tpu_torch import cli
    from infodiffusion_tpu_torch.data.datasets import get_dataset
    from infodiffusion_tpu_torch.data.loader import (
        DataLoader,
        h2d_bytes_per_batch,
    )

    cfg = cli.parse_args(CLI_COMMON + ["--mode", "train"]).with_dataset_config()
    probe = build_model(cfg, device="cpu")
    want = cli_expected(probe)
    del probe
    total = zero_launches()
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with env_set({"INFODIFF_SYNTHETIC_N": str(CLI_N)}):
            for label, flags in CLI_MODES:
                _, dt, n = timed(lambda: cli.main(CLI_COMMON + flags))
                print(f"[cli] {label}: {dt:.2f} s wall (host clock, "
                      f"synchronised; {smi}); launches "
                      f"{ {k: v for k, v in n.items() if v} }")
                expect(f"cli {label}", n, want[label])
                for k in total:
                    total[k] += n[k]
            root = os.path.join("models", "celeba_256d_0.1mmd")
            steps = {}
            for e in (1, 2):
                with open(os.path.join(root, f"model-{e}", "meta.json")) as f:
                    steps[e] = json.load(f)["step"]
            per_epoch = CLI_N // CLI_BATCH
            if steps != {1: per_epoch, 2: 2 * per_epoch}:
                raise AssertionError(f"cli checkpoints: steps {steps}")
            with open(os.path.join("logs", "celeba_256d_0.1mmd",
                                   "metrics.jsonl")) as f:
                losses = [json.loads(line)["train/loss"] for line in f]
            if len(losses) != 2 or not all(map(math.isfinite, losses)):
                raise AssertionError(f"cli metrics: losses {losses}")
            npz = np.load("diff_celeba_256d_0_1mmd_latent.npz",
                          allow_pickle=True)
            all_a = npz["all_a"]
            if (all_a.shape, all_a.dtype) != ((CLI_N, A_DIM), np.float32) \
                    or not np.isfinite(all_a).all():
                raise AssertionError(f"cli latents {all_a.shape} "
                                     f"{all_a.dtype}")
            img = os.path.join("imgs", "celeba_256d_0.1mmd")
            fid = sorted(os.listdir(os.path.join(img, "eval-fid-latent")))
            pngs = {"eval-fid-latent": len(fid), "interpolate-0": len(
                os.listdir(os.path.join(img, "interpolate-0"))),
                "eval": len(os.listdir(os.path.join(img, "eval")))}
            if pngs != {"eval-fid-latent": CLI_BATCH, "interpolate-0": 1,
                        "eval": len(range(0, 16, CLI_BATCH))} \
                    or fid[-1] != f"sample-{CLI_BATCH - 1:06d}.png":
                raise AssertionError(f"cli PNGs {pngs}")
            shapes = {png_shape(os.path.join(img, "eval-fid-latent", fid[0])),
                      png_shape(os.path.join(img, "interpolate-0",
                                             "sample0.png"))}
            if shapes != {(SIZE, SIZE, 3), (SIZE + 4, 10 * (SIZE + 2) + 2, 3)}:
                raise AssertionError(f"cli PNG shapes {shapes}")
            # the CLI's latents against the pipeline's encode of the same
            # first batch, on the checkpoint the CLI saved
            pipe = InfoDiffusionPipeline.from_checkpoint(
                cli.parse_args(CLI_COMMON + ["--mode", "eval", "-e", "2"]),
                device=device)
            # save_latent's loader: no shuffle, celeba's flips from r_seed
            loader = DataLoader(get_dataset(cfg), CLI_BATCH, device=device,
                                flip=True, seed=cfg.r_seed)
            x = next(iter(loader))
            abs_e, rel_e = rel_err(pipe.encode(x), torch.from_numpy(
                all_a[:CLI_BATCH]))
            h2d = h2d_bytes_per_batch(loader)
            print(f"[cli] checkpoints model-1 step {steps[1]}, model-2 step "
                  f"{steps[2]}; losses {losses}; latents {all_a.shape} f32; "
                  f"PNGs {pngs}; the CLI's latents against the pipeline's "
                  f"encode: rel err {rel_e:.2e} (abs {abs_e:.2e}); loader "
                  f"H2D {h2d} bytes a batch as uint8 ({4 * h2d} as f32)")
            if not rel_e <= TOL["f32"]:
                raise AssertionError(f"cli latents against the pipeline: "
                                     f"{rel_e:.3e}")
            del pipe, loader, x
    finally:
        os.chdir(cwd)
        torch.cuda.empty_cache()
    return total


# phase 20: the evaluation path in phase 19's directory, on its checkpoint:
# FID / KID (the port's InceptionV3 on a fixture checkpoint, which stands
# in for the real weights), attr_classification and TAD
EVAL_N = 2560  # images a folder: more than the 2,048 features (full rank)
EVAL_STEPS = 10
EVAL_CHECK_N = 16  # images of the card-against-CPU check
TOL.update({"resize": 2e-6, "inception": 1e-4, "self_fid": 1e-3})


def eval_expected(model):
    """Exact launches per stage of phase 20 (``flagship_sites``): the FID
    stages launch no hand kernel (the Inception convs are cuDNN's);
    eval_fid runs K4 once a batch and K1 / K2 at each UNet site a DDIM
    step; attr_classification encodes the dataset (K1 / K2 at each
    Encoder site a batch)."""
    gn_u, gn_e, at_u, at_e = flagship_sites(model)
    batches = EVAL_N // CLI_BATCH
    steps = batches * EVAL_STEPS
    return {
        "gen_fid_stats": launch_counts(),
        "eval_fid": launch_counts(k1=steps * gn_u, k2=steps * at_u,
                                  k4=batches),
        "calc_fid": launch_counts(),
        "attr_classification": launch_counts(k1=CLI_N // CLI_BATCH * gn_e,
                                             k2=CLI_N // CLI_BATCH * at_e),
    }


def eval_card_vs_cpu(FID, INC, batch_u8, ckpt, device):
    """The card's clean resize and Inception features against the CPU's on
    the same uint8 images and weights, with TF32 turned on globally first:
    the extractor must pin f32 itself (printed beside the error of the
    same forward outside the pin)."""
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.from_numpy(batch_u8)
        r_abs, _ = rel_err(INC.clean_resize(x.to(device)),
                           INC.clean_resize(x))
        got = FID.get_extractor("inception", device)[0](batch_u8)
        want = torch.from_numpy(
            FID.get_extractor("inception", "cpu")[0](batch_u8))
        f_abs, f_rel = rel_err(torch.from_numpy(got), want)
        # the contrast: the same forward without the extractor's pin
        with torch.no_grad():
            unpinned = INC.forward(INC.load_params(ckpt, device),
                                   INC.clean_resize(x.to(device)))
        _, t_rel = rel_err(unpinned, want)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
    print(f"[eval] card against CPU, {len(batch_u8)} images 64px -> 299, "
          f"TF32 on globally: resize max abs err {r_abs:.2e} (bar "
          f"{TOL['resize']:.0e}); features max abs err {f_abs:.3e} = "
          f"{f_rel:.2e} of max |feature| (bar {TOL['inception']:.0e}); "
          f"the forward outside the extractor's pin (TF32 convs) "
          f"{t_rel:.2e}")
    if not r_abs <= TOL["resize"]:
        raise AssertionError(f"clean_resize card vs CPU {r_abs:.3e}")
    if not f_rel <= TOL["inception"]:
        raise AssertionError(f"Inception features card vs CPU {f_rel:.3e}")


def eval_stages(FID, INC, folder, ckpt, ref, device, smi):
    """Seconds of each stage of scoring ``folder`` against its own stats
    ``ref``: decode (the reader's threads), resize and the forward on the
    card (synchronised), sqrtm (the self-FID) and KID. Returns the
    self-FID."""
    t0 = time.perf_counter()
    batches = list(FID._iter_folder(folder, None))
    t1 = time.perf_counter()
    xs = [INC.clean_resize(torch.from_numpy(b).pin_memory().to(device))
          for b in batches]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    params = INC.load_params(ckpt, device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with torch.no_grad(), INC.full_f32():
        feats = torch.cat([INC.forward(params, x) for x in xs]).cpu().numpy()
    t4 = time.perf_counter()
    mu, sigma = FID.feature_stats(feats)
    self_fid = FID.frechet_distance(ref["mu"], ref["sigma"], mu, sigma)
    t5 = time.perf_counter()
    self_kid = FID.kid_score(ref["feats"], feats)
    t6 = time.perf_counter()
    n = len(feats)
    print(f"[eval] {n} images of {folder}: decode {t1 - t0:.2f} s, resize "
          f"{t2 - t1:.2f} s (with the H2D copies), forward {t4 - t3:.2f} s "
          f"= {n / (t4 - t3):.1f} images/s (f32, B=256), sqrtm "
          f"{t5 - t4:.2f} s, KID {t6 - t5:.2f} s (host clock, synchronised; "
          f"{smi}); self-FID {self_fid:.3e}, self-KID {self_kid:.3e}; "
          f"features against the stats file's: max abs diff "
          f"{np.abs(feats - ref['feats']).max():.2e}")
    return self_fid


def eval_path(device, smi, work):
    """Phase 20: the evaluation path in phase 19's directory ``work``, on
    its flagship checkpoint: a fixture Inception checkpoint; card against
    CPU; gen_fid_stats over 2,560 synthetic celeba images; eval_fid
    --is_latent at DDIM-10 into 2,560 PNGs; calc_fid over them (FID and
    KID finite, FID > 0; the real folder against its own stats ~ 0);
    attr_classification on 512 images and TAD over phase 19's latents;
    exact launches per stage. Returns the launches, summed."""
    from infodiffusion_tpu_torch import calc_fid, cli, gen_fid_stats
    from infodiffusion_tpu_torch.data.datasets import get_dataset
    from infodiffusion_tpu_torch.imaging import write_png_batch
    from infodiffusion_tpu_torch.metrics import TADMetric
    from infodiffusion_tpu_torch.metrics import fid as FID
    from infodiffusion_tpu_torch.metrics import inception as INC
    from infodiffusion_tpu_torch.runner import image_root, latent_npz_path

    cfg = cli.parse_args(CLI_COMMON + ["--mode", "eval"]).with_dataset_config()
    probe = build_model(cfg, device="cpu")
    want = eval_expected(probe)
    del probe
    total = zero_launches()
    secs = {}

    def stage(label, run):
        out, dt, n = timed(run)
        expect(f"eval {label}", n, want[label])
        for k in total:
            total[k] += n[k]
        secs[label] = dt
        return out

    ckpt = os.path.join(work, "pt_inception-fixture.pth")
    sd = INC.random_state_dict(0)
    ok, problems = INC.verify_state_dict_schema(sd)
    if not ok:
        raise AssertionError(f"fixture Inception checkpoint: {problems}")
    torch.save(sd, ckpt)
    del sd
    real = os.path.join(work, "celeba_real")
    gen = os.path.join(work, image_root(cfg), "eval-fid-latent")
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with env_set({"INFODIFF_INCEPTION_WEIGHTS": ckpt,
                      "INFODIFF_FID_STATS_DIR": os.path.join(work, "stats"),
                      "INFODIFF_SYNTHETIC_N": str(EVAL_N)}):
            imgs = get_dataset(cfg).images
            eval_card_vs_cpu(FID, INC, imgs[:EVAL_CHECK_N], ckpt, device)
            t0 = time.perf_counter()
            write_png_batch([os.path.join(real, f"{i:06d}.png")
                             for i in range(EVAL_N)], imgs)
            secs["write real PNGs"] = time.perf_counter() - t0
            del imgs
            stats = stage("gen_fid_stats",
                          lambda: gen_fid_stats.main(["celeba", real]))
            stage("eval_fid", lambda: cli.main(CLI_COMMON + [
                "--mode", "eval_fid", "-e", "2", "--is_latent",
                "--sampling_steps", str(EVAL_STEPS),
                "--sampling_number", str(EVAL_N)]))
            pngs = sorted(os.listdir(gen))
            if len(pngs) != EVAL_N or png_shape(os.path.join(
                    gen, pngs[-1])) != (SIZE, SIZE, 3):
                raise AssertionError(f"eval_fid PNGs: {len(pngs)}")
            fid, kid = stage("calc_fid",
                             lambda: calc_fid.main(["celeba", gen]))
            if not (math.isfinite(fid) and math.isfinite(kid) and fid > 0):
                raise AssertionError(f"calc_fid: fid {fid}, kid {kid}")
            ref = np.load(stats, allow_pickle=True)
            if str(ref["extractor"]) != "inception-jax" \
                    or ref["feats"].shape != (EVAL_N, INC.FEATURE_DIM):
                raise AssertionError(f"stats file {stats}: "
                                     f"{ref['extractor']} {ref['feats'].shape}")
            self_fid = eval_stages(FID, INC, real, ckpt, ref, device, smi)
            if not abs(self_fid) < TOL["self_fid"] * fid:
                raise AssertionError(f"self-FID {self_fid:.3e} against the "
                                     f"generated folder's {fid:.3e}")
        with env_set({"INFODIFF_SYNTHETIC_N": str(CLI_N)}):
            mean = stage("attr_classification", lambda: cli.main(
                CLI_COMMON + ["--mode", "attr_classification", "-e", "2"]))
        with open(os.path.join(image_root(cfg), "attr_classification",
                               "results.json")) as f:
            res = json.load(f)
        if not (math.isfinite(mean) and 0.0 <= mean <= 1.0
                and res["mean_auroc"] == mean):
            raise AssertionError(f"attr_classification: {mean} {res}")
        npz = np.load(latent_npz_path(cfg), allow_pickle=True)
        t0 = time.perf_counter()
        tad, _, n_attr = TADMetric(npz["all_attr"].shape[1]).evaluate(
            npz["all_a"], npz["all_attr"])
        secs["TAD"] = time.perf_counter() - t0
        if not math.isfinite(tad):
            raise AssertionError(f"TAD {tad}")
    finally:
        os.chdir(cwd)
        torch.cuda.empty_cache()
    print(f"[eval] stages (s, host clock, synchronised; {smi}): "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; FID {fid:.4f}, "
          f"KID {kid:.5f} (fixture Inception weights: not comparable to "
          f"published scores); attr_classification mean AUROC {mean:.4f} "
          f"over {len(res['per_attr_auroc'])} attributes; TAD {tad:.4f} "
          f"({n_attr} attributes) over phase 19's latents; launches "
          f"{ {k: v for k, v in total.items() if v} }")
    return total


# phase 21: a reference user's path: a CelebA folder of JPEGs through the
# native batcher, a reference .pth through from_torch_checkpoint, the
# converter and the examples, and CrossAttnBlock
REF_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "celeba_jpeg")
REF_STEPS = 100  # DDIM steps of the generation from the .pth
REF_EPOCH = 50  # the reference's model-50.pth
REF_EXAMPLE_N = 16  # samples of examples.generate, at CLI_STEPS
CROSS_HW, CROSS_C = 16, 128  # CrossAttnBlock at B=128: N=256, C=128
# the fixtures' decode against PIL's (the JAX package's bars)
TOL.update({"decode_mean": 0.5, "decode_max": 2.0})


class no_pil:
    """Block PIL's import for a block, as on a machine without it."""

    NAMES = ("PIL", "PIL.Image")

    def __enter__(self):
        import sys

        self.saved = {k: sys.modules.get(k) for k in self.NAMES}
        for k in self.NAMES:
            sys.modules[k] = None

    def __exit__(self, *exc):
        import sys

        for k, v in self.saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def reference_expected(model):
    """Exact launches of phase 21's counted stages (``flagship_sites``):
    the CLI's training epoch over the folder, the prior's trajectory and
    DDIM-100 from the .pth, and one CrossAttnBlock forward (K1 at its one
    GroupNorm, applied to x and to a; K2 once)."""
    gn_u, gn_e, at_u, at_e = flagship_sites(model)
    steps = CLI_N // CLI_BATCH
    return {
        "train": launch_counts(k1=steps * (gn_u + gn_e),
                               k1_bwd=steps * (gn_u + gn_e),
                               k2=steps * (at_u + at_e),
                               dense=steps * (at_u + at_e)),
        "generate": launch_counts(k1=REF_STEPS * gn_u, k2=REF_STEPS * at_u,
                                  k4=1),
        "cross_attn": launch_counts(k1=2, k2=1),
        # outside the path's count, exact all the same
        "examples.generate": launch_counts(k1=CLI_STEPS * gn_u,
                                           k2=CLI_STEPS * at_u),
        "examples.traverse": launch_counts(
            k1=gn_e + (T - 2 + CLI_STEPS) * gn_u,
            k2=at_e + (T - 2 + CLI_STEPS) * at_u),
        "eval_fid": launch_counts(k1=CLI_STEPS * gn_u, k2=CLI_STEPS * at_u,
                                  k4=1),
    }


def reference_state_dict(img):
    """The reference's state dict of ``img``: the port's export plus the
    keys the reference saves and the port does not build (each
    AuxResBlock's CrossAttnBlock, the sinusoid table)."""
    from infodiffusion_tpu_torch.interop import export_torch_state_dict
    from infodiffusion_tpu_torch.nn.attention import CrossAttnBlock

    sd = export_torch_state_dict(img)
    for key in list(sd):
        m = re.fullmatch(r"(backbone\.\w+blocks\.\d+)\.block2\.3\.weight", key)
        if m:
            for k, v in CrossAttnBlock(sd[key].shape[0]).state_dict().items():
                sd[f"{m.group(1)}.crossattn.{k}"] = (
                    v[:, :, None, None] if v.ndim == 2 else v)
    sd["backbone.time_embedding.timembedding.0.weight"] = \
        img.backbone.time_embedding.table.cpu()
    return sd


def cross_attn_plain(block, x, a):
    """CrossAttnBlock's forward on the kernels' plain versions (K1's and
    K2's), on the same device and projections."""
    B, C, H, W = x.shape
    gn = block.group_norm

    def norm(t):
        return adagn_reference(t.permute(0, 2, 3, 1).contiguous(),
                               gn.num_groups, gn.weight, gn.bias)

    h, h_a = norm(x), norm(a)
    q = block.proj_q(h_a).reshape(B, H * W, C)
    k = block.proj_k(h).reshape(B, H * W, C)
    v = block.proj_v(h).reshape(B, H * W, C)
    o = attention_reference(q, k, v).reshape(B, H, W, C)
    return x + block.proj(o).permute(0, 3, 1, 2)


def check_cross_attn(device, stage):
    """CrossAttnBlock at B=128, N=256, C=128 against its plain path in f32
    and bf16; then one bf16 forward counted through ``stage``."""
    from infodiffusion_tpu_torch.nn.attention import CrossAttnBlock

    rng = np.random.RandomState(21)
    shape = (BATCH, CROSS_HW, CROSS_HW, CROSS_C)
    x, a = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
            .to(device).permute(0, 3, 1, 2) for _ in range(2))
    errs = []
    for tag, dtype in DTYPES.items():
        block = init_weights_(CrossAttnBlock(CROSS_C, dtype), 22,
                              bias_std=0.1).to(device)
        xd, ad = x.to(dtype), a.to(dtype)
        with torch.no_grad():
            abs_e, rel_e = rel_err(block(xd, ad), cross_attn_plain(block, xd,
                                                                   ad))
        errs.append(f"{tag} rel err {rel_e:.2e} (abs {abs_e:.2e}, bar "
                    f"{TOL[tag]:.0e})")
        if not rel_e <= TOL[tag]:
            raise AssertionError(f"CrossAttnBlock {tag}: {rel_e:.3e}")
    with torch.no_grad():
        out = stage("cross_attn", lambda: block(xd, ad))
    if tuple(out.shape) != (BATCH, CROSS_C, CROSS_HW, CROSS_HW) \
            or not torch.isfinite(out).all():
        raise AssertionError(f"CrossAttnBlock out {tuple(out.shape)}")
    print(f"[reference] CrossAttnBlock B={BATCH} N={CROSS_HW ** 2} "
          f"C={CROSS_C} against its plain path: {'; '.join(errs)}")


def reference_path(device, smi, work):
    """Phase 21: the native library (built, its branch), the fixtures'
    decode against PIL's, the CMYK fixture without PIL, the CLI's training
    over a CelebA-layout folder of 512 JPEGs (the native batcher serving
    every image), a reference .pth of the flagship and its prior (with the
    dead keys) loaded by from_torch_checkpoint (parameters and DDIM-100
    bitwise the source model's), the converter and both examples on it,
    eval_fid's PNGs through the native writer, and CrossAttnBlock. Returns
    the launches of the counted stages (training, generation,
    CrossAttnBlock), summed."""
    import importlib.util
    import shutil

    from infodiffusion_tpu_torch import cli, interop, runner
    from infodiffusion_tpu_torch.data import native as NAT
    from infodiffusion_tpu_torch.data.datasets import ImageFolderDataset
    from infodiffusion_tpu_torch.examples import generate, traverse
    from infodiffusion_tpu_torch.imaging import decode_png, save_image
    from infodiffusion_tpu_torch.tools import convert_checkpoint
    from infodiffusion_tpu_torch.train.checkpoint import checkpoint_root

    t0 = time.perf_counter()
    if not NAT.native_available():
        raise AssertionError(f"the native library did not build:\n"
                             f"{NAT.build_error()}")
    branch = {"libjpeg": "A (libjpeg)", "nvjpeg": "B (nvJPEG)"}[NAT.backend()]
    print(f"[reference] native library: branch {branch}, zlib PNG; build "
          f"{NAT.build_seconds():.2f} s (this process; found in "
          f"{time.perf_counter() - t0:.2f} s)")
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(REF_FIXTURES, "make_fixtures.py"))
    fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixtures)
    want = fixtures.load_expected()
    good = fixtures.good_files()
    decoded = []
    for mode, flags in fixtures.MODES.items():
        got = NAT.NativeImageBatcher(good, 64, *flags).decode(
            np.arange(len(good)))
        d = np.abs(got.astype(np.float64) - want[mode])
        decoded.append(f"{mode} mean {d.mean():.4f} max {d.max():.0f}")
        if not (d.mean() < TOL["decode_mean"]
                and d.max() <= TOL["decode_max"]):
            raise AssertionError(f"fixture decode {mode}: mean {d.mean()}, "
                                 f"max {d.max()}")
    bad = [os.path.join(REF_FIXTURES, f) for f in ("cmyk.jpg",
                                                   "truncated.jpg")]
    with no_pil():
        for path in bad:
            try:
                ImageFolderDataset(files=[path], size=64, center_crop=True) \
                    .get_batch_u8(np.arange(1))
            except IOError as exc:
                if os.path.basename(path) not in str(exc) \
                        or "PIL" not in str(exc):
                    raise AssertionError(f"{path}: {exc}") from exc
            else:
                raise AssertionError(f"{path} decoded without PIL")
    print(f"[reference] fixtures 178x218 -> 64 against PIL's decode (bars "
          f"mean < {TOL['decode_mean']}, max <= {TOL['decode_max']:.0f}): "
          f"{'; '.join(decoded)}; cmyk.jpg and truncated.jpg raise IOError "
          f"naming the file and PIL with PIL blocked")

    folder = os.path.join(work, "celeba", "img_align_celeba")
    os.makedirs(folder)
    for i in range(CLI_N):
        shutil.copyfile(good[i % len(good)],
                        os.path.join(folder, f"{i + 1:06d}.jpg"))
    common = ["--model", "diff", "--prior", "regular", "--dataset", "celeba",
              "--a_dim", str(A_DIM), "--diffusion_steps", str(T),
              "--data_dir", work, "--bf16", "--batch_size", str(CLI_BATCH),
              "--r_seed", "7"]
    cfg = cli.parse_args(common + ["--mode", "eval", "-e", str(REF_EPOCH),
                                   "--deterministic"]).with_dataset_config()
    probe = build_model(cfg, device="cpu")
    want_n = reference_expected(probe)
    del probe
    total = zero_launches()
    secs = {}

    def stage(label, fn, counted=True):
        out, dt, n = timed(fn)
        expect(f"reference {label}", n, want_n[label])
        if counted:
            for k in total:
                total[k] += n[k]
        secs[label] = dt
        return out

    cwd = os.getcwd()
    try:
        os.chdir(work)
        served = dict(NAT.counts)
        stage("train", lambda: cli.main(common + [
            "--mode", "train", "-e", "1", "--save_epochs", "1"]))
        n_img = NAT.counts["decoded"] - served.get("decoded", 0)
        n_bad = NAT.counts["failed"] - served.get("failed", 0)
        dec_s = NAT.counts["decode_s"] - served.get("decode_s", 0.0)
        n_pil = NAT.counts["pil"] - served.get("pil", 0)
        if (n_img, n_bad, n_pil) != (CLI_N, 0, 0):
            raise AssertionError(f"the native batcher served {n_img} images "
                                 f"({n_bad} failed, {n_pil} through PIL) "
                                 f"of {CLI_N}")
        print(f"[reference] train -e 1 over {CLI_N} JPEGs: {secs['train']:.2f}"
              f" s wall; the native batcher decoded all {n_img} ({n_bad} "
              f"failed) in {dec_s:.3f} s of its calls = "
              f"{n_img / dec_s:.1f} images/s (178x218 -> 64, center crop; "
              f"host clock; {smi})")

        _, img, lat = flagship(torch.bfloat16, device, seed=40)
        ref = os.path.join(work, "reference")
        os.makedirs(ref)
        pth = os.path.join(ref, f"model-{REF_EPOCH}.pth")
        lat_pth = os.path.join(ref, f"latent-{REF_EPOCH}.pth")
        sd = reference_state_dict(img)
        dead = len(sd) - len(img.state_dict())
        torch.save(sd, pth)
        torch.save(interop.export_torch_state_dict(lat), lat_pth)
        del sd
        pipe = InfoDiffusionPipeline.from_torch_checkpoint(cfg, pth,
                                                           device=device)
        lat2 = interop.load_torch_checkpoint(
            build_model(cfg, latent=True, device=device), lat_pth).eval()
        for src, dst in ((img, pipe.model), (lat, lat2)):
            have = dst.state_dict()
            diff = [k for k, v in src.state_dict().items()
                    if not torch.equal(v, have[k])]
            if diff:
                raise AssertionError(f"from_torch_checkpoint: {diff[:4]}")
        gen = torch.Generator(device=device)

        def sample(lat_model, pipeline):
            a = LatentDiffusionProcess(cfg, lat_model).sampling(
                gen.manual_seed(21), sampling_number=BATCH)
            return a, pipeline.generate(BATCH, a=a, steps=REF_STEPS,
                                        generator=gen.manual_seed(22))

        latents, images = stage("generate", lambda: sample(lat2, pipe))
        src_latents, src_images = sample(lat, InfoDiffusionPipeline(cfg, img))
        if tuple(images.shape) != (BATCH, SIZE, SIZE, 3) \
                or not torch.isfinite(images).all():
            raise AssertionError(f"generate {tuple(images.shape)}")
        if not (torch.equal(latents, src_latents)
                and torch.equal(images, src_images)):
            raise AssertionError("DDIM-100 from the .pth differs from the "
                                 "source model's")
        print(f"[reference] from_torch_checkpoint: {len(img.state_dict())} "
              f"+ {len(lat.state_dict())} parameters bitwise the source "
              f"models' ({dead} dead reference keys skipped); latents "
              f"(T={T}) then DDIM-{REF_STEPS} at B={BATCH}: "
              f"{secs['generate']:.2f} s = {BATCH / secs['generate']:.2f} "
              f"samples/s (host clock; {smi}), bitwise the source models' "
              f"samples from the same generator")
        del src_latents, src_images

        flags = ["--model", "diff", "--prior", "regular", "--dataset",
                 "celeba", "--a_dim", str(A_DIM), "--diffusion_steps", str(T)]
        t1 = time.perf_counter()
        for extra, src, latent in (([], pth, False),
                                   (["--latent"], lat_pth, True)):
            convert_checkpoint.main(flags + extra + [
                "--src", src, "--dst", os.path.join(
                    checkpoint_root(cfg, latent), f"model-{REF_EPOCH}")])
        secs["convert"] = time.perf_counter() - t1
        eval_argv = common + ["--mode", "eval", "-e", str(REF_EPOCH),
                              "--deterministic", "--sampling_steps",
                              str(CLI_STEPS)]
        stage("examples.generate", lambda: generate.main(
            eval_argv + ["--sampling_number", str(REF_EXAMPLE_N)]),
            counted=False)
        want_img = InfoDiffusionPipeline(cfg, pipe.model).generate(
            REF_EXAMPLE_N, steps=CLI_STEPS).cpu().numpy()
        save_image(want_img, "pipeline.png", normalize=True,
                   value_range=(-1.0, 1.0))
        with open("generated.png", "rb") as f, \
                open("pipeline.png", "rb") as g:
            if not np.array_equal(decode_png(f.read()), decode_png(g.read())):
                raise AssertionError("examples.generate's pixels differ from "
                                     "the pipeline's")
        del pipe, lat2
        rows = stage("examples.traverse", lambda: traverse.main(
            eval_argv + ["--img_id", "0"], n_dims=1), counted=False)
        with open("traverse-dim0.png", "rb") as f:
            if decode_png(f.read()).shape != (SIZE + 4, 11 * (SIZE + 2) + 2,
                                              3) \
                    or not np.isfinite(rows[0]).all():
                raise AssertionError("examples.traverse's row")

        written = NAT.counts["written"]
        writers = dict(runner.FID_WRITERS)
        stage("eval_fid", lambda: cli.main(common + [
            "--mode", "eval_fid", "-e", str(REF_EPOCH), "--is_latent",
            "--deterministic", "--sampling_steps", str(CLI_STEPS),
            "--sampling_number", str(CLI_BATCH)]), counted=False)
        fid_dir = os.path.join(runner.image_root(cfg), "eval-fid-latent")
        by = {k: runner.FID_WRITERS[k] - writers.get(k, 0)
              for k in ("native", "imaging")}
        if by != {"native": 1, "imaging": 0} \
                or NAT.counts["written"] - written != CLI_BATCH \
                or len(os.listdir(fid_dir)) != CLI_BATCH:
            raise AssertionError(f"eval_fid's PNGs: writers {by}, native "
                                 f"{NAT.counts['written'] - written}")
        print(f"[reference] converter .pth -> model-{REF_EPOCH} (both models) "
              f"{secs['convert']:.2f} s; examples.generate "
              f"({REF_EXAMPLE_N} at DDIM-{CLI_STEPS}) pixels equal the "
              f"pipeline's; examples.traverse over the folder (1 dim: "
              f"{T - 2} reverse steps at B=1, DDIM-{CLI_STEPS} at B=11) "
              f"{secs['examples.traverse']:.2f} s; eval_fid --is_latent "
              f"wrote its {CLI_BATCH} PNGs through the native writer")
        check_cross_attn(device, stage)
    finally:
        os.chdir(cwd)
        torch.cuda.empty_cache()
    print(f"[reference] stages (s, host clock, synchronised; {smi}): "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; launches of the "
          f"counted stages {dict((k, v) for k, v in total.items() if v)}")
    return total


class Results:
    """Per-kernel errors and times; a check over its bar raises at once."""

    def __init__(self):
        self.err = {name: [0.0, 0.0] for name in KERNELS}
        self.ms = {}

    def record(self, name, tag, abs_e, rel_e, tol):
        if not rel_e <= tol:
            raise AssertionError(
                f"{name} {tag}: relative error {rel_e:.3e} over {tol:.1e}")
        e = self.err[name]
        e[0], e[1] = max(e[0], abs_e), max(e[1], rel_e)

    def time(self, name, tag, ms, plain_ms, bound, library_ms=None):
        at_least(f"{name} {tag}", ms, bound.ms)
        self.ms[(name, tag)] = (ms, plain_ms, bound, library_ms)


def run_slice(cfg, img, lat, n, latent_gen, image_gen, *, steps,
              lat_noises=None, lat_xT=None, img_xT=None):
    latents = LatentDiffusionProcess(cfg, lat).sampling(
        latent_gen, sampling_number=n, xT=lat_xT, noises=lat_noises)
    pipe = InfoDiffusionPipeline(cfg, img)
    if img_xT is None:
        images = pipe.generate(n, a=latents, steps=steps,
                               generator=image_gen)
    else:
        images = pipe.process.sampling(xT=img_xT, a=latents,
                                       num_steps=steps).float()
    return latents, images


def end_to_end(device, smi):
    cfg, img, lat = flagship(torch.bfloat16, device)
    gen = torch.Generator(device=device)
    # warm-up (cuDNN plans, the first launches) outside the counted run
    run_slice(cfg, img, lat, BATCH, gen.manual_seed(10), None, steps=2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    latents = LatentDiffusionProcess(cfg, lat).sampling(
        gen.manual_seed(11), sampling_number=BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = InfoDiffusionPipeline(cfg, img).generate(
        BATCH, a=latents, steps=100, generator=gen.manual_seed(12))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    if tuple(images.shape) != (BATCH, SIZE, SIZE, 3):
        raise AssertionError(f"images {tuple(images.shape)}")
    if tuple(latents.shape) != (BATCH, A_DIM):
        raise AssertionError(f"latents {tuple(latents.shape)}")
    if not (torch.isfinite(images).all() and torch.isfinite(latents).all()):
        raise AssertionError("non-finite output")
    idle = [name for name in GENERATION_KERNELS if launches[name] == 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    print(f"[slice bf16] B={BATCH}: latents (T={T}) {t1 - t0:.3f} s = "
          f"{BATCH / (t1 - t0):.2f} latents/s; DDIM-100 64px "
          f"{t2 - t1:.3f} s = {BATCH / (t2 - t1):.2f} samples/s "
          f"(host clock, synchronised; {smi}); images std "
          f"{images.std().item():.3f}; launches {launches}")
    return launches


def card_vs_cpu(device):
    n = 2
    rng = np.random.RandomState(20)
    lat_xT = torch.from_numpy(rng.randn(n, A_DIM).astype(np.float32))
    noises = torch.from_numpy(rng.randn(T, n, A_DIM).astype(np.float32))
    img_xT = torch.from_numpy(rng.randn(n, SIZE, SIZE, 3).astype(np.float32))
    outs = {}
    for dev in (device, torch.device("cpu")):
        cfg, img, lat = flagship(torch.float32, dev, seed=30)
        outs[dev.type] = run_slice(
            cfg, img, lat, n, None, None, steps=10, lat_xT=lat_xT.to(dev),
            lat_noises=noises.to(dev), img_xT=img_xT.to(dev))
    errs = []
    for what, got, want in zip(("latents", "images"), outs["cuda"],
                               outs["cpu"]):
        abs_e, rel_e = rel_err(got, want)
        errs.append(f"{what} rel err {rel_e:.2e} (abs {abs_e:.2e})")
        if not rel_e <= TOL["slice"]:
            raise AssertionError(f"card vs CPU {what}: {rel_e:.3e} over "
                                 f"{TOL['slice']:.0e}")
    print(f"[card vs CPU] f32 B={n}, latents T={T} then DDIM-10: "
          f"{'; '.join(errs)} (bar {TOL['slice']:.0e})")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="",
                        help="comma-separated phases (3-23) to run after 1 "
                             "and 2 (20 runs 19 first); default all, which "
                             "also prints the kernels line")
    only = {int(p) for p in parser.parse_args().only.split(",") if p}
    if 20 in only:  # phase 20 scores phase 19's checkpoint
        only.add(19)
    clock = {"phase": None, "t0": time.perf_counter()}

    def run(phase):
        """Whether to run ``phase``; prints the wall time of the last one
        (``phase=None``: only that)."""
        if phase is not None and only and phase not in only:
            return False
        now = time.perf_counter()
        if clock["phase"] is not None and clock["phase"] != phase:
            print(f"[phase {clock['phase']}] {now - clock['t0']:.1f} s")
        if clock["phase"] != phase:
            clock.update(phase=phase, t0=now)
        return True

    smi = check_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build()
    results = Results()
    by_path = {}
    if run(3) or run(9):
        _, img32, _ = flagship(torch.float32, device)
        forward = lambda: img32(  # noqa: E731
            torch.zeros(1, SIZE, SIZE, 3, device=device),
            torch.zeros(1, dtype=torch.long, device=device),
            torch.zeros(1, A_DIM, device=device))
        gn_sites = adagn_rate.gn_sites(img32, forward)
        chainless, fused = qconv_sites(img32, forward)
        del img32
    if run(3):
        check_adagn(gn_sites, device, 10, results)
        check_foreign_plans(device)
        host = adagn_rate.host_us(gn_sites, device)
        print(f"[K1 host] bf16 B=2, {len(gn_sites)} sites, host us per "
              f"ops.norm.adagn call: forward {host['forward_us']:.2f}, "
              f"forward and backward {host['forward_backward_us']:.2f} "
              f"(tools/adagn_rate.py; as a file it times another "
              f"checkout's)")
        check_latent_route(device)
        check_attention(device, 10, results)
        lat_models = {tag: flagship(dtype, device)[2]
                      for tag, dtype in DTYPES.items()}
        check_latent_traj(lat_models, device, 1, results)
        del lat_models
        check_latent_traj_shapes(device, results)
        torch.cuda.empty_cache()
    if run(4):
        by_path["generation"] = end_to_end(device, smi)
    if run(5):
        card_vs_cpu(device)
    if run(6):
        check_adagn_bwd(train_sites(device), device, 5, results)
        check_flash(device, 5, results)
        torch.cuda.empty_cache()
    if run(7):
        for size, batch, steps in TRAIN_RUNS:
            by_path[f"train_{size}px"] = train_run(
                size, batch, steps, device, smi,
                contracts=train_contracts(size, steps))
            torch.cuda.empty_cache()
    if run(8):
        train_card_vs_cpu(device)
    if run(9):
        check_int8_conv(chainless, device, 5, results)
        check_qconv(fused, device, 5, results)
        check_latent_traj_int8(flagship(torch.bfloat16, device)[2], device,
                               results)
        torch.cuda.empty_cache()
    if run(10):
        by_path.update(int8_slice(device, smi))
        torch.cuda.empty_cache()
    if run(11):
        int8_card_vs_cpu(device)
    if run(12) or run(13):
        sites = forward_sites(device)
    if run(12):
        check_shortcut(sites["infodiff"] + sites["vanilla"], device, 10,
                       results)
        shortcut_host_us(sites["vanilla"], device)
        lat_models = {tag: flagship(dtype, device)[2]
                      for tag, dtype in DTYPES.items()}
        check_latent_mlp(lat_models, device, 10, results)
        del lat_models
        check_attention_wide(device, 10, results)
        torch.cuda.empty_cache()
    if run(13):
        by_path.update(slice_paths(device, smi, sites))
        torch.cuda.empty_cache()
    if run(14):
        slice_card_vs_cpu(device)
    if run(15):
        check_flash_wide(device, 3, results)
        # K1 and its backward at the 512px paths' shapes, timed (not in the
        # kernels line); K4 errors only
        sites = loss_sites(HIRES, device)
        for B in sorted(set(HIRES_BATCH.values())):
            check_adagn(sites, device, 2, results, B=B, line=False)
        check_adagn_bwd({HIRES: (HIRES_BATCH["train"], sites)}, device, 2,
                        results, line=False)
        check_latent_traj({tag: flagship(dtype, device)[2]
                           for tag, dtype in DTYPES.items()}, device, 0,
                          results, B=HIRES_BATCH["generate"])
        torch.cuda.empty_cache()
    if run(16):
        by_path.update(hires_paths(device, smi))
        by_path.update(tool_paths(device))
        torch.cuda.empty_cache()
    if run(17):
        hires_card_vs_cpu(device)
    if run(18):
        by_path.update(c64_paths(device, smi))
        torch.cuda.empty_cache()
        c64_card_vs_cpu(device)
    if run(19):
        import shutil
        import tempfile

        work = tempfile.mkdtemp(prefix="infodiff_cli_")
        try:
            by_path["cli"] = cli_path(device, smi, work)
            if run(20):
                by_path["metrics"] = eval_path(device, smi, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if run(21):
        import shutil
        import tempfile

        work = tempfile.mkdtemp(prefix="infodiff_reference_")
        try:
            by_path["reference"] = reference_path(device, smi, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if run(22):
        import shutil
        import tempfile

        work = tempfile.mkdtemp(prefix="infodiff_parallel_")
        try:
            by_path["parallel"] = parallel_path(device, smi, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if run(23):
        import shutil
        import tempfile

        work = tempfile.mkdtemp(prefix="infodiff_tools_")
        try:
            by_path.update(remat_and_tools(device, smi, work))
        finally:
            shutil.rmtree(work, ignore_errors=True)
    run(None)  # the last phase's time
    if not only:
        print(json.dumps({"kernels": kernel_lines(results, by_path)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# phase 22: the parallel layouts. The card's machine has one card, so NCCL
# runs at world size 1 there; two ranks share the card over gloo only where
# the probe shows gloo moves CUDA tensors
PARALLEL_TOL = {"two_rank": 2e-3, "ring": 2e-2}
RING_SHAPE = (1, 16384, 128)  # the 512px InfoDiff's level-2 attention
PARALLEL_CLI = ["--model", "diff", "--prior", "regular", "--dataset", "mnist",
                "--a_dim", "32", "--data_dir", "synthetic",
                "--diffusion_steps", "50", "--batch_size", "16", "--r_seed",
                "7", "--ch_mult", "1,2", "--attn", "1", "--save_epochs", "1",
                "--fsdp"]
PARALLEL_CLI_N = 64  # synthetic images: 4 steps an epoch


# the collectives each two-rank check calls, as its code calls them: the
# step's batch means and flat gradient bucket (all_reduce), the MMD's latent
# gather and the gathered state (list all_gather), FSDP's split gradients
# (list reduce_scatter, parallel/layout.py); the ring's K/V rotation
# (batch_isend_irecv) and its output gather
PROBE_OPS = ("all_reduce", "all_gather", "reduce_scatter",
             "batch_isend_irecv")
TWO_RANK_OPS = {"dp": ("all_reduce", "all_gather"),
                "fsdp": ("all_reduce", "all_gather", "reduce_scatter"),
                "ring": ("batch_isend_irecv", "all_gather")}
# relative L2 error of the two-rank step's gradient (Adam's first moment,
# gathered whole) against the one-process step's: the weight gradients
# come out of the bf16 convolutions rounded to bf16 (2**-8 relative), and
# the two ranks' shares are rounded apart before they are summed
GRAD_TOL = 1e-2
# the metrics held to PARALLEL_TOL["two_rank"]: the losses and the grad
# norm (the recon term, a vanishing share of the loss on which a relative
# bar says nothing, is printed beside them)
TWO_RANK_KEYS = ("loss", "denoise", "mmd", "grad_norm")


def _probe_rank(ops=PROBE_OPS):
    """Each collective of ``ops``, called on CUDA tensors over this group
    as the layouts and the ring call it: {name: 'ok', 'wrong result' or
    the error}."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    of = lambda r: torch.arange(4, dtype=torch.float32, device=dev) + r  # noqa: E731
    x = of(rank)
    total = sum(of(r) for r in range(world))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=dist.group.WORLD)
        return torch.equal(y, total)

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=dist.group.WORLD)
        return all(torch.equal(p, of(r)) for r, p in enumerate(parts))

    def reduce_scatter():
        n = 4 // world
        piece = torch.empty(n, device=dev)
        dist.reduce_scatter(piece, list(x.chunk(world)),
                            group=dist.group.WORLD)
        return torch.equal(piece, total[rank * n:(rank + 1) * n])

    def batch_isend_irecv():
        buf = torch.empty_like(x)
        group = dist.group.WORLD
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world, group),
                dist.P2POp(dist.irecv, buf, (rank - 1) % world, group)]):
            req.wait()
        return torch.equal(buf, of((rank - 1) % world))

    fns = dict(zip(PROBE_OPS, (all_reduce, all_gather, reduce_scatter,
                               batch_isend_irecv)))
    out = {}
    for name in ops:
        fn = fns[name]
        try:
            ok = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()
    return out


def _two_rank(checks, ref_grad, seed=0):
    """Two ranks on the card over gloo, the ``checks`` of TWO_RANK_OPS the
    probe let through: the flagship step at B=128 split 64/64, data-
    parallel and FSDP, with its gradient (Adam's first moment, gathered
    whole) against the one-process step's (``ref_grad``, a file); the
    2-way ring at RING_SHAPE against the one-rank route (rank 0's)."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.ops.attention import single_head_attention
    from infodiffusion_tpu_torch.parallel.layout import Layout, describe
    from infodiffusion_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from infodiffusion_tpu_torch.parallel.ring_attention import ring_attention

    torch.cuda.set_device(0)
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    want = [t.to(device) for t in torch.load(ref_grad)] \
        if {"dp", "fsdp"} & set(checks) else None
    for kind in ("dp", "fsdp"):
        if kind not in checks:
            continue
        model = train_model(torch.bfloat16, device, SIZE, seed)
        tx = make_optimizer(LR, 50, 1000)
        state = create_train_state(model, 0, tx)
        layout = Layout.for_model(model, make_mesh(2), fsdp=kind == "fsdp")
        state = layout.shard_state(model, state)
        x = shard_batch(layout.mesh, _parallel_batch(device))
        step = make_train_step(model, tx, layout=layout)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, x, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = [layout.whole(n, t) for n, t in zip(state.params,
                                                  state.opt_state.mu)]
        diff = sum((g - w).square().sum() for g, w in zip(got, want))
        norm = sum(w.square().sum() for w in want)
        out[kind] = {"rows": int(x.shape[0]), "step_s": dt,
                     "layout": describe(layout),
                     "grad_rel": float((diff / norm).sqrt()),
                     **{k: float(v) for k, v in metrics.items()}}
        del model, state, step, x, got
        torch.cuda.empty_cache()
    if "ring" in checks:
        rs = np.random.RandomState(seed + 1)
        q, k, v = (torch.from_numpy(rs.randn(*RING_SHAPE).astype(np.float32))
                   .to(device, torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ring = ring_attention(q, k, v, dist.group.WORLD)
            torch.cuda.synchronize()
            out["ring"] = {"s": time.perf_counter() - t0}
            if dist.get_rank() == 0:
                dense = single_head_attention(q, k, v)
                out["ring"]["abs"], out["ring"]["rel"] = rel_err(
                    ring.float(), dense.float())
    return out


def _parallel_batch(device):
    return torch.from_numpy(np.random.RandomState(SIZE).randn(
        BATCH, SIZE, SIZE, 3).astype(np.float32)).to(device)


def _spawn(target, world, timeout, work, **args):
    from infodiffusion_tpu_torch.parallel.launch import spawn

    here = os.path.dirname(os.path.abspath(__file__))
    return spawn(f"chip_smoke:{target}", world, args, workdir=work,
                 timeout=timeout, backend="gloo", pythonpath=[here],
                 env={"INFODIFF_FORCE_CPU": ""})


def _max_diff(a: dict, b: dict) -> float:
    return max((a[n] - b[n]).abs().max().item() for n in a)


def _one_rank_steps(device, smi, ref_grad):
    """World size 1 over NCCL: the flagship step one-process (twice, to see
    whether it repeats bitwise), data-parallel and FSDP, from one set of
    weights; returns (the one-process metrics, the layouts' launches) and
    writes the one-process step's Adam first moment to ``ref_grad``."""
    import torch.distributed as dist

    from infodiffusion_tpu_torch.parallel.layout import Layout, describe
    from infodiffusion_tpu_torch.parallel.mesh import make_mesh

    base = train_model(torch.bfloat16, device, SIZE)
    gn_u, gn_e, at_u, at_e = flagship_sites(base)
    want = launch_counts(k1=gn_u + gn_e, k1_bwd=gn_u + gn_e, k2=at_u + at_e,
                         dense=at_u + at_e)
    if (want["adagn"], want["attention"]) != (124, 12):
        raise AssertionError(f"flagship sites {gn_u, gn_e, at_u, at_e}")
    x = _parallel_batch(device)
    runs, total = {}, zero_launches()
    for label, kind in (("one-process", None), ("one-process again", None),
                        ("dp", "dp"), ("fsdp", "fsdp")):
        model = copy.deepcopy(base)
        tx = make_optimizer(LR, 50, 1000)
        state = create_train_state(model, 0, tx)
        layout = None
        if kind is not None:
            layout = Layout.for_model(model, make_mesh(1),
                                      fsdp=kind == "fsdp")
            state = layout.shard_state(model, state)
        step = make_train_step(model, tx, layout=layout)
        (state, metrics), dt, n = timed(lambda: step(state, x, 0))
        if kind is not None:
            expect(f"parallel world 1 {kind}", n, want)
            for key in total:
                total[key] += n[key]
        params = {k: v.detach().clone() for k, v in state.params.items()}
        runs[label] = ({k: float(v) for k, v in metrics.items()}, params)
        if label == "one-process":
            torch.save([t.detach().cpu() for t in state.opt_state.mu],
                       ref_grad)
        print(f"[parallel] world 1 NCCL, {label} ({describe(layout)}): "
              f"{dt:.3f} s (host clock, synchronised, the step's first call; "
              f"{smi}); loss {runs[label][0]['loss']:.6f}, grad_norm "
              f"{runs[label][0]['grad_norm']:.6f}; launches "
              f"{ {k: v for k, v in n.items() if v} }")
        del model, state, step
    ref_m, ref_p = runs["one-process"]
    repeat = _max_diff(runs["one-process again"][1], ref_p)
    for label in ("dp", "fsdp"):
        m, p = runs[label]
        d = _max_diff(p, ref_p)
        dm = {k: abs(m[k] - ref_m[k]) for k in ref_m}
        print(f"[parallel] world 1 {label} against one process: params max "
              f"|diff| {d:.3e}, metrics |diff| "
              f"{ {k: f'{v:.3e}' for k, v in dm.items()} } (the one-process "
              f"step against itself: {repeat:.3e})")
        if repeat == 0.0:
            if d != 0.0 or any(dm.values()):
                raise AssertionError(f"world 1 {label} not bitwise the "
                                     f"one-process step")
        elif d > 4 * repeat or any(
                v > PARALLEL_TOL["two_rank"] * abs(ref_m[k])
                for k, v in dm.items()):
            raise AssertionError(f"world 1 {label}: params {d:.3e}, "
                                 f"metrics {dm}")
    print(f"[parallel] world 1: dp and fsdp "
          f"{'bitwise' if repeat == 0.0 else 'within the repeat bars'} of "
          f"the one-process step (at one rank FSDP splits no parameter, so "
          f"this covers its unsplit path); launches per laid-out step "
          f"exactly {want}")
    del base, runs
    torch.cuda.empty_cache()
    return ref_m, total


def _torchrun_cli(work, smi):
    """The mnist recipe through torchrun at one rank: -e 1, then -e 2
    --resume; exactly one metrics file and one checkpoint an epoch.
    Returns the lines to print."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, INFODIFF_SYNTHETIC_N=str(PARALLEL_CLI_N),
               PYTHONPATH=here)
    env.pop("INFODIFF_FORCE_CPU", None)
    cli_dir = os.path.join(work, "cli")
    os.makedirs(cli_dir)
    report_lines = []
    for extra in (["--mode", "train", "-e", "1"],
                  ["--mode", "train", "-e", "2", "--resume"]):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "infodiffusion_tpu_torch",
             *PARALLEL_CLI, *extra], cwd=cli_dir, env=env,
            capture_output=True, text=True, timeout=300)
        dt = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"torchrun {extra}: {out.stdout[-2000:]}"
                                 f"{out.stderr[-3000:]}")
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("[parallel]", "Resumed", "Saved"))]
        report_lines.append(
            f"[parallel] torchrun --nproc_per_node 1 {' '.join(extra)}: "
            f"{dt:.1f} s wall (process start included, beside the world-1 "
            f"steps and the probe; {smi}): {lines}")
    files = sorted(os.path.relpath(os.path.join(d, f), cli_dir)
                   for d, _, fs in os.walk(cli_dir) for f in fs)
    want = ["logs/mnist_32d_0.1mmd/metrics.jsonl",
            "models/mnist_32d_0.1mmd/model-1/meta.json",
            "models/mnist_32d_0.1mmd/model-1/state.pt",
            "models/mnist_32d_0.1mmd/model-2/meta.json",
            "models/mnist_32d_0.1mmd/model-2/state.pt"]
    if files != want:
        raise AssertionError(f"torchrun files {files}")
    root = os.path.join(cli_dir, "models", "mnist_32d_0.1mmd")
    steps = [json.load(open(os.path.join(root, f"model-{e}", "meta.json")))
             ["step"] for e in (1, 2)]
    with open(os.path.join(cli_dir, files[0])) as f:
        losses = [json.loads(ln)["train/loss"] for ln in f]
    if steps != [4, 8] or len(losses) != 2 or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"torchrun: steps {steps}, losses {losses}")
    report_lines.append(
        f"[parallel] torchrun: one metrics file ({len(losses)} lines, "
        f"losses {losses}), checkpoints model-1 (step 4) and model-2 "
        f"(step 8), nothing else written")
    return report_lines


def _probe_op(op: str, work: str) -> str:
    """One collective, in two fresh processes (a collective gloo refuses on
    CUDA tensors may abort the process rather than raise)."""
    try:
        ranks = _spawn("_probe_rank", 2, 120, work, ops=(op,))
    except TimeoutError:
        return "hung (120 s)"
    except RuntimeError as e:
        # the rank that failed first, not its peer's "connection closed"
        lines = [ln.strip() for ln in str(e).splitlines()
                 if ("rror" in ln or "what()" in ln or "terminate" in ln)
                 and "Connection closed" not in ln]
        return "aborted: " + (lines[0][:200] if lines else
                              str(e).splitlines()[0][:200])
    bad = [r[op] for r in ranks if r[op] != "ok"]
    return bad[0] if bad else "ok"


def parallel_path(device, smi, work):
    """Phase 22 (see the module docstring). Returns the launches of the
    world-1 data-parallel and FSDP steps. The probe's processes and the
    torchrun runs proceed beside the world-1 steps."""
    import concurrent.futures

    import torch.distributed as dist

    ref_grad = os.path.join(work, "ref_grad.pt")
    with concurrent.futures.ThreadPoolExecutor(len(PROBE_OPS) + 1) as pool:
        probes = {op: pool.submit(_probe_op, op, work) for op in PROBE_OPS}
        cli = pool.submit(_torchrun_cli, work, smi)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(work, "store"), 1),
            rank=0, world_size=1)
        try:
            nccl = _probe_rank()
            print(f"[parallel] NCCL at world size 1 (FileStore rendezvous), "
                  f"the same collectives: {nccl}")
            if any(v != "ok" for v in nccl.values()):
                raise AssertionError(f"NCCL at world size 1: {nccl}")
            ref, launches = _one_rank_steps(device, smi, ref_grad)
        finally:
            dist.destroy_process_group()
        verdict = {op: f.result() for op, f in probes.items()}
        for line in cli.result():
            print(line)
    failed = [op for op, v in verdict.items() if v != "ok"]
    runs = [c for c, ops in TWO_RANK_OPS.items()
            if not set(ops) & set(failed)]
    print(f"[parallel probe] two processes on one card over gloo with CUDA "
          f"tensors: {verdict}: "
          f"{'FAILED for ' + ', '.join(failed) if failed else 'PASSED'}; "
          f"two-rank checks that run: {runs or 'none'}")
    for c in TWO_RANK_OPS:
        if c not in runs:
            print(f"[parallel] the two-rank {c} check calls "
                  f"{[op for op in TWO_RANK_OPS[c] if op in failed]}, which "
                  f"the probe failed: it does not run on the card, and no "
                  f"result of it is claimed from the card")
    if not runs:
        return launches
    two = _spawn("_two_rank", 2, 300, work, checks=runs, ref_grad=ref_grad)
    r0 = two[0]
    for kind in ("dp", "fsdp"):
        if kind not in runs:
            continue
        r = r0[kind]
        rel = {k: abs(r[k] - ref[k]) / abs(ref[k]) for k in TWO_RANK_KEYS}
        print(f"[parallel] two ranks on the card over gloo, {r['layout']}, "
              f"B=128 as 64 + 64 rows: loss {r['loss']:.6f}, grad_norm "
              f"{r['grad_norm']:.6f}, recon {r['recon']:.6e} against one "
              f"process's {ref['loss']:.6f}, {ref['grad_norm']:.6f}, "
              f"{ref['recon']:.6e} (rel "
              f"{ {k: f'{v:.3e}' for k, v in rel.items()} }, bar "
              f"{PARALLEL_TOL['two_rank']}); gradient rel L2 "
              f"{r['grad_rel']:.3e} (bar {GRAD_TOL}); step "
              f"{r['step_s']:.3f} s (host clock, the first call; {smi})")
        if r["rows"] != BATCH // 2 or r["grad_rel"] > GRAD_TOL or any(
                v > PARALLEL_TOL["two_rank"] for v in rel.values()):
            raise AssertionError(f"two-rank {kind} step: {r}")
    if "ring" in runs:
        r = r0["ring"]
        print(f"[parallel] two ranks on the card over gloo: ring "
              f"{RING_SHAPE} bf16 2-way against the one-rank route: max abs "
              f"{r['abs']:.3e}, rel {r['rel']:.3e} (bar "
              f"{PARALLEL_TOL['ring']}), {r['s']:.3f} s (host clock; {smi})")
        if not r["rel"] <= PARALLEL_TOL["ring"]:
            raise AssertionError(f"two-rank ring: {r['rel']:.3e}")
    return launches


# phase 23: INFODIFF_REMAT=1 and the measurement tools. The remat runs:
# (image size, batch, train steps); the remat step's loss and gradient
# against the plain step's, from the same weights and dropout draws: the
# loss within REMAT_LOSS_TOL relative, the gradient within GRAD_TOL
# relative L2 (the recompute repeats the forward's arithmetic; what can
# differ is cuDNN's and the backward's order of summation, printed beside
# as the plain step against itself)
REMAT_RUNS = ((64, BATCH, 2), (HIRES, HIRES_BATCH["train"], 1))
REMAT_LOSS_TOL = 1e-3
# the forward kernels: under remat each launch inside a ResBlock happens
# again in the backward's recompute; the backward kernels do not repeat
FORWARD_KERNELS = ("adagn", "attention", "flash_attention",
                   "flash_attention_online")
TOOLS_N = {"corpus": 2048, "fid_samples": 256, "fid_real": 512,
           "fid_train": 256, "ltb_reps": 5, "repr_epochs": 1}
TRACE_CLI = ["--model", "diff", "--prior", "regular", "--dataset", "mnist",
             "--a_dim", "32", "--data_dir", "synthetic", "--diffusion_steps",
             "50", "--batch_size", "16", "--r_seed", "7", "-e", "1",
             "--mode", "train", "--save_epochs", "1"]


def _grad_rel_l2(got, want) -> float:
    num = sum(float((g.float() - w.float()).pow(2).sum())
              for g, w in zip(got, want))
    den = sum(float(w.float().pow(2).sum()) for w in want)
    return math.sqrt(num / den)


def _in_block_launches(model, run):
    """Launches per kernel inside the ResBlocks (the blocks remat wraps)
    during ``run()``, counted by hooks around each block's forward."""
    from infodiffusion_tpu_torch.nn.blocks import _ResBlockBase

    inside = zero_launches()
    at = {}

    def pre(mod, args):
        at[mod] = read_launches()

    def post(mod, args, out):
        now = read_launches()
        for k in inside:
            inside[k] += now[k] - at[mod][k]

    handles = []
    for m in model.modules():
        if isinstance(m, _ResBlockBase):
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return inside


def remat_check(size, batch, steps, device, smi):
    """One remat run: the gradient check, then ``steps`` train steps each
    way from the same weights (peak memory, event time, launches; the
    remat steps' launches, exactly the plain steps' plus the recompute,
    are returned)."""
    base = train_model(torch.bfloat16, device, size)
    x = torch.from_numpy(np.random.RandomState(size).randn(
        batch, size, size, 3).astype(np.float32)).to(device)

    def grads():
        return loss_and_grads(base, x, 0, deterministic=False,
                              rngs=step_rngs(0, 0, device))

    torch.cuda.synchronize()
    reset_launches()
    inside = _in_block_launches(base, grads)
    torch.cuda.synchronize()
    plain_n = read_launches()
    loss_p, _, g_p = grads()
    loss_p2, _, g_p2 = grads()
    with env_set({"INFODIFF_REMAT": "1"}):
        torch.cuda.synchronize()
        reset_launches()
        loss_r, _, g_r = grads()
        torch.cuda.synchronize()
        remat_n = read_launches()
    want = {k: plain_n[k] + (inside[k] if k.split("_c")[0] in
                             FORWARD_KERNELS else 0) for k in plain_n}
    expect(f"remat {size}px loss_and_grads", remat_n, want)
    loss_rel = abs(float(loss_r) - float(loss_p)) / abs(float(loss_p))
    rel, rel_self = _grad_rel_l2(g_r, g_p), _grad_rel_l2(g_p2, g_p)
    del g_p, g_p2, g_r
    recompute = {k: v for k, v in inside.items() if v}
    print(f"[remat] {size}px B={batch}, bf16, dropout on, one loss and "
          f"gradient each way: loss {float(loss_p):.6f} plain, "
          f"{float(loss_r):.6f} remat (rel {loss_rel:.3e}, bar "
          f"{REMAT_LOSS_TOL}); gradient rel L2 {rel:.3e} (bar {GRAD_TOL}; "
          f"the plain step against itself {rel_self:.3e}, loss "
          f"{'bitwise' if float(loss_p2) == float(loss_p) else 'not bitwise'}"
          f"); launches inside the ResBlocks a forward {recompute}, run "
          f"again under remat: exact")
    if not (loss_rel <= REMAT_LOSS_TOL and rel <= GRAD_TOL):
        raise AssertionError(f"remat {size}px: loss rel {loss_rel:.3e}, "
                             f"gradient rel L2 {rel:.3e}")
    out = {}
    for remat in (False, True):
        model = copy.deepcopy(base)
        tx = make_optimizer(LR, 50, 1000)
        state = create_train_state(model, seed=0, tx=tx)
        step = make_train_step(model, tx)
        with env_set({"INFODIFF_REMAT": "1" if remat else "0"}):
            state, _ = step(state, x, 0)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                state, metrics = step(state, x, 0)
            end.record()
            torch.cuda.synchronize()
        out[remat] = dict(ms=start.elapsed_time(end) / steps,
                          peak=torch.cuda.max_memory_allocated(),
                          launches=read_launches(),
                          loss=float(metrics["loss"]))
        del model, state, step, tx
        torch.cuda.empty_cache()
    want = {k: out[False]["launches"][k] + steps * (
        inside[k] if k.split("_c")[0] in FORWARD_KERNELS else 0)
        for k in out[False]["launches"]}
    expect(f"remat {size}px train steps", out[True]["launches"], want)
    p, r = out[False], out[True]
    print(f"[remat] {size}px B={batch}, {steps} train steps each way: "
          f"plain {p['ms']:.2f} ms a step, peak {p['peak'] / 2**30:.2f} GiB;"
          f" remat {r['ms']:.2f} ms a step, peak {r['peak'] / 2**30:.2f} GiB"
          f" (event time, the first step warm; {smi}); losses "
          f"{p['loss']:.6f} / {r['loss']:.6f}; remat launches "
          f"{ {k: v for k, v in r['launches'].items() if v} }, exactly the "
          f"plain steps' plus the recompute")
    if abs(r["loss"] - p["loss"]) > REMAT_LOSS_TOL * abs(p["loss"]):
        raise AssertionError(f"remat {size}px: train losses {p['loss']} "
                             f"and {r['loss']}")
    return out[True]["launches"], batch * 1e3 / p["ms"]


def _tool(label, fn, needed=(), want=None):
    """Run one tool (launches counted from zero); fail unless each kernel
    in ``needed`` launched (exactly ``want`` where given)."""
    out, dt, n = timed(fn)
    idle = [k for k in needed if not n[k]]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle}")
    if want is not None:
        expect(label, n, want)
    print(f"[tools] {label}: {dt:.2f} s wall; launches "
          f"{ {k: v for k, v in n.items() if v} }")
    return out, n


def _check_summary(label, summary, categories):
    """A trace summary of the card: device events, an idle share in
    [0, 1], and each category in ``categories`` with device time."""
    cats = summary["by_category_ms"]
    missing = [c for c in categories if not cats.get(c)]
    if not summary["device_events"] or missing or not (
            0.0 <= summary["idle_share"] <= 1.0):
        raise AssertionError(f"{label}: trace summary {summary}")
    gaps = [(round(g["ms"], 3), g["host_op"]) for g in summary["gaps"][:3]]
    print(f"[trace_summary] {label}: device {summary['device_ms']:.2f} ms "
          f"in a {summary['window_ms']:.2f} ms window, idle share "
          f"{summary['idle_share']:.3f}; by category (ms) "
          f"{ {c: round(v, 3) for c, v in cats.items()} }; longest gaps "
          f"(ms, host op) {gaps}")


def tools_path(device, smi, work, train_rate):
    """Phase 23's tools at reduced sizes; returns their launches."""
    from infodiffusion_tpu_torch.metrics import inception as INC
    from infodiffusion_tpu_torch.tools import (
        flops_report,
        latent_turbo_bench,
        memory_report,
        pipeline_rehearsal,
        profile_sampler,
        profile_train,
        repr_learning_demo,
        trace_summary,
        turbo_fid_delta,
        verify_inception_weights,
    )

    by_path = {}
    fl, _ = _tool("flops_report", lambda: flops_report.main(
        train_imgs_per_s=train_rate, card=smi))
    fwd = fl["forward_gflop_per_sample"]
    if not (fwd["counted_on"] == "meta" and 0 < fwd["valid_taps"]["total"]
            < fwd["all_taps"]["total"]):
        raise AssertionError(f"flops_report: {fwd}")
    print(f"[flops] forward {fwd['valid_taps']['total']:.6f} GFLOP a "
          f"sample (valid taps, the mfu basis; {fwd['all_taps']['total']:.6f}"
          f" with the padding taps), train step "
          f"{fl['train_step_gflop_per_image']['valid_taps']['total']:.6f}"
          f" GFLOP an image, counted on {fwd['counted_on']}; the 64px "
          f"train rate {train_rate:.2f} imgs/s of phase 23 is "
          f"{fl['train_achieved']['tflops']:.2f} TFLOP/s, "
          f"{fl['train_achieved']['share']:.2%} of the H100 SXM's dense "
          f"bf16 peak ({smi})")
    with env_set({"INFODIFF_MEMREPORT_PROGRAMS": "sampel"}):
        try:
            memory_report.main()
        except SystemExit as exc:
            print(f"[tools] memory_report refuses a typo: {exc}")
        else:
            raise AssertionError("memory_report took a typo")
    steps2 = {"INFODIFF_BENCH_STEPS": "2"}
    for label, env, needed in (
            ("memory_64px", steps2, ("adagn_bwd", "attention")),
            ("memory_64px_remat", {**steps2, "INFODIFF_REMAT": "1",
                                   "INFODIFF_MEMREPORT_PROGRAMS": "train"},
             ("adagn_bwd", "attention")),
            ("memory_512px_sampler", {
                **steps2, "INFODIFF_BENCH_SIZE": str(HIRES),
                "INFODIFF_BENCH_BATCH": str(HIRES_BATCH["generate"]),
                "INFODIFF_MEMREPORT_PROGRAMS": "sampler"},
             ("flash_attention_online",))):
        with env_set(env):
            rows, n = _tool(f"memory_report {env}", memory_report.main,
                            ("adagn",) + needed)
        by_path[label] = n
        for r in rows:
            if not 0 < r["allocated_share"] <= r["reserved_share"] < 1:
                raise AssertionError(f"memory_report: {r}")
            print(f"[memory] {r['program']} {r['model']} B={r['batch']} "
                  f"remat {r['remat']}: peak allocated "
                  f"{r['peak_allocated_bytes'] / 2**30:.3f} GiB "
                  f"({r['allocated_share']:.2%}), reserved "
                  f"{r['peak_reserved_bytes'] / 2**30:.3f} GiB "
                  f"({r['reserved_share']:.2%}) of {r['card']}")
    for turbo, needed, cats in (("", ("attention",), ("K2 attention",)),
                                ("int8", ("int8_conv",), ("int8 conv",))):
        row, n = _tool(f"profile_sampler turbo={turbo!r}",
                       lambda: profile_sampler.main(
                           os.path.join(work, f"trace_sampler{turbo}"),
                           device, batch=BATCH, steps=2, turbo=turbo),
                       ("adagn",) + needed)
        by_path[f"profile_sampler{turbo}"] = n
        _check_summary(f"DDIM-2 B={BATCH} turbo={turbo!r}", row["summary"],
                       ("K1 adagn",) + cats)
    row, n = _tool("profile_train", lambda: profile_train.main(
        os.path.join(work, "trace_train"), device, batch=BATCH),
        ("adagn", "adagn_bwd", "attention", "flash_attention_bwd"))
    by_path["profile_train"] = n
    _check_summary(f"train step B={BATCH}", row["summary"],
                   ("K1 adagn", "K1-bwd adagn_bwd", "K2 attention",
                    "K3b flash_attention_bwd"))
    reps = TOOLS_N["ltb_reps"]
    per = 2 + reps  # the max_abs_diff call, the warm-up, the reps
    rows, n = _tool("latent_turbo_bench", lambda: latent_turbo_bench.main(
        device, reps=reps), want={"latent_traj": 3 * per,
                                  "latent_traj_int8": 3 * per})
    by_path["latent_turbo_bench"] = n
    for r in rows:
        print(f"[latent int8] a_dim {r['a_dim']} B={r['batch']} T={r['T']} "
              f"route {r['route']}: bf16 {r['bf16_ms']:.3f} ms (spread "
              f"{r['bf16_spread_ms']:.3f}), int8 {r['int8_ms']:.3f} ms "
              f"(spread {r['int8_spread_ms']:.3f}), speedup "
              f"{r['speedup']:.3f}, significant {r['significant']}, max abs "
              f"diff {r['max_abs_diff']:.4f} ({smi})")
    jpegs = os.path.join(work, "jpegs")
    v, n = _tool("pipeline_rehearsal", lambda: pipeline_rehearsal.main(
        ["--n", str(TOOLS_N["corpus"]), "--dir", jpegs, "--decode-limit",
         str(TOOLS_N["corpus"]), "--encode-limit", str(TOOLS_N["corpus"])]),
        ("adagn", "attention"))
    by_path["pipeline_rehearsal"] = n
    print(f"[pipeline] {v['corpus_files']} JPEGs (178x218, q85, mean "
          f"{v['mean_jpeg_kb']:.2f} KB): {v['native_backend']} "
          f"{v['native_decode_imgs_per_sec']:.1f} images/s on "
          f"{v['host_cores']} cores, PIL {v['pil_decode_imgs_per_sec']:.1f};"
          f" the Encoder (B=256) {v['device_encode_imgs_per_sec']:.1f} "
          f"images/s; save_latent end to end "
          f"{v['save_latent_e2e_imgs_per_sec']:.1f}; cores for the encode "
          f"rate {v['cores_for_compute_bound']:.2f}, decode keeps up: "
          f"{v['decode_keeps_up']} (host clock, synchronised; {smi})")
    with env_set({"INFODIFF_TFD_DIR": os.path.join(work, "tfd"),
                  "INFODIFF_TFD_EPOCHS": "1",
                  "INFODIFF_TFD_SAMPLES": str(TOOLS_N["fid_samples"]),
                  "INFODIFF_TFD_REAL_N": str(TOOLS_N["fid_real"]),
                  "INFODIFF_SYNTHETIC_N": str(TOOLS_N["fid_train"])}):
        rec, n = _tool("turbo_fid_delta", turbo_fid_delta.main,
                       ("adagn", "adagn_bwd", "attention", "latent_traj",
                        "int8_conv"))
    by_path["turbo_fid_delta"] = n
    if not all(math.isfinite(rec[k]) for k in ("fid_bf16", "fid_int8",
                                               "real_floor")):
        raise AssertionError(f"turbo_fid_delta: {rec}")
    print(f"[turbo_fid_delta] 1 epoch, {rec['n_samples']} samples a tier: "
          f"FID bf16 {rec['fid_bf16']:.4f}, int8 {rec['fid_int8']:.4f}, "
          f"delta {rec['delta']:.4f} ({rec['delta_vs_bf16_pct']:.3f}%), "
          f"real floor {rec['real_floor']:.4f}: {rec['verdict']} "
          f"({rec['extractor']})")
    out, n = _tool("repr_learning_demo", lambda: repr_learning_demo.main(
        [os.path.join(work, "repr"), "--epochs",
         str(TOOLS_N["repr_epochs"])]), ("adagn", "adagn_bwd"))
    by_path["repr_learning_demo"] = n
    if not out["ridge_r2"] or not all(map(math.isfinite,
                                          out["ridge_r2"].values())):
        raise AssertionError(f"repr_learning_demo: {out}")
    print(f"[repr] {TOOLS_N['repr_epochs']} epoch on 2,048 sprites, latents "
          f"{out['latents']}: ridge R^2 "
          f"{ {k: round(v, 4) for k, v in out['ridge_r2'].items()} }")
    # a short CLI train (the verify recipe: mnist, B=16, 21 steps) with
    # INFODIFF_PROFILE set: the runner traces steps 10-20
    runner_trace = os.path.join(work, "runner_trace")
    with in_directory(os.path.join(work, "cli_trace")):
        _, n = _tool("CLI train under INFODIFF_PROFILE", lambda: run_cli(
            TRACE_CLI, {"INFODIFF_PROFILE": runner_trace,
                        "INFODIFF_SYNTHETIC_N": str(21 * 16)}),
            ("adagn", "adagn_bwd"))
    by_path["cli_trace"] = n
    _check_summary("the runner's trace (INFODIFF_PROFILE, steps 10-20 of "
                   "a CLI train)",
                   trace_summary.main([runner_trace, "--top", "5"]),
                   ("K1 adagn", "K1-bwd adagn_bwd"))
    fixture = os.path.join(work, "pt_inception-fixture.pth")
    sd = INC.random_state_dict(seed=7)
    torch.save(sd, fixture)
    broken = os.path.join(work, "pt_inception-broken.pth")
    torch.save({k: v for k, v in sd.items()
                if k != "Mixed_7c.branch_pool.conv.weight"}, broken)
    rc = verify_inception_weights.main([fixture])
    rc_broken = verify_inception_weights.main([broken])
    print(f"[tools] verify_inception_weights: exit {rc} on the fixture "
          f"(forward on the card), {rc_broken} on it with a key removed")
    if (rc, rc_broken) != (0, 1):
        raise AssertionError("verify_inception_weights: exit codes "
                             f"{rc}, {rc_broken}")
    return by_path


def remat_and_tools(device, smi, work):
    """Phase 23: the remat check at 64px and 512px, then every tool."""
    by_path, train_rate = {}, None
    for size, batch, steps in REMAT_RUNS:
        by_path[f"remat_{size}px"], rate = remat_check(size, batch, steps,
                                                       device, smi)
        train_rate = train_rate or rate
        torch.cuda.empty_cache()
    by_path.update(tools_path(device, smi, work, train_rate))
    return by_path



def kernel_lines(results, by_path):
    kernels = []
    for name, spec in KERNELS.items():
        ms, plain_ms, bound, library_ms = results.ms[(name, "bf16")]
        kernels.append({
            "name": name, "route": spec["route"], "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": results.err[name][0],
            "max_rel_err": results.err[name][1],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.ms,
            "bound_by": bound.by, "library_ms": library_ms,
            "library_call": spec.get("library"), "timed_dtype": "bf16",
        })
    return kernels


if __name__ == "__main__":
    main()
