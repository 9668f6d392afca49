#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``msid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, the result lines
    python3 chip_smoke.py kernel kernel_fp32   # those phases alone (also widths, noise, norm, layernorm,
                                               # probe, hybrid,
                                               # scene, train, data_cache, export,
                                               # decoders, perceptual, pretrained,
                                               # parallel, nccl_shared, examples),
                                               # no result lines

From the repository root, on a machine with a CUDA card, ``nvcc`` and no
network. Phases, each of which must pass:

1. build: compile the six sources of ``msid_tpu_torch/csrc/`` (resblock,
   which holds K1 and K3 and includes ``hopper_common.cuh``; noise,
   resblock_fp32, any_dma, batchnorm, layernorm) for sm_90a, one ``nvcc`` per source (eleven for
   resblock, one per padded width), started together, with each build's
   seconds;
2. kernel: the fused ResidualBlock kernel (K1, wgmma) against its plain
   PyTorch version at the flagship decoder's four shapes, B=1 and B=16
   (rtol 0.03 / atol 0.02), after one tiny launch synchronised on its
   own, with its tile, cluster and time beside the plain version's, a
   cuDNN bf16 composition's and the card's bound;
3. kernel_fp32: the fp32 fused ResidualBlock (K4, 3xTF32 on the tensor
   cores) against its plain version at the four flagship shapes and two
   tiny widths (C=8 @ 64², C=24 @ 16²), B=1 and B=16 (max abs error <=
   1e-4, relative RMS <= 1e-5, TF32 off), with its geometry and time
   beside the plain version's, a cuDNN fp32 composition's, the bound of
   three TF32 passes on the tensor cores and the bound at the fp32 FMA
   peak;
4. noise: the fused corruption kernel (K2) against its plain version at
   [64,192,192,13] and [4,192,192,13] fp32 and [16,192,192,13] bf16, at
   5 bands and at an unaligned n (the element-wise kernel), with striping
   off and on: dead-band masks and stripe gates exactly
   equal, fp32 within 1e-6, bf16 within one ulp (+1e-6); the
   distribution checks of the JAX package's TPU test; its time in fp32
   and bf16 beside the plain version, the bytes bound, the issue bound
   (the SASS instructions of one pass of the element loop the run takes,
   counted in the library this run built, per element, over the SMs'
   issue rate) and the share of HBM peak;
5. serve: the full-width bf16 flagship (``long_skip_fill.yaml``) with
   seeded random weights answers 4 requests at B=1 and 4 at B=16 through
   ``InferenceSession.predict``, each session compiled on the card (its
   forward captured into a CUDA graph, every request a replay): 8 K1
   launches captured per forward and 8 K1 kernels per replay and per eager
   forward counted by ``torch.profiler`` on the device; the B=1 output
   held against the same weights in fp32 on the CPU; the graph against
   the session's eager forward (outputs bit-equal, their relative RMS
   printed beside; in turns device p50 by CUDA
   events, predict p50 by the host clock, busy time, idle share and
   device launches from the profiler); the tensor maps K1's libraries
   encoded;
6. serve_fp32: the same weights served in fp32 at B=1 and B=16, 8 K4
   launches (and no K1) captured per forward and run per replay, the B=1
   output within relative RMS 1e-4 of the CPU's, graph against eager;
   then one bf16 ``InferenceSession(tta=8)`` at B=1, 64 K1 launches
   captured per forward, graph against eager;
7. scene: the full-width flagship with seeded weights restores a ragged
   uint16 scene of 1000 x 1111 x 13 (483 windows of 64, overlap 16, in
   batches of 64) through ``deployment.sliding_window``'s host, device and
   streaming assemblies, in bf16 (K1) and fp32 (K4): host and device within
   1e-4, streaming and device within 1e-5 relative, each repeat of a path
   equal to its first run; each step captured once with 8 block launches,
   one replay per window batch, 8 block kernels per replay and per batch by
   the profiler, no launch of the other dtype's kernel; Mpix/s of each path
   in turns, device busy time and idle share per batch, peak memory; a
   112 x 112 scene restored in fp32 on the card and on the CPU (relative RMS
   1e-4); then ``python -m msid_tpu_torch.scripts.restore --streaming auto``
   in a child process on a 4096 x 4096 x 13 uint16 TIFF from a checkpoint of
   the same weights (it must stream, and its output must equal the same
   scene streamed in this process within 1e-5), and the device memory a
   10980 x 10980 scene needs, reckoned from shapes;
8. train: one bf16 train step of the flagship at B=2 on the card against
   the same step in fp32 on the CPU (every noise component off); then
   ``setup_training_session(synthetic=True, epochs=1)`` into a temporary
   directory and ``Trainer.fit``: 6 train steps of 64 tiles and 2 padded validation
   batches, finite history, no skipped step, encoder blocks 0-5 unchanged,
   every other parameter moved, one K2 launch per train step and per
   validation batch, 8 K1 launches per validation batch and 6 N1 launches
   per train-mode batch norm and micro-batch; then step
   times with the kernel and with the plain composition (``noise.impl:
   jnp``) in turns, peak memory, a profiler breakdown of one step, and
   one step under ``utils.profiling.trace`` (with Python frames) whose ten
   costliest kernels are printed with their owners: the ATen op and the
   port's Python frame around each launch (a backward kernel's through its
   forward op's autograd sequence number);
9. data_cache: 1024 uint16 EuroSAT-shaped tiles written as TIFFs by the
   port's ``write_tiff`` under ``data.root_dir``: ``get_dataloaders`` with
   ``data.device_cache`` caches both splits on the card as uint16 (1024 x
   64 x 64 x 13 x 2 bytes) and yields the host loader's batches bit for
   bit; then the flagship's train step fed by the cache and by the host
   loader (which reads the TIFFs), one epoch each in turns (cache, host,
   host, cache), step-to-step p50 and peak memory, one K2 launch per
   cached step;
10. evaluate: ``msid_tpu_torch.scripts.train`` trains the flagship for one
   epoch into a temporary directory and writes its checkpoint; then
   ``msid_tpu_torch.scripts.evaluate`` scores it in bf16 (the trainer's
   last validation line within 1e-5 relative), in fp32 (8 K4 launches
   per forward, no K1; 8 tiles corrupted once on the card and restored
   on the card and on the CPU agree within relative RMS 1e-4, their
   metrics within 1e-4), with ``--tta 8`` (64 K1 launches per validation
   batch) and with ``--ensemble`` of the same checkpoint (equal to the
   single score within 1e-5); the checkpoint's size and save time and
   each evaluation's time are printed;
11. probe: the async-copy probe kernel (K5) against ``x * 2`` at
   [8,192,48], [3072,192,48] and a ragged [1000,193,12] fp32 (exactly
   equal), the tensor map it encodes on a tensor's first call and on six
   more, and its device time
   (per launch in a CUDA graph of 100, and from the profiler) and call
   time (CUDA events around one call) beside ``x * 2``'s and its bytes
   bound; the nine-tap fused ResidualBlock (K3)
   against its plain version and against K1's output at the four flagship
   shapes, B=1 and B=16, and at the probe's [64,192,192,48] (rtol 0.03 /
   atol 0.02), also at a caller tile of 5 x 7 that leaves ragged edges;
   with its tile, cluster and ring, timed with its prepared weights and
   through the functional entry, beside K1, a cuDNN bf16 composition and
   the bound;
   then ``msid_tpu_torch.benchmarks.kernel_probe.main`` for every variant,
   each kernel's launch count moving by that variant's calls and no
   other kernel's moving;
12. hybrid: the default full-width model (``unet_light`` 384/192/96/48, no
   fill) in bf16: ``InferenceSession(optimize="auto")`` serves the module's
   forward at B=1 and the hybrid graph at B=16, ``optimize=True`` the
   fastpath; each folded graph within relative RMS 2e-2 of the module's
   forward in bf16 and 1e-4 in fp32, capturing and launching no
   fused-block kernel (the module's forward captures 8); device p50 of the
   three graphs at B=1, 16 and 128, each eager and captured, in turns,
   each replay bit-equal to its eager forward; then
   ``long_skip.yaml`` trained one epoch and scored by
   ``scripts.evaluate --forward apply`` and ``--forward hybrid`` in fp32
   (metrics within 1e-4 relative) and under bf16 autocast (within 2e-2),
   and ``--forward hybrid`` refused with
   ``ValueError`` on the flagship (it has the input fill stage);
13. export: the flagship (seeded random weights) exported on the card by
   ``deployment.export.export_program`` in bf16 and fp32: ``module.pt2``
   below max(2 MB, payload / 2), 8 ``msid::fused_residual_block`` nodes,
   verified at B=1 and 3, the fp32 artifact ``compare_live_vs_exported``
   allclose; each served by ``InferenceSession(artifact_path=...)`` at B=1
   and B=16 beside the live session on the same weights, in turns (device
   p50 of a replay, launches and busy time per replay by the profiler, 8
   K1 or K4 kernels a replay, no tensor-map encode at a replay), bf16
   within 1e-3 relative RMS of the live session and 2e-2 of fp32 on the
   CPU, fp32 within 1e-4 of the CPU; an int8 artifact (sizes,
   ``quantization_report``, cosine > 0.99), a ``tta=8`` artifact at B=1
   against the live ``tta=8`` session (64 K1 a replay), the ``unet_light``
   fastpath artifact at B=16 against the live fastpath session; then
   ``python -m msid_tpu_torch.scripts.export --verify --int8`` on the
   flagship in a child process, with its seconds. The bf16 B=1 artifact
   session also serves a batch of 3: it captures a second graph (8 K1),
   replays it with no tensor-map encode, within 1e-3 of a live B=3
   session. The host seconds of every sub-step are printed;
14. perceptual: VGG16 weights written to an ``.npz`` and resolved by
   ``resolve_perceptual``; the flagship's bf16 train step at B=64 with the
   edge stand-in and with the VGG16 term (weight 0.1), in turns, its cost
   per step; the VGG term on the card (TF32 off) within 1e-4 of the CPU;
15. pretrained: a synthetic ViT-Base SatMAE ``.pth`` (3-band patch embed,
   fused qkv, 197 positions) through ``setup_training_session``'s
   ``pretrained_path``: the position embedding resampled to 144, the qkv
   split, and the encoder on the card within 1e-4 relative RMS of the
   same checkpoint loaded on the CPU (fp32);
16. parallel: (a) K2 on the back 32 rows of a [64,192,192,13] batch with
   ``sample_offset=32``, fp32 and bf16, bit-equal to the back half of K2 on
   the whole batch (masks too) and within its bound of the plain version;
   (b) the flagship's ``Trainer`` with a data-parallel mesh over a one-rank
   NCCL process group against the plain ``Trainer`` from the same seeded
   weights, 3 train steps of B=64 each, in turns: the losses within 1e-3,
   the largest parameter gap printed, both step p50s, one K2 launch a step;
   (c) two gloo ranks sharing the card (``parallel.dryrun.spawn``), 32 rows
   each of a B=64 batch, one train step against one process's B=64 step:
   the noisy inputs bit-equal, loss and gradient norm within 1e-4 and
   1e-3, one K2 launch a rank; and a control in the same launch, each
   rank's BatchNorm moments over its own rows, outside those bounds; (d) a bf16
   ``InferenceSession`` over a mesh of two replicas on the card at B=16:
   each half bit-equal to a B=8 session, 16 K1 launches captured and
   profiled per call, and its ``benchmark`` at B=16 (per call and
   pipelined) with the reference's keys, both replicas replayed in every
   timed call. Run alone, ``nccl_shared`` starts two NCCL ranks on the one
   card and prints what NCCL says (it refuses them, which is why (c) is
   gloo);
17. decoders (run after export): the flagship's configuration with the
   ``unet`` and then the ``attention`` decoder (cuDNN convs, no fused
   block), seeded weights, served by ``InferenceSession`` in bf16 at B=16
   (relative RMS 2e-2 of the fp32 CPU forward) and in fp32 at B=1 (1e-4):
   the module's forward (``optimized`` False, ``optimize=True`` refused),
   no K1 or K4 launch counted or seen by the profiler, device p50 and busy
   time;
18. widths (run after kernel_fp32): K1 against its plain version (rtol
   0.03 / atol 0.02) at every decoder width of the repo's configs (8, 12,
   24, 48, 96, 192, 384, 768), each at its config's resolution, and at
   widths between the builds (13, 40, 60, 100, 136, 200, 300, 500, 700),
   B=1 and B=16, every build of ``csrc/resblock.cu`` run, with tile,
   cluster, stages, body, time, the cuDNN composition's and the bound;
   the wide builds' streamed body at 24x24 at C=256, 300, 384, 500, 512,
   640, 700 and 768, B=1, 16 and 64 (the rows above not run again); K4 at
   widths whose picked cluster is 3, 5, 6, 7 and 8 CTAs (as phase 3); then
   ``capacity_2x.yaml`` (ViT-Base, ``unet_light`` 768/384/192/96, 192²x13,
   seeded weights) served by captured sessions of the module's forward in
   bf16 at B=1 and B=16 (8 K1 launches captured and profiled per replay,
   within relative RMS 2e-2 of fp32 on the CPU) and fp32 at B=1 (8 K4,
   1e-4), device p50 of each; the bf16 model exported on the card (8
   ``msid::fused_residual_block`` nodes) and its artifact served at B=1
   (8 K1 captured, within 1e-3 of the live session); ``scripts.train`` for one epoch of 192
   synthetic tiles (a bf16 ``Trainer.fit`` of 2 steps and one validation
   batch: K2 once a step and a validation batch, K1 8 times a validation
   batch) and ``scripts.evaluate`` of its checkpoint in bf16 (K1 8 times
   a batch, the trainer's last validation line within 1e-5); one
   device-assembly scene batch of 64 windows (8 K1 launches captured);
19. examples: the port's three walkthroughs (``msid_tpu_torch/examples``)
   run in this process as ``__main__`` at full width on synthetic tiles,
   each into a temporary ``--output-dir``: ``00_quick_start`` and
   ``03_evaluation_and_export`` with ``--config long_skip_fill.yaml``,
   ``02_two_stage_training`` on its own stage configurations (ViT-Base,
   ``unet_light``) with ``--epochs 1``, stage B resuming stage A's
   checkpoint under another freeze set. The launch count is cleared
   before each and read after (a session's replays added), with the
   example's seconds: K1 must launch in all three
   (8 times in 00's one forward) and K2 in 02 and 03, K4 and N1 are
   recorded, K3 and K5 must not launch. Then the files: 00's
   preview PNG, 02's curves PNG and history (one finite epoch a stage),
   03's evaluation results (finite PSNR/SSIM/SAM), its three triptychs and
   spectra as PNGs, its bf16 artifact on the card verified at B=1 and 3
   and ``compare_live_vs_exported(...).allclose`` against the same seeded
   model built here, and its session compiled as a CUDA graph;
20. norm (run after noise): the train-mode BatchNorm kernel set (N1,
   ``ops/cuda_norm.py``) through ``Norm`` at each of the flagship's
   train-mode norm shapes at B=64 (bf16, channels-last), forward and
   backward against the same ``Norm`` on its fp32 composition: y and dx
   within one bf16 ulp (2^-7 of the value plus 1e-4 of the largest), dw,
   db and the running mean and biased variance within 1e-4 (plus 1e-5 of
   the largest), six launches a step, two steps bit-equal; the forward's
   and the backward's device time (a CUDA graph of their launches) beside
   the composition's and the bytes bound (x read and y written;
   x and dy read and dx written);
21. layernorm (run after norm): Restormer's bias-free LayerNorm kernel
   (N2, ``ops/cuda_layernorm.py``) at the norm shape of each of the eight
   levels of a B=8 batch of 512-px windows (bf16 and fp32, channels-last)
   against its plain version (``bias_free_norm_plain`` in
   ``models/restormer.py``): bf16 within 2^-5 of the value, fp32 within
   1e-5 (plus 1e-7 of the largest), one launch a call, two calls
   bit-equal; its device time (a CUDA graph of launches) beside the plain
   version's, ``F.layer_norm``'s (the library yardstick, which the port
   never calls), a copy of x and the bytes bound (x read and y written
   once), each once a shape and summed over the 88 norms of one forward;
   then Restormer at its published widths (``restormer_s2.yaml``, bf16)
   restores a 1830x1830 scene twice through one device scene step at B=8
   and 512-px windows: 88 N2 launches at each forward of the capture
   (two warmups and the capture), none at a replay, restores bit-equal.

A launch count in the kernels line is a count of device launches.
``ops/_build.py`` counts the device kernels of every launch
(``_build.launched``, by C entry point; ``launched`` here sums a kernel's
entries) when it runs eagerly and when a graph is captured; a replay runs
the captured launches without passing through it. So a path served by a
compiled session counts the launches over the run, less the capture's,
plus the capture's for every replay.

The fp32 phases run with torch's TF32 flags as they are: the port turns
TF32 off around its own fp32 forwards and steps, and this script around
the fp32 plain versions and library yardsticks it computes itself. The
last lines are the kernels JSON line (K1 to K5, N1 and N2, with their
launches on each path), the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that last line; so does a machine with no card, or a
directory without the package. Everything written goes to temporary
directories that are removed at the end.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "experiments" / "long_skip_fill.yaml"
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 66.9e12  # H100 SXM fp32 peak outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32 tensor-core peak
TF32_PASSES = 3            # K4 multiplies every fp32 product as three TF32 products
BF16_B1_LAUNCHES_BEFORE = 559   # device launches of one bf16 B=1 flagship forward
                                # before the blocks kept their prepared operands
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3
SHAPES = ((384, 24), (192, 48), (96, 96), (48, 192))   # (C, H=W) per stage
BATCHES = (1, 16)
SCENE_BATCH = 64                  # windows per batch of the scene path
# K1 and K4 against their plain versions at the serving batches and at the
# scene path's (the tile choice depends on the batch)
KERNEL_BATCHES = BATCHES + (SCENE_BATCH,)
REQUESTS = 4
RTOL, ATOL = 0.03, 0.02          # the TPU kernel v3's golden tolerance
MAX_REL_RMS = 2e-2               # bf16 GPU forward vs fp32 CPU forward
# K1's and K3's builds of csrc/resblock.cu, one per padded width (each runs
# every true width up to its own); ops/cuda_decoder.py: BF16_BUILDS
RESBLOCK_BUILDS = (768, 512, 384, 256, 192, 128, 96, 64, 48, 32, 16)
# csrc/<name>.cu with its -D defines, built in parallel, the longest first
KERNELS = tuple(("resblock", (f"MSID_C={c}",)) for c in RESBLOCK_BUILDS) + (
    ("noise", ()), ("resblock_fp32", ()), ("any_dma", ()), ("batchnorm", ()),
    ("layernorm", ()))
# K4 against its plain version (cuDNN fp32, TF32 off): both fp32, sums in
# another order over K = 9C.
FP32_SHAPES = SHAPES + ((8, 64), (24, 16))
FP32_MAX_ABS, FP32_MAX_REL_RMS = 1e-4, 1e-5
FP32_FORWARD_REL_RMS = 1e-4       # fp32 GPU forward vs fp32 CPU forward
EVAL_RTOL = 1e-5                  # evaluate vs the trainer's validation line
FP32_METRIC_RTOL = 1e-4           # fp32 GPU metrics vs fp32 CPU metrics
EVAL_SEED = 1234                  # the trainer's and evaluate's eval_seed
# K2 against its plain version: both compute in fp32 from the same Philox
# words; logf/sincospif against torch's log/cos differ by an ulp or two.
NOISE_ATOL = 1e-6
NOISE_CASES = (((64, 192, 192, 13), "float32"), ((4, 192, 192, 13), "float32"),
               ((16, 192, 192, 13), "bfloat16"),
               ((3, 64, 64, 5), "float32"),          # another band count
               ((3, 37, 29, 13), "bfloat16"))        # n % 4 != 0: element-wise loads
SM_ISSUE_PER_CLOCK = 4 * 32   # thread-instructions per SM per clock: 4 schedulers
K3_RAGGED_TILE = (5, 7)       # divides none of the flagship's sides
# One train step, bf16 autocast on the card against fp32 on the CPU: bf16
# keeps ~3 digits through 12 ViT blocks, the decoder and the backward; the
# gradient norm sums squares of ~10^8 bf16-rounded terms, hence the looser bound.
PARITY_BATCH = 2
PARITY_LOSS_RTOL = 1e-2
PARITY_GNORM_RTOL = 5e-2
TIMED_STEPS = 4
PROBE_SHAPE = (64, 192, 192, 48)  # the kernel probe's default block
PROBE_ITERS = 20
# K5: the probe's slice; a 113 MB array; a ragged one (1000 rows, no
# multiple of a box's 32; n = 2316, no multiple of 256 columns)
ANY_DMA_SHAPES = ((8, 192, 48), (3072, 192, 48), (1000, 193, 12))
GRAPH_LAUNCHES = 100              # K5's device time: one CUDA graph of 100 launches
# Each kernel's C entry points, whose device kernels ops/_build.py counts
ENTRIES = {"resblock": ("msid_resblock_forward",),
           "resblock_fp32": ("msid_resblock_fp32_forward",),
           "resblock_v2": ("msid_resblock_v2_forward",), "noise": ("msid_noise_forward",),
           "any_dma": ("msid_any_dma_scale",),
           "batchnorm": ("msid_bn_forward", "msid_bn_backward"),
           "layernorm": ("msid_bias_free_norm",)}
# N1 at the flagship's train-mode norms (C, H=W): the input pyramid's 32 at 192..24,
# then the decoder's stages
NORM_SHAPES = ((32, 192), (32, 96), (32, 48), (32, 24), (384, 24), (192, 48), (96, 96),
               (48, 192))
NORM_BATCH = 64
NORM_GRAPH_LAUNCHES = 10          # N1's device time: forwards or backwards a graph
# N2 at Restormer's norms (``norm_shapes`` of the preset at 512 px), at the
# scene cell's batch; its scene path at the cell's window, overlap and scene side
LN_BATCH = 8
LN_WINDOW, LN_OVERLAP, LN_SCENE = 512, 32, 1830
RESTORMER_CONFIG = ROOT / "configs" / "experiments" / "restormer_s2.yaml"
PROFILE_SESSIONS = 3              # profiler sessions per measurement; the most complete is kept
SKIP_CONFIG = ROOT / "configs" / "experiments" / "long_skip.yaml"   # full width, no fill
HYBRID_BATCHES = (1, 16, 128)
HYBRID_FP32_REL_RMS = 1e-4        # folded graphs vs the module's forward, fp32, TF32 off
HYBRID_METRIC_RTOL = 1e-4         # --forward hybrid vs --forward apply, fp32
# The same under bf16 autocast: the two graphs round at different places
# (outputs differ by ~6e-3 relative RMS), as the serving check allows.
HYBRID_BF16_METRIC_RTOL = 2e-2
# Scene restoration: a ragged uint16 scene (neither side a multiple of the
# stride 48) through the three assemblies; the reference's bounds between them.
SCENE_SHAPE = (1000, 1111, 13)
SCENE_WINDOW, SCENE_OVERLAP = 64, 16
SCENE_BAND_ROWS = 16              # origin rows of a streamed band (the default)
SCENE_DEVICE_VS_HOST = 1e-4       # same windows and weights, other accumulation arithmetic
SCENE_STREAM_RTOL = 1e-5          # only the grouping of the sums differs
# 4 windows padded to a batch of SCENE_BATCH on the card (its B=64 graph), in
# bf16 and fp32, against the plain fp32 restore on the CPU
SCENE_SMALL = (112, 112, 13)
CLI_SCENE_SHAPE = (4096, 4096, 13)    # 16.8 Mpix: above AUTO_STREAM_PIXELS, so it streams
WHOLE_SCENE_SIDE = 10980          # a Sentinel-2 tile, for the device-memory reckoning
CACHE_TILES = 1024                # EuroSAT-shaped uint16 tiles written for the cache phase
CACHE_TURNS = ("cache", "host", "host", "cache")
# Artifacts: a bf16 artifact against the live bf16 session on the same weights
# (the same kernels; the exported graph makes the blocks' operands itself)
ARTIFACT_VS_LIVE_BF16 = 1e-3
INT8_COSINE = 0.99                # int8 weights: the JAX CLI's gate
VGG_WEIGHT = 0.1                  # the perceptual term's weight in the VGG phase
VGG_CPU_RTOL = 1e-4               # the VGG term on the card (TF32 off) against the CPU
PARALLEL_NOISE_SHAPE = (64, 192, 192, 13)   # K2 with a sample offset: the back 32 rows
PARALLEL_TRAIN_BATCH = 64         # the global batch of the data-parallel checks
PARALLEL_SERVE_BATCH = 16         # the mesh session's batch, 8 a replica
PARALLEL_TIMEOUT_S = 300          # two ranks sharing the card: start, build, one step
# Data parallelism against one device on the card, both bf16: the same
# arithmetic but for the order of the sums over the ranks and the buckets.
# Readings (NVIDIA H100 80GB HBM3, 700 W): the one-rank NCCL trainer's loss
# 3.2e-7 -> 5.9e-5 from the plain one's over 3 steps; two gloo ranks' loss
# 4.9e-7 and gradient norm 4.7e-5 from one process's.
PARALLEL_DP_LOSS_RTOL = 1e-3
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_GNORM_RTOL = 1e-3
# The reference's benchmark keys (msid_tpu/deployment/inference.py)
EXAMPLES_DIR = ROOT / "msid_tpu_torch" / "examples"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
BENCHMARK_KEYS = {"mean_ms", "fps", "images_per_sec", "batch_size", "iterations",
                  "std_ms", "min_ms", "max_ms", "p50_ms", "p99_ms"}
TRACE_TOP = 10                    # kernels of the traced train step named with their owners
# The widths phase. K1 at every decoder width of the repo's configs, each at
# the resolution its config runs it (tiny_cpu's 48/24/12/8 at 8..64^2, the
# flagship's 48 at 192^2, capacity_2x's 768/384/192/96 at 24..192^2), and
# at widths off the builds' grid: odd (13), no multiple of 8 (100), and one
# inside every other build, so that every build runs
WIDTHS_BATCHES = (1, 16)
WIDTH_SHAPES = ((8, 64), (12, 32), (24, 16), (48, 192), (96, 192), (192, 96), (384, 48),
                (768, 24))
OFF_GRID_SHAPES = ((13, 32), (40, 64), (60, 64), (100, 48), (136, 48), (200, 48), (300, 24),
                   (500, 24), (700, 24))
# K1's wide builds (the streamed body) at a 768-wide decoder's 24x24 stage,
# at every batch of the port's paths: each build's own width and widths
# between them (no multiple of 8: chunks by plain loads; 640: chunks past C
# skipped). Rows the shapes above already give are not run again.
WIDE_SHAPES = ((256, 24), (300, 24), (384, 24), (500, 24), (512, 24), (640, 24), (700, 24),
               (768, 24))
WIDE_BATCHES = (1, 16, SCENE_BATCH)
# K4 where its picked cluster is 3, 5, 6 and 7 CTAs (at B=1), and C=768 (8)
K4_WIDTH_SHAPES = ((72, 24), (136, 24), (168, 24), (200, 24), (768, 24))
CAPACITY_CONFIG = ROOT / "configs" / "experiments" / "capacity_2x.yaml"
CAPACITY_SAMPLES = 192            # synthetic tiles of its short run: 2 train steps, 1 val batch


def load_flagship() -> dict:
    from msid_tpu_torch.utils.config import load_config

    return load_config(CONFIG)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Stopwatch:
    """Host seconds of named sub-steps (``with clock("name"):``), summed per
    name, in ``seconds``."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` runs after warmup."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def graph_ms(torch, fn, launches: int = GRAPH_LAUNCHES, replays: int = 5) -> float:
    """Device time per call of ``fn()``: ``launches`` calls captured into one
    CUDA graph, the median of ``replays`` replays timed with CUDA events,
    over ``launches``. No host cost is in it, only the device's own time
    and the gaps between back-to-back kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(replays)]
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    return float(np.median([s.elapsed_time(e) for s, e in pairs])) / launches


def launched(kernel: str) -> int:
    """Device kernels of ``kernel`` (a key of ``ENTRIES``) that
    ``_build.launch`` has counted since ``clear_launches``."""
    from msid_tpu_torch.ops import _build

    return sum(_build.launched[entry] for entry in ENTRIES[kernel])


def clear_launches() -> None:
    """Set every kernel's count of device launches to 0."""
    from msid_tpu_torch.ops import _build

    _build.launched.clear()


def resblock_encodes() -> int:
    """Tensor maps K1's and K3's libraries (one per width) have encoded."""
    from msid_tpu_torch.ops import _build

    return sum(_build.tensor_map_encodes(name, defines)
               for name, defines in KERNELS if name == "resblock")


def block_bound(c: int, s: int, b: int, itemsize: int = 2,
                peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str, float, float]:
    """Least time for one block on the card, operands of ``itemsize`` bytes
    at ``peak_flops``: (ms, bound_by, flops, bytes)."""
    flops = 2 * 2 * 9 * c * c * s * s * b
    nbytes = (2 * b * s * s * c + 2 * 9 * c * c) * itemsize + 4 * c * 4
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def random_block_inputs(torch, c: int, s: int, b: int, seed: int, dtype=None):
    from msid_tpu_torch.ops.cuda_decoder import fold_batchnorm

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, s, c)).astype(np.float32)
    w1, w2 = (rng.normal(0, 1 / np.sqrt(9 * c), (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    folds = [fold_batchnorm(rng.normal(1, 0.1, c), rng.normal(0, 0.1, c),
                            rng.normal(0, 0.1, c), rng.uniform(0.5, 2, c))
             for _ in range(2)]
    aff = np.stack([folds[0][0], folds[0][1], folds[1][0], folds[1][1]])
    dev = torch.device("cuda")
    dtype = dtype or torch.bfloat16
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(w1).to(dev, dtype),
            torch.from_numpy(w2).to(dev, dtype),
            torch.from_numpy(aff.astype(np.float32)).to(dev))


def library_block(torch, F):
    """The block as a cuDNN composition in x's dtype (yardstick only, never
    used by the port): channels-last convs, affine, GELU, residual."""
    def run(x, k1, k2, aff):
        xc = x.permute(0, 3, 1, 2)
        a = aff.to(x.dtype)[:, :, None, None]
        h = F.gelu(F.conv2d(xc, k1, padding=1) * a[0] + a[1], approximate="tanh")
        y = F.conv2d(h, k2, padding=1) * a[2] + a[3] + xc
        return F.gelu(y, approximate="tanh")
    return run


def phase_kernel(torch, F, failures: list) -> list[dict]:
    """K1 against its plain version at the flagship shapes and
    ``KERNEL_BATCHES``, through the
    functional entry (HWIO weights) and with the prepared K-major operands
    the model keeps, timed with the latter."""
    from msid_tpu_torch.ops import cuda_decoder

    lib = library_block(torch, F)
    # A wrong byte count on a barrier would hang: the first launch is a
    # small one, synchronised on its own.
    tiny = random_block_inputs(torch, 48, 8, 1, seed=1)
    if not within(torch, cuda_decoder.fused_residual_block(*tiny),
                  cuda_decoder.fused_residual_block_reference(*tiny)):
        failures.append("resblock [1,8,8,48]: disagrees with its plain version")
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c, s in SHAPES:
        for b in KERNEL_BATCHES:
            x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b)
            p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
            encodes = [resblock_encodes()]
            got = cuda_decoder.fused_residual_block(x, p1, p2, aff)
            encodes.append(resblock_encodes())
            kernel_ms = time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                x, p1, p2, aff))
            encodes.append(resblock_encodes())
            functional = cuda_decoder.fused_residual_block(x, w1, w2, aff)
            want = cuda_decoder.fused_residual_block_reference(x, w1, w2, aff)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            max_err = float(diff.max())
            # x's map and the two weight maps, then none for 23 more launches
            encodes_ok = encodes[1] - encodes[0] <= 3 and encodes[2] == encodes[1]
            ok = bool(within(torch, got, want) and torch.equal(got, functional) and encodes_ok)
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
            th, tw, g, stages = cuda_decoder.bf16_tiling(c, s, s, b, sms)
            row = {
                "check": "resblock", "C": c, "H": s, "W": s, "B": b,
                "tile": [th, tw], "cluster": g, "stages": stages,
                "body": cuda_decoder.BF16_VARIANTS[(cuda_decoder.bf16_padded(c), g)][3],
           "taps": cuda_decoder.BF16_VARIANTS[(cuda_decoder.bf16_padded(c), g)][4],
                "encodes_first_call": encodes[1] - encodes[0],
                "encodes_23_more_calls": encodes[2] - encodes[1],
                "kernel_ms": kernel_ms,
                "functional_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                    x, w1, w2, aff)),
                "plain_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_reference(
                    x, w1, w2, aff)),
                "library_ms": time_ms(torch, lambda: lib(x, k1, k2, aff)),
                "library": "cuDNN bf16 conv2d composition (channels-last)",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "flops": flops, "bytes": nbytes,
                "max_abs_err": max_err, "ok": ok,
            }
            row["tflops"] = flops / row["kernel_ms"] / 1e9
            row["share_of_bound"] = bound_ms / row["kernel_ms"]
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"resblock C={c} H={s} B={b}: max_abs_err {max_err}, "
                                f"tensor map encodes {encodes}")
    return rows


def fp32_kernel_row(torch, lib, c: int, s: int, b: int, sms: int, check: str) -> dict:
    """K4 at [b, s, s, c] against its plain version (both fp32, TF32 off),
    timed beside the plain version, a cuDNN fp32 composition, the bound of
    its route (three TF32 passes on the tensor cores) and the bound at the
    fp32 FMA peak."""
    from msid_tpu_torch.models.restoration import exact_fp32
    from msid_tpu_torch.ops import cuda_decoder

    def exact(fn, *args):          # the fp32 yardsticks in fp32: TF32 off
        with exact_fp32(torch.float32):
            return fn(*args)

    x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b, dtype=torch.float32)
    got = cuda_decoder.fused_residual_block(x, w1, w2, aff)
    want = exact(cuda_decoder.fused_residual_block_reference, x, w1, w2, aff)
    torch.cuda.synchronize()
    diff = got - want
    max_err = float(diff.abs().max())
    rel = float(diff.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    ffma_ms, _, flops, nbytes = block_bound(c, s, b, 4, PEAK_FP32_FLOPS)
    bound_ms, bound_by, _, _ = block_bound(c, s, b, 4, PEAK_TF32_FLOPS / TF32_PASSES)
    th, tw, nt, nu, g, kc = cuda_decoder.fp32_tiling(c, s, s, b, sms)
    row = {
        "check": check, "C": c, "H": s, "W": s, "B": b,
        "tile": [th, tw], "cluster": g,
        "geometry": {"nt": nt, "nu": nu, "kc": kc},
        "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
            x, w1, w2, aff), iters=10),
        "plain_ms": time_ms(torch, lambda: exact(
            cuda_decoder.fused_residual_block_reference, x, w1, w2, aff), iters=10),
        "library_ms": time_ms(torch, lambda: exact(lib, x, k1, k2, aff), iters=10),
        "library": "cuDNN fp32 conv2d composition (channels-last, TF32 off)",
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_ffma_ms": ffma_ms,
        "flops": flops, "bytes": nbytes,
        "max_abs_err": max_err, "rel_rms": rel,
        "ok": bool(max_err <= FP32_MAX_ABS and rel <= FP32_MAX_REL_RMS
                   and torch.isfinite(got).all()),
    }
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    row["share_of_bound"] = bound_ms / row["kernel_ms"]
    return row


def phase_kernel_fp32(torch, F, failures: list) -> list[dict]:
    """K4 against its plain version at the flagship and tiny widths and
    ``KERNEL_BATCHES`` (``fp32_kernel_row``)."""
    lib = library_block(torch, F)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for c, s in FP32_SHAPES:
        for b in KERNEL_BATCHES:
            row = fp32_kernel_row(torch, lib, c, s, b, sms, "resblock_fp32")
            emit(row)
            rows.append(row)
            if not row["ok"]:
                failures.append(f"resblock_fp32 C={c} H={s} B={b}: max_abs_err "
                                f"{row['max_abs_err']}, rel RMS {row['rel_rms']}")
    return rows


def randomize_(torch, model, seed: int) -> None:
    """Seeded random values for every parameter and BN statistic, including
    the zero-init head and mask condition and the identity fill Gram."""
    from torch import nn

    from msid_tpu_torch.models.blocks import Norm

    g = torch.Generator().manual_seed(seed)

    def normal(t, std, mean=0.0):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g) * std + mean)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                else m.weight[0].numel()
            normal(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                normal(m.bias, 0.1)
        elif isinstance(m, (Norm, nn.LayerNorm)):
            normal(m.weight, 0.1, 1.0)
            normal(m.bias, 0.1)
            if isinstance(m, Norm) and m.kind == "batch":
                normal(m.running_mean, 0.1)
                with torch.no_grad():
                    m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 1.5 + 0.5)
    normal(model.encoder.pos_embed, 0.02)
    if model.input_fill:
        n = model.fill_gram.shape[0]
        a = torch.randn(n, n, generator=g)
        with torch.no_grad():
            model.fill_gram.copy_(a @ a.T / n + 0.1 * torch.eye(n))


def noisy_tiles(b: int, size: int, bands: int, seed: int) -> np.ndarray:
    """Model-space tiles, each with 1-2 killed bands (thermal noise only)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (b, size, size, bands)).astype(np.float32)
    for i in range(b):
        for c in rng.choice(bands, size=rng.integers(1, 3), replace=False):
            x[i, :, :, c] = rng.normal(0, 0.005, (size, size))
    return x


def rel_rms(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - ref) ** 2)) / np.sqrt(np.mean(ref ** 2)))


def device_profile(torch, fn, iters: int = 3, tags: dict | None = None,
                   expect: dict | None = None) -> dict:
    """Device time and launches per call of ``fn``, by kernel name, from the
    device-side events of ``torch.profiler`` (CUPTI). ``tags`` maps a
    result key to a substring of kernel names whose times it sums;
    ``device_busy_ms`` sums every device record (kernels and copies),
    ``device_active_ms`` is the time some record ran (their union, which
    counts overlapping copies and kernels once). The profiler can drop
    kernel records (one run saw 389.7 of a B=16 graph replay's 539
    launches, the same replay's output bit-equal to the eager forward's),
    and a dropped record only lowers a count or a sum. So ``PROFILE_SESSIONS``
    sessions of ``iters`` calls are taken. ``expect`` maps a key of ``tags``
    to the launches one call must show: a session is full when every such
    count is exact, and over when one is larger, which no dropped record
    explains; the kept session is the full one with the most records, else
    the one with the most records. ``sessions_full`` and ``sessions_over``
    count them, for the caller to check and print."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tags, expect = tags or {}, expect or {}
    fn()
    torch.cuda.synchronize()
    kept, full, over = None, 0, 0
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        counts = {key: sum(1 for name, _, _ in events if tags[key] in name)
                  for key in expect}
        is_full = all(counts[k] == n * iters for k, n in expect.items())
        full += is_full
        over += any(counts[k] > n * iters for k, n in expect.items())
        rank = (is_full, len(events))
        if kept is None or rank > kept[0]:
            kept = (rank, events)
    events = kept[1]
    per_kernel: dict[str, float] = {}
    for name, start, end in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + (end - start) / 1e3 / iters
    active, reach = 0.0, None
    for _, start, end in sorted(events, key=lambda e: e[1]):
        if reach is None or start > reach:
            active, reach = active + end - start, end
        elif end > reach:
            active, reach = active + end - reach, end
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    out = {"device_busy_ms": sum(per_kernel.values()),
           "device_active_ms": active / 1e3 / iters,
           "device_launches": len(events) / iters,
           "sessions": PROFILE_SESSIONS, "sessions_full": full, "sessions_over": over,
           "top_ms": [[k[:80], v] for k, v in top]}
    for key, tag in tags.items():
        out[key] = sum(v for k, v in per_kernel.items() if tag in k)
        out[f"{key}_launches"] = sum(1 for name, _, _ in events if tag in name) / iters
    return out


def profile_complete(prof: dict, key: str, expect: float) -> bool:
    """The kept session of ``device_profile`` showed ``expect`` launches of
    ``key`` per call and no session showed more."""
    return prof[f"{key}_launches"] == expect and prof["sessions_over"] == 0


def session_turns(torch, session, requests: list, tag: str, iters: int) -> dict:
    """One session's captured forward against its eager forward: their
    outputs on the first request, then in turns (graph, eager, eager,
    graph) device p50 by CUDA events (the graph through ``benchmark``, the
    eager forward on the same device batch) and predict p50 by the host
    clock (the graph through ``predict``, the eager forward with the same
    upload and download), and a profiler breakdown of one call of each.
    ``tag`` names the block kernel of the session's dtype."""
    dev = session.device
    xd = torch.from_numpy(requests[0]).to(dev)
    graph_out, eager_out = session.forward(xd), session.forward_eager(xd)
    torch.cuda.synchronize()

    def predict_eager(r):
        return session.forward_eager(torch.from_numpy(r).to(dev)).cpu().numpy()

    def host_p50(predict):
        times = []
        for r in requests * max(1, iters // len(requests)):
            t0 = time.perf_counter()
            predict(r)
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(times, 50))

    turns: dict = {"graph": [], "eager": []}
    for form in ("graph", "eager", "eager", "graph"):
        if form == "graph":
            device = session.benchmark(warmup_runs=3, benchmark_iterations=iters)["p50_ms"]
            host = host_p50(session.predict)
        else:
            device = time_ms(torch, lambda: session.forward_eager(xd), iters)
            host = host_p50(predict_eager)
        turns[form].append({"device_p50_ms": device, "predict_p50_ms": host})
    row = {"compiled": session.compiled, "captured_launches": session.captured_launches,
           "graph_equals_eager": bool(torch.equal(graph_out, eager_out)),
           "graph_vs_eager_max_abs": float((graph_out - eager_out).abs().max()),
           "graph_vs_eager_rel_rms": rel_rms(graph_out.cpu().numpy(), eager_out.cpu().numpy())}
    for form, fn in (("graph", lambda: session.forward(xd)),
                     ("eager", lambda: session.forward_eager(xd))):
        prof = device_profile(torch, fn, tags={"block_ms": tag},
                              expect={"block_ms": session.captured_launches})
        device = float(np.mean([t["device_p50_ms"] for t in turns[form]]))
        row[form] = {
            "turns": turns[form], "device_p50_ms": device,
            "predict_p50_ms": float(np.mean([t["predict_p50_ms"] for t in turns[form]])),
            "device_tiles_per_s": session.batch_size * 1e3 / device,
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": 1 - prof["device_busy_ms"] / device,
            "device_launches": prof["device_launches"],
            "block_kernels": prof["block_ms_launches"], "block_ms": prof["block_ms"],
            "profiler_sessions_full": prof["sessions_full"],
            "profiler_sessions_over": prof["sessions_over"],
            "top_ms": prof["top_ms"][:5]}
    return row


def device_launches(counted: int, session) -> int:
    """Device launches of a hand-written kernel over a run that built
    ``session`` and served from it, from its kernel's count over the run
    (``counted``: the warmup's and the eager forwards' launches, which ran,
    and the capture's, which only recorded): the capture's out, each
    replay's in."""
    return counted + (session.replays - 1) * session.captured_launches


def check_session(failures: list, name: str, row: dict, expect: int) -> None:
    """A compiled session: captured, ``expect`` block-kernel launches
    captured and run by every replay and every eager forward (profiler),
    graph and eager bit-equal (the same kernels on the same operands in the
    same order; their relative RMS is only printed)."""
    if row["compiled"] != "cuda_graph" or row["captured_launches"] != expect:
        failures.append(f"{name}: compiled {row['compiled']!r}, "
                        f"{row['captured_launches']} launches captured, expected {expect}")
    for form in ("graph", "eager"):
        r = row[form]
        if (r["block_kernels"] != expect or r["profiler_sessions_over"]
                or not r["device_busy_ms"] > 0):
            failures.append(f"{name}: the profiler saw {r['block_kernels']} block kernels "
                            f"per {form} forward, expected {expect}; "
                            f"{r['profiler_sessions_full']} of {PROFILE_SESSIONS} sessions "
                            f"full, {r['profiler_sessions_over']} over")
    if not row["graph_equals_eager"]:
        failures.append(f"{name}: graph and eager differ, max abs "
                        f"{row['graph_vs_eager_max_abs']}, rel RMS "
                        f"{row['graph_vs_eager_rel_rms']}")


def phase_serve(torch, failures: list, card: str) -> tuple[dict, tuple]:
    """The bf16 flagship served by compiled sessions at B=1 and B=16: the
    requests through ``predict`` (a replay each), the B=1 output against
    fp32 on the CPU, the graph against the eager forward in turns."""
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration

    cfg = load_flagship()
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    randomize_(torch, cpu_model, seed=0)
    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    model.load_state_dict(cpu_model.state_dict())
    size, bands = cpu_model.image_size, cpu_model.in_channels

    result = {"check": "serve", "config": str(CONFIG.relative_to(ROOT)),
              "dtype": "bfloat16", "card": card}
    launches_total = noise_launches = 0
    for b in BATCHES:
        clear_launches()
        encodes = resblock_encodes()
        session = InferenceSession(model, batch_size=b, image_size=size,
                                   num_bands=bands)
        requests = [noisy_tiles(b, size, bands, seed=100 * b + i)
                    for i in range(REQUESTS)]
        outs = [session.predict(r) for r in requests]
        for out in outs:
            if out.shape != (b, size, size, bands) or not np.isfinite(out).all():
                failures.append(f"serve B={b}: bad output {out.shape}, "
                                f"finite={bool(np.isfinite(out).all())}")
        row = session_turns(torch, session, requests, "resblock_kernel", 20)
        check_session(failures, f"serve B={b}", row, 8)
        if b == 1 and not row["eager"]["device_launches"] < BF16_B1_LAUNCHES_BEFORE:
            failures.append(f"serve B=1: {row['eager']['device_launches']} device launches "
                            f"per eager forward, not fewer than {BF16_B1_LAUNCHES_BEFORE}")
        launches = device_launches(launched("resblock"), session)
        row.update(k1_device_launches=launches, replays=session.replays,
                   tensor_map_encodes=resblock_encodes() - encodes)
        launches_total += launches
        noise_launches += launched("noise")
        result[f"b{b}"] = row
        if b == 1:
            torch.set_num_threads(8)
            with torch.no_grad():
                ref = cpu_model(torch.from_numpy(requests[0])).numpy()
            x0 = requests[0]
            result["rel_rms_vs_cpu_fp32"] = rel_rms(outs[0], ref)
            # the same without the global residual's identity part
            result["rel_rms_residual_part"] = rel_rms(outs[0] - x0, ref - x0)
            if not result["rel_rms_vs_cpu_fp32"] <= MAX_REL_RMS:
                failures.append(f"serve: rel RMS {result['rel_rms_vs_cpu_fp32']} "
                                f"vs fp32 CPU > {MAX_REL_RMS}")
        del session                      # its graph's memory pool with it
        torch.cuda.empty_cache()
    result["launches"] = launches_total
    result["noise_launches"] = noise_launches
    emit(result)
    return result, (cpu_model, x0, ref)


def phase_serve_fp32(torch, failures: list, card: str, reference: tuple) -> dict:
    """The serve phase's weights in fp32 through K4 at B=1 and B=16, held to
    the same fp32 forward on the CPU; then one bf16 session with tta=8;
    each compiled, against its eager forward."""
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration

    cpu_model, x0, ref = reference
    cfg = load_flagship()
    model = SatMAERestoration.from_config(cfg)
    model.load_state_dict(cpu_model.state_dict())
    size, bands = cpu_model.image_size, cpu_model.in_channels
    result = {"check": "serve_fp32", "config": str(CONFIG.relative_to(ROOT)),
              "dtype": "float32", "card": card}
    k4_total = 0
    for b in BATCHES:
        clear_launches()
        session = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands)
        requests = [x0] if b == 1 else [noisy_tiles(b, size, bands, seed=200 + i)
                                         for i in range(REQUESTS)]
        outs = [session.predict(r) for r in requests]
        for out in outs:
            if out.shape != (b, size, size, bands) or not np.isfinite(out).all():
                failures.append(f"serve_fp32 B={b}: bad output {out.shape}")
        row = session_turns(torch, session, requests, "resblock_fp32_kernel", 20 if b == 1 else 10)
        check_session(failures, f"serve_fp32 B={b}", row, 8)
        k4 = device_launches(launched("resblock_fp32"), session)
        row.update(k4_device_launches=k4, k1_launches=launched("resblock"),
                   replays=session.replays)
        if launched("resblock") != 0:
            failures.append(f"serve_fp32 B={b}: {launched('resblock')} K1 launches")
        k4_total += k4
        result[f"b{b}"] = row
        if b == 1:
            result["rel_rms_vs_cpu_fp32"] = rel_rms(outs[0], ref)
            result["rel_rms_residual_part"] = rel_rms(outs[0] - x0, ref - x0)
            if not result["rel_rms_vs_cpu_fp32"] <= FP32_FORWARD_REL_RMS:
                failures.append(f"serve_fp32: rel RMS {result['rel_rms_vs_cpu_fp32']} "
                                f"vs fp32 CPU > {FP32_FORWARD_REL_RMS}")
        del session
        torch.cuda.empty_cache()
    result["k4_launches"] = k4_total

    bf16 = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    bf16.load_state_dict(cpu_model.state_dict())
    clear_launches()
    session = InferenceSession(bf16, batch_size=1, image_size=size, num_bands=bands, tta=8)
    out = session.predict(x0)
    row = session_turns(torch, session, [x0], "resblock_kernel", 10)
    check_session(failures, "serve tta=8", row, 64)
    tta_launches = device_launches(launched("resblock"), session)
    row.update(k1_device_launches=tta_launches, replays=session.replays,
               rel_rms_vs_cpu_fp32_single_view=rel_rms(out, ref))
    result["tta8_bf16_b1"] = row
    result["k1_launches"] = tta_launches
    if not np.isfinite(out).all():
        failures.append("serve tta=8: output not finite")
    del session
    torch.cuda.empty_cache()
    emit(result)
    return result


def bf16_ulp(torch, v):
    """One bf16 ulp at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().float().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def noise_bound_ms(b: int, n: int, itemsize: int) -> float:
    """Bytes bound of one corruption pass: read x once, write out once."""
    return 2 * b * n * itemsize / PEAK_HBM_BYTES * 1e3


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def noise_loop_instructions(dtype_name: str) -> dict:
    """SASS instructions of one pass of the element loops (gated and plain
    sample) of K2's vector kernel in ``dtype_name``, in the library this
    run built (``cuobjdump -sass``), and the elements a pass covers."""
    from msid_tpu_torch.benchmarks import sass_count
    from msid_tpu_torch.ops import _build

    ctype = {"float32": "float", "bfloat16": "__nv_bfloat16"}[dtype_name]
    found = sass_count.loops(sass_count.sass_of(_build.build("noise")))
    name = next(k for k in found if f"noise_group_kernel<{ctype}, true>(" in k)
    loops = sass_count.element_loops(found[name])
    return {"kernel": name, "elements_per_pass": 4,
            **{k: v["instructions"] for k, v in loops.items()}}


def noise_issue_bound_ms(torch, loop: dict, n: int, gates: list, clock_hz: float) -> float:
    """Least time to issue the element loops' instructions for samples of
    ``n`` elements, gated as ``gates`` says, on every SM at ``clock_hz``
    (set-up and the rarely taken slow paths not counted)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_pass = sum(loop["gated" if g else "plain"] for g in gates)
    return n * per_pass / loop["elements_per_pass"] / (sms * SM_ISSUE_PER_CLOCK * clock_hz) * 1e3


def phase_noise(torch, failures: list) -> dict:
    """K2 against its plain version (masks and gates exactly, fp32 to
    NOISE_ATOL, bf16 to one ulp), the distribution checks, and times."""
    from msid_tpu_torch.ops import cuda_noise
    from msid_tpu_torch.ops.noise import NoiseConfig, apply_sensor_noise

    kernel, plain = (cuda_noise.apply_sensor_noise_kernel,
                     cuda_noise.apply_sensor_noise_kernel_reference)
    rows, max_err = [], 0.0
    for shape, dtype_name in NOISE_CASES:
        dtype = getattr(torch, dtype_name)
        for striping in (False, True):
            cfg = NoiseConfig(enable_striping=striping, stripe_prob=0.5)
            g = torch.Generator(device="cuda").manual_seed(shape[0])
            x = (torch.rand(shape, device="cuda", generator=g) * 5 - 2.5).to(dtype)
            seed = 1000 + shape[0] + striping
            got, masks = kernel(seed, x, cfg, return_masks=True)
            want, want_masks = plain(seed, x, cfg, return_masks=True)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            if dtype == torch.float32:
                ok = err <= NOISE_ATOL
                max_err = max(max_err, err)
            else:
                # the fp32 results differ by up to NOISE_ATOL before rounding
                ulp = bf16_ulp(torch, torch.maximum(got.float().abs(), want.float().abs()))
                ok = bool((diff <= ulp + NOISE_ATOL).all())
            masks_equal = torch.equal(masks, want_masks)
            gates = int(masks[:, -1].sum())
            row = {"check": "noise", "shape": list(shape), "dtype": dtype_name,
                   "striping": striping, "max_abs_err": err, "masks_equal": masks_equal,
                   "dead_bands": int((masks[:, :-1] == 0).sum()), "gated_samples": gates,
                   "ok": ok and masks_equal and (gates > 0 or not striping or shape[0] < 16)}
            emit(row)
            rows.append(row)
            if not row["ok"]:
                failures.append(f"noise {shape} {dtype} striping={striping}: {row}")

    zeros = torch.zeros(4, 192, 192, 13, device="cuda")
    gauss = kernel(3, zeros, NoiseConfig(gaussian_sigma=0.02, speckle_sigma=0,
                                         dead_band_prob=0, thermal_scale=0))
    thermal = kernel(5, zeros, NoiseConfig(gaussian_sigma=0, speckle_sigma=0,
                                           dead_band_prob=0, thermal_scale=0.01))
    dead = kernel(7, torch.ones(8, 192, 192, 13, device="cuda"), NoiseConfig())
    stats = {"check": "noise_statistics",
             "gauss_mean": float(gauss.mean()), "gauss_std": float(gauss.std()),
             "thermal_std_band1": float(thermal[..., 0].std()),
             "thermal_std_band13": float(thermal[..., 12].std()),
             "dead_of_104": int((dead.abs().mean(dim=(1, 2)) < 0.1).sum())}
    stats["ok"] = (abs(stats["gauss_mean"]) < 1e-3 and abs(stats["gauss_std"] - 0.02) < 1e-3
                   and abs(stats["thermal_std_band1"] - 0.01) < 1e-3
                   and abs(stats["thermal_std_band13"] - 0.02) < 2e-3
                   and 1 <= stats["dead_of_104"] <= 20)
    emit(stats)
    if not stats["ok"]:
        failures.append(f"noise statistics: {stats}")

    b, h, w, c = NOISE_CASES[0][0]
    n = h * w * c
    cfg = NoiseConfig()
    clock_hz = sm_clock_hz()
    timing = {"check": "noise_time", "shape": [b, h, w, c], "dtype": "float32",
              "max_abs_err": max_err, "sm_clock_mhz": clock_hz / 1e6}
    for dtype_name, itemsize in (("float32", 4), ("bfloat16", 2)):
        x = (torch.rand(b, h, w, c, device="cuda") * 4 - 2).to(getattr(torch, dtype_name))
        gates = [bool(v) for v in kernel(11, x, cfg, return_masks=True)[1][:, -1].tolist()]
        loop = noise_loop_instructions(dtype_name)
        row = timing[dtype_name] = {
            "kernel_ms": time_ms(torch, lambda: kernel(11, x, cfg)),
            "bound_ms": noise_bound_ms(b, n, itemsize), "bound_by": "bytes",
            "loop_instructions": loop, "gated_samples": sum(gates),
            "instructions_per_element": sum(loop["gated" if g else "plain"] for g in gates)
            / (b * loop["elements_per_pass"]),
            "issue_bound_ms": noise_issue_bound_ms(torch, loop, n, gates, clock_hz),
        }
        if dtype_name == "float32":
            row["plain_ms"] = time_ms(torch, lambda: plain(11, x, cfg), iters=5, warmup=1)
            row["jnp_impl_ms"] = time_ms(torch, lambda: apply_sensor_noise(11, x, cfg))
        row["hbm_share_of_peak"] = row["bound_ms"] / row["kernel_ms"]
        row["issue_share"] = row["issue_bound_ms"] / row["kernel_ms"]
    timing.update({k: timing["float32"][k] for k in (
        "kernel_ms", "plain_ms", "bound_ms", "bound_by", "issue_bound_ms",
        "instructions_per_element", "hbm_share_of_peak")})
    emit(timing)
    return timing


def norm_case(torch, c: int, side: int, seed: int):
    """A train-mode ``Norm`` with seeded parameters and statistics, and x (a
    mean and a scale of its own per channel) and dy, bf16 channels-last at
    ``[NORM_BATCH, c, side, side]`` on the card."""
    from msid_tpu_torch.models.blocks import Norm

    g = torch.Generator(device="cuda").manual_seed(seed)
    norm = Norm(c).cuda().train()
    with torch.no_grad():
        norm.weight.copy_(torch.rand(c, device="cuda", generator=g) + 0.5)
        norm.bias.copy_(torch.rand(c, device="cuda", generator=g) - 0.5)
        norm.running_var.uniform_(0.5, 1.5, generator=g)
    shape = (NORM_BATCH, c, side, side)
    spread = 1 + torch.rand(c, 1, 1, device="cuda", generator=g)
    loc = torch.randn(c, 1, 1, device="cuda", generator=g)
    x = torch.randn(shape, device="cuda", generator=g) * spread + loc
    dy = torch.randn(shape, device="cuda", generator=g)
    return norm, *(t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                   for t in (x, dy))


def norm_step(torch, norm, x, dy, kernels: bool) -> list:
    """y, dx, dw, db and the running statistics after one train-mode step
    of a copy of ``norm``, on N1 or on its fp32 composition."""
    from msid_tpu_torch.ops import cuda_norm

    serves = cuda_norm.serves
    if not kernels:
        cuda_norm.serves = lambda t: False
    try:
        norm = copy.deepcopy(norm)
        xr = x.clone().requires_grad_()
        y = norm(xr)
        y.backward(dy)
        torch.cuda.synchronize()
    finally:
        cuda_norm.serves = serves
    return [y.detach(), xr.grad, norm.weight.grad, norm.bias.grad, norm.running_mean,
            norm.running_var]


def norm_within(got, want, bf16: bool) -> bool:
    """bf16 (y, dx): one fp32 value rounded on both sides, so one ulp (2^-7
    of it) or a cancellation near zero (1e-4 of the largest); fp32 (dw, db,
    the statistics): sums in another order."""
    got, want = got.float(), want.float()
    top = want.abs().max()
    bound = 2.0 ** -7 * want.abs() + 1e-4 * top if bf16 else 1e-4 * want.abs() + 1e-5 * top
    return bool(((got - want).abs() <= bound).all() and got.isfinite().all())


def phase_norm(torch, failures: list) -> dict:
    """N1 through ``Norm`` against its fp32 composition at every flagship
    train-mode norm shape at B=64 (``NORM_SHAPES``), the first launch a
    small one synchronised on its own, with the kernels' device times
    beside the composition's and the bytes bound."""
    from msid_tpu_torch.models.blocks import BN_EPS, BN_MOMENTUM
    from msid_tpu_torch.ops import cuda_norm

    norm, x, dy = norm_case(torch, 48, 8, seed=1)
    x, dy = x[:1], dy[:1]
    if not all(norm_within(g, w, i < 2) for i, (g, w) in enumerate(zip(
            norm_step(torch, norm, x, dy, True), norm_step(torch, norm, x, dy, False)))):
        failures.append("batchnorm [1,48,8,8]: disagrees with the composition")
    clear_launches()
    rows = []
    for c, side in NORM_SHAPES:
        norm, x, dy = norm_case(torch, c, side, seed=c + side)
        before = launched("batchnorm")
        got = norm_step(torch, norm, x, dy, True)
        launches = launched("batchnorm") - before
        again = norm_step(torch, norm, x, dy, True)
        want = norm_step(torch, norm, x, dy, False)
        names = ("y", "dx", "dw", "db", "running_mean", "running_var")
        bad = [n for i, (n, g, w) in enumerate(zip(names, got, want))
               if not norm_within(g, w, i < 2)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        params = (norm.weight, norm.bias, norm.running_mean.clone(), norm.running_var.clone())
        y, stats = cuda_norm._forward_kernels(x, *params, BN_MOMENTUM, BN_EPS)
        forward_ms = graph_ms(torch, lambda: cuda_norm._forward_kernels(
            x, *params, BN_MOMENTUM, BN_EPS), launches=NORM_GRAPH_LAUNCHES)
        backward_ms = graph_ms(torch, lambda: cuda_norm._backward_kernels(
            x, dy, norm.weight, stats, True), launches=NORM_GRAPH_LAUNCHES)
        xr = x.clone().requires_grad_()
        composition = copy.deepcopy(norm)

        def plain_forward():
            with torch.no_grad():
                composition._train_batch_norm(x)

        def plain_both():
            xr.grad = None
            composition._train_batch_norm(xr).backward(dy)

        serves, cuda_norm.serves = cuda_norm.serves, (lambda t: False)
        try:
            plain_forward_ms = time_ms(torch, plain_forward, iters=10)
            plain_ms = time_ms(torch, plain_both, iters=10)
        finally:
            cuda_norm.serves = serves
        n = x.numel()
        row = {
            "check": "batchnorm", "B": NORM_BATCH, "C": c, "H": side, "W": side,
            "launches_a_step": launches,
            "max_abs_err": {k: float((g.float() - w.float()).abs().max())
                            for k, g, w in zip(names, got, want)},
            "forward_ms": forward_ms, "backward_ms": backward_ms,
            "kernel_ms": forward_ms + backward_ms,
            "plain_forward_ms": plain_forward_ms, "plain_ms": plain_ms,
            "plain": "Norm's fp32 composition (eager, autograd), forward and backward",
            # bf16: x read and y written; x and dy read and dx written
            "bound_forward_ms": 4 * n / PEAK_HBM_BYTES * 1e3,
            "bound_backward_ms": 6 * n / PEAK_HBM_BYTES * 1e3,
            "ok": not bad and same and launches == 6,
        }
        row["bound_ms"] = row["bound_forward_ms"] + row["bound_backward_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
        emit(row)
        rows.append(row)
        if not row["ok"]:
            failures.append(f"batchnorm C={c} H={side} B={NORM_BATCH}: outside the bf16 "
                            f"tolerances in {bad}, bit-equal twice {same}, {launches} launches")
        del norm, x, dy, xr, y, stats, got, again, want, composition
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launched("batchnorm")}


def layernorm_case(torch, c: int, side: int, dtype, seed: int, batch: int = LN_BATCH):
    """x (each pixel's channels around a mean and a spread of their own) and
    w in ``dtype``, x channels-last ``[batch, c, side, side]`` on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mean = torch.randn(batch, 1, side, side, device="cuda", generator=g)
    spread = 0.5 + torch.rand(batch, 1, side, side, device="cuda", generator=g)
    x = torch.randn(batch, c, side, side, device="cuda", generator=g) * spread + mean
    w = torch.rand(c, device="cuda", generator=g) + 0.5
    return x.to(dtype).contiguous(memory_format=torch.channels_last), w.to(dtype)


def layernorm_within(got, want, bf16: bool) -> bool:
    """bf16: the composition rounds three times and the kernel once, each
    within 2^-8 of the value, so 2^-6 apart at most: 2^-5; fp32: the
    variance's order of sums and rsqrt's last bits, 1e-5 (plus 1e-7 of the
    largest, for an underflow)."""
    got, want = got.float(), want.float()
    bound = (2.0 ** -5 if bf16 else 1e-5) * want.abs() + 1e-7 * want.abs().max()
    return bool(((got - want).abs() <= bound).all() and got.isfinite().all())


def layernorm_scene(torch, failures: list) -> dict:
    """Restormer at its published widths (``restormer_s2.yaml``, bf16)
    restores a 1830x1830x13 uint16 scene twice through one device scene
    step at the scene cell's B=8 and 512-px windows: N2 launches 88 times a
    forward at the step's warmups and capture, none at a replay, and the
    two restores are bit-equal."""
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.deployment.inference import CAPTURE_WARMUP
    from msid_tpu_torch.models.restoration import restorer_from_config
    from msid_tpu_torch.utils.config import load_config

    torch.manual_seed(0)
    model = restorer_from_config(load_config(RESTORMER_CONFIG), dtype=torch.bfloat16,
                                 device="cuda").eval()
    norms = sum(n for _, _, n in model.norm_shapes(LN_WINDOW))
    scene = np.random.default_rng(6).integers(500, 4000, (LN_SCENE, LN_SCENE, 13),
                                              dtype=np.uint16)
    kw = dict(window=LN_WINDOW, overlap=LN_OVERLAP, model_size=LN_WINDOW,
              batch_size=LN_BATCH)
    clear_launches()
    step = sw.make_device_scene_step(model, None, LN_WINDOW, LN_WINDOW, LN_OVERLAP)
    del model
    first = sw.restore_scene(None, None, scene, step=step, device_assembly=True, **kw)
    at_capture, replays = launched("layernorm"), step.replays
    again = sw.restore_scene(None, None, scene, step=step, device_assembly=True, **kw)
    torch.cuda.synchronize()
    out = {"check": "layernorm_scene", "config": str(RESTORMER_CONFIG.relative_to(ROOT)),
           "scene": [LN_SCENE, LN_SCENE, 13], "window": LN_WINDOW, "overlap": LN_OVERLAP,
           "batch_size": LN_BATCH, "norms": norms, "compiled": step.compiled,
           "captured_launches": step.captured_launches, "forwards_at_capture": CAPTURE_WARMUP + 1,
           "launches_at_capture": at_capture, "replays": step.replays - replays,
           "launches_at_replays": launched("layernorm") - at_capture,
           "repeat_equal": bool(np.array_equal(first, again)),
           "finite": bool(np.isfinite(first).all())}
    emit(out)
    if not (norms == 88 and step.compiled == "cuda_graph" and step.captured_launches == norms
            and at_capture == norms * (CAPTURE_WARMUP + 1) and out["replays"] > 0
            and out["launches_at_replays"] == 0 and out["repeat_equal"] and out["finite"]):
        failures.append(f"layernorm_scene: not 88 N2 launches a captured forward and none "
                        f"at a replay, or the restores differ: {out}")
    return out


def phase_layernorm(torch, F, failures: list) -> dict:
    """N2 against its plain version (``bias_free_norm_plain``) at each
    level's norm shape of a B=8 batch of 512-px windows, in bf16 and fp32,
    the first launch a small one synchronised on its own; in bf16 its
    device time beside the plain version's, ``F.layer_norm``'s and the
    bytes bound; then N2's launches on Restormer's scene path
    (``layernorm_scene``)."""
    from msid_tpu_torch.models.restormer import LN_EPS, RestormerRestoration, bias_free_norm_plain
    from msid_tpu_torch.ops import cuda_layernorm

    with torch.device("meta"):
        levels = RestormerRestoration().norm_shapes(LN_WINDOW)

    def kernel(x, w):
        return cuda_layernorm.bias_free_norm(x, w, LN_EPS)

    x, w = layernorm_case(torch, 48, 8, torch.bfloat16, seed=1, batch=1)
    got = kernel(x, w)
    torch.cuda.synchronize()
    if not layernorm_within(got, bias_free_norm_plain(x, w), True):
        failures.append("layernorm [1,48,8,8]: disagrees with the composition")
    clear_launches()
    rows = []
    for c, side, _ in dict.fromkeys(levels):
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            x, w = layernorm_case(torch, c, side, dtype, seed=c + side)
            before = launched("layernorm")
            got = kernel(x, w)
            launches = launched("layernorm") - before
            want = bias_free_norm_plain(x, w)
            ok = (layernorm_within(got, want, bf16)
                  and torch.equal(got, kernel(x, w)) and launches == 1
                  and got.is_contiguous(memory_format=torch.channels_last))
            row = {"check": "layernorm", "B": LN_BATCH, "C": c, "H": side, "W": side,
                   "dtype": str(dtype).replace("torch.", ""), "launches": launches,
                   "max_abs_err": float((got.float() - want.float()).abs().max()),
                   "ok": ok}
            if bf16:
                xv = x.permute(0, 2, 3, 1)
                row["ms"] = graph_ms(torch, lambda: kernel(x, w), launches=NORM_GRAPH_LAUNCHES)
                row["plain_ms"] = graph_ms(torch, lambda: bias_free_norm_plain(x, w),
                                           launches=NORM_GRAPH_LAUNCHES)
                row["library_ms"] = graph_ms(torch, lambda: F.layer_norm(xv, (c,), w),
                                             launches=NORM_GRAPH_LAUNCHES)
                row["copy_ms"] = graph_ms(torch, lambda: x.clone(), launches=NORM_GRAPH_LAUNCHES)
                row["bound_ms"] = 2 * x.element_size() * x.numel() / PEAK_HBM_BYTES * 1e3
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
            emit(row)
            rows.append(row)
            if not ok:
                failures.append(f"layernorm C={c} H={side} B={LN_BATCH} {dtype}: outside "
                                f"the tolerance, not bit-equal twice, or {launches} launches")
            del x, w, got, want
            torch.cuda.empty_cache()
    timed = {(r["C"], r["H"]): r for r in rows if "ms" in r}
    keys = ("ms", "plain_ms", "library_ms", "copy_ms", "bound_ms")
    shapes = {k: sum(timed[c, s][k] for c, s, _ in levels) for k in keys}
    forward = {k: sum(n * timed[c, s][k] for c, s, n in levels) for k in keys}
    norms = sum(n for _, _, n in levels)
    out = {"rows": rows, "launches": launched("layernorm"), "shapes": shapes,
           "forward": forward, "norms": norms, "levels": len(levels)}
    emit({"check": "layernorm_summary", **{k: v for k, v in out.items() if k != "rows"}})
    out["scene"] = layernorm_scene(torch, failures)
    return out


def train_batch(bands: int, b: int, seed: int) -> np.ndarray:
    """Raw synthetic DN tiles, as the trainer's loader yields them."""
    from msid_tpu_torch.data.dataset import SyntheticEuroSAT

    ds = SyntheticEuroSAT(num_samples=4 * b, split="train", seed=seed, num_bands=bands)
    return np.stack([ds[i] for i in range(b)])


def train_step_parity(torch, cfg: dict, failures: list) -> dict:
    """One bf16 train step on the card against the same step in fp32 on the
    CPU, from the same random weights, every noise component off."""
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState, make_train_step

    zero = NoiseConfig(gaussian_sigma=0, speckle_sigma=0, dead_band_prob=0,
                       thermal_scale=0, enable_striping=False)
    batch = train_batch(13, PARITY_BATCH, seed=5)
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        model = SatMAERestoration.from_config(cfg, device="cpu")
        randomize_(torch, model, seed=1)
        model.to(device)
        optimizer, _ = build_optimizer_from_config(cfg, model)
        step = make_train_step(model, LossConfig.from_config(cfg), zero,
                               image_size=model.image_size, compute_dtype=dtype)
        _, metrics = step(TrainState.create(model, optimizer), batch, 0)
        out[device] = {k: float(metrics[k]) for k in ("loss", "mse", "grad_norm")}
    rel = {k: abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    result = {"cpu_fp32": out["cpu"], "gpu_bf16": out["cuda"], "rel_diff": rel,
              "ok": rel["loss"] <= PARITY_LOSS_RTOL and rel["grad_norm"] <= PARITY_GNORM_RTOL}
    if not result["ok"]:
        failures.append(f"train-step parity: {result}")
    return result


def enclosing_spans(spans: list, queries: list) -> dict:
    """For host spans of one thread (properly nested, ``ts``/``dur`` in us)
    and ``(key, ts)`` queries, ``{key: [spans open at ts, outermost
    first]}``, by one sweep over both in time order."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, j = {}, [], 0
    for key, ts in sorted(queries, key=lambda q: q[1]):
        while j < len(spans) and spans[j]["ts"] <= ts:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < spans[j]["ts"]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < ts:
            stack.pop()
        out[key] = [e for e in stack if e["ts"] + e["dur"] >= ts]
    return out


def kernel_owners(trace_path: Path, top: int = TRACE_TOP) -> dict:
    """The device records of a Chrome trace (``utils.profiling.trace`` with
    ``with_stack``), grouped by kernel name, the ``top`` by time, each with
    the owners of its time: the outermost and innermost ATen op around
    the launch, the innermost Python frame of the port around it, and for
    a backward kernel the backward node, whose forward op (linked by its
    autograd sequence number) gives the op and frame instead."""
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    host: dict = {}
    for e in events:
        if e.get("cat") in ("cpu_op", "python_function", "user_annotation"):
            host.setdefault((e["pid"], e["tid"]), []).append(e)

    def chains(points: list) -> dict:
        by_thread: dict = {}
        for key, e in points:
            by_thread.setdefault((e["pid"], e["tid"]), []).append((key, e["ts"]))
        out = {}
        for thread, queries in by_thread.items():
            out.update(enclosing_spans(host.get(thread, []), queries))
        return out

    def owner(chain: list) -> dict:
        aten = [e["name"] for e in chain if e["name"].startswith("aten::")]
        frames = [e["name"] for e in chain if e.get("cat") == "python_function"
                  and not e["name"].startswith(("torch/", "<built-in"))]
        ours = [f for f in frames if "msid_tpu_torch/" in f]
        frame = (ours or frames or [None])[-1]
        return {"op": aten[0] if aten else None,
                "inner_op": aten[-1] if len(aten) > 1 else None,
                "frame": frame and frame.split("msid_tpu_torch/")[-1]}

    launched = chains([(c, e) for c, e in launch.items()])
    forward_ops = {}                         # autograd sequence number -> forward op
    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if (e.get("cat") == "cpu_op" and seq is not None
                and e.get("args", {}).get("Fwd thread id") == 0
                and (seq not in forward_ops
                     or (e["ts"], -e["dur"]) < (forward_ops[seq]["ts"], -forward_ops[seq]["dur"]))):
            forward_ops[seq] = e                 # the outermost forward op of that number
    backward = {}
    for corr, chain in launched.items():
        node = next((e for e in chain if e["name"].startswith(
            "autograd::engine::evaluate_function: ")), None)
        if node is not None:
            backward[corr] = node
    forward_chain = chains([(seq, forward_ops[seq]) for seq in
                            {n.get("args", {}).get("Sequence number") for n in backward.values()}
                            if seq in forward_ops])
    groups: dict = {}
    for e in device:
        g = groups.setdefault(e["name"], {"us": 0.0, "launches": 0, "owners": {}})
        g["us"] += e["dur"]
        g["launches"] += 1
        corr = e.get("args", {}).get("correlation")
        who = owner(launched.get(corr, []))
        node = backward.get(corr)
        if node is not None:
            seq = node.get("args", {}).get("Sequence number")
            fwd = owner(forward_chain.get(seq, []))
            who = {"backward_of": node["name"].split(": ", 1)[-1],
                   "op": fwd["op"], "frame": fwd["frame"], "backward_op": who["op"]}
        label = json.dumps(who, sort_keys=True)
        g["owners"][label] = g["owners"].get(label, 0.0) + e["dur"]
    busy = sum(g["us"] for g in groups.values())
    ranked = sorted(groups.items(), key=lambda kv: -kv[1]["us"])[:top]
    return {"device_busy_ms": busy / 1e3, "device_records": len(device),
            "kernels": [{"kernel": name[:120], "ms": g["us"] / 1e3, "launches": g["launches"],
                         "share_of_busy": g["us"] / busy,
                         "owners": [dict(json.loads(k), ms=v / 1e3) for k, v in sorted(
                             g["owners"].items(), key=lambda kv: -kv[1])[:3]]}
                        for name, g in ranked]}


def phase_train(torch, failures: list, card: str) -> dict:
    """The flagship trains on the card: parity, a 1-epoch Trainer.fit with
    the launch counts, then step times, memory and a profiler breakdown.
    The fit's step replays CUDA graphs after its first (eager) step: N1
    counts at the eager step and at the capture, never at a replay; K2 runs
    eagerly in every step."""
    from msid_tpu_torch.models.blocks import Norm
    from msid_tpu_torch.training import train_state
    from msid_tpu_torch.training.train_state import make_train_step
    from msid_tpu_torch.utils.config import load_config
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    cfg = load_config(CONFIG)
    result = {"check": "train", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    t0 = time.perf_counter()
    result["parity"] = train_step_parity(torch, cfg, failures)
    result["parity_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    session = setup_training_session(cfg, output_dir=run_dir.name, synthetic=True, epochs=1,
                                     seed=0)
    trainer, model = session["trainer"], session["model"]
    result["setup_seconds"] = time.perf_counter() - t0
    result["accum_steps"] = trainer.accum_steps
    print(f"train: accum_steps={trainer.accum_steps}", flush=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    labels = trainer.state.optimizer.labels
    train_loader, val_loader = session["train_loader"], session["val_loader"]
    steps, val_batches = len(train_loader), len(val_loader)

    torch.cuda.reset_peak_memory_stats()
    clear_launches()
    t0 = time.perf_counter()
    history = trainer.fit(train_loader, val_loader, epochs=1)
    torch.cuda.synchronize()
    result["fit_seconds"] = time.perf_counter() - t0
    launches = {"noise": launched("noise"), "resblock": launched("resblock"),
                "batchnorm": launched("batchnorm")}
    norms = sum(isinstance(m, Norm) and m.kind == "batch" for m in model.modules())
    graphs = trainer.train_step.graphs
    replays = sum(g.replays for g in graphs.values())
    # micro-batches run eagerly, and one a capture
    counted = (steps - replays) * trainer.accum_steps + len(graphs)
    print(f"train: {replays} of {steps} steps replayed, {len(graphs)} capture(s)", flush=True)
    result.update(launches=launches, steps=steps, val_batches=val_batches,
                  replays=replays, captures=len(graphs),
                  nan_skips=trainer.state.nan_skips, history=history,
                  fit_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    finite = all(np.isfinite(v).all() for k, v in history.items() if k != "lr")
    frozen_changed = [k for k in before if labels[k] == "frozen" and
                      not torch.equal(before[k], model.get_parameter(k))]
    stuck = [k for k in before if labels[k] != "frozen" and
             torch.equal(before[k], model.get_parameter(k))]
    frozen_blocks = {k.split(".")[2] for k in before
                     if k.startswith("encoder.blocks.") and labels[k] == "frozen"}
    checks = {
        "finite": finite, "nan_skips": trainer.state.nan_skips == 0,
        "frozen_unchanged": not frozen_changed, "others_changed": not stuck,
        "frozen_blocks_0_5": frozen_blocks == {str(i) for i in range(6)},
        "noise_launches": launches["noise"] == steps + val_batches,
        "resblock_launches": launches["resblock"] == 8 * val_batches,
        "batchnorm_launches": (launches["batchnorm"]      # N1: 3 + 3 a norm a micro-batch
                               == 6 * norms * counted),
        "replayed": (len(graphs) == 1
                     and replays == steps - train_state.CAPTURE_AFTER),
        "steps": steps == 6 and val_batches == 2,
    }
    result["checks"] = checks
    for name, ok in checks.items():
        if not ok:
            failures.append(f"train: {name} failed ({frozen_changed[:3]} {stuck[:3]} "
                            f"{launches} steps={steps} val={val_batches})")

    batch = next(iter(train_loader))
    times: dict[str, list] = {"pallas": [], "jnp": []}
    turns = []
    steps_by_impl = {impl: make_train_step(
        model, trainer.loss_cfg, trainer.noise_cfg, image_size=model.image_size,
        noise_impl=impl, compute_dtype=trainer.compute_dtype) for impl in times}
    torch.cuda.reset_peak_memory_stats()
    for impl in ("pallas", "jnp", "jnp", "pallas"):      # in turns, after a warmup
        for i in range(TIMED_STEPS + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            steps_by_impl[impl](trainer.state, batch, 100 + i)
            end.record()
            torch.cuda.synchronize()
            if i:
                times[impl].append((start.elapsed_time(end), (time.perf_counter() - t0) * 1e3))
        turns.append([impl, float(np.median([p[0] for p in times[impl][-TIMED_STEPS:]]))])
    result["step_turns_device_p50_ms"] = turns
    for impl, pairs in times.items():
        dev = float(np.median([p[0] for p in pairs]))
        host = float(np.median([p[1] for p in pairs]))
        result[f"step_{impl}"] = {"device_p50_ms": dev, "host_p50_ms": host,
                                  "tiles_per_s": batch.shape[0] * 1e3 / host,
                                  "steps": len(pairs)}
    result["step_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # one step under the port's trace, its kernels named with their owners
    from msid_tpu_torch.utils.profiling import trace

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        with trace(logdir, with_stack=True):
            steps_by_impl["pallas"](trainer.state, batch, 8)
        trace_file = next(Path(logdir).glob("*.json"))
        trace_mb = trace_file.stat().st_size / 1e6
        owners = kernel_owners(trace_file)
    owners.update(trace_mb=trace_mb, seconds=time.perf_counter() - t0)
    result["traced_step"] = owners
    print(json.dumps({"train_step_top_kernels": owners["kernels"]}), flush=True)
    if not (owners["kernels"] and owners["device_busy_ms"] > 0):
        failures.append(f"train: the traced step shows no kernel: {owners}")
    prof = device_profile(torch, lambda: steps_by_impl["pallas"](trainer.state, batch, 7),
                          iters=2, tags={"noise_ms": "noise_"})
    prof["noise_share_of_busy"] = prof["noise_ms"] / prof["device_busy_ms"]
    prof["device_idle_share"] = 1 - prof["device_busy_ms"] / result["step_pallas"]["host_p50_ms"]
    result["profile"] = prof
    session["checkpoint_manager"].wait_until_finished()
    run_dir.cleanup()
    emit(result)
    return result


def evaluate_fp32_against_cpu(torch, fp32_config: Path, ckpt_dir: Path) -> dict:
    """8 tiles of the first validation batch, corrupted once on the card
    (K2, the first batch's eval seed), restored in fp32 by the checkpoint's
    weights on the card (K4) and on the CPU from the same noisy tensor."""
    from msid_tpu_torch.data.pipeline import get_dataloaders
    from msid_tpu_torch.ops.metrics import batch_metric_sums
    from msid_tpu_torch.ops.noise import NoiseConfig, corrupt, fold_in
    from msid_tpu_torch.ops.preprocess import preprocess_tiles
    from msid_tpu_torch.training.eval import split_batch_item
    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.config import load_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    config = load_config(fp32_config)
    config["data"]["root_dir"] = "/nonexistent-forces-synthetic"
    saved, _, step = CheckpointManager(ckpt_dir).load_latest()
    weights = dict(saved["model"], **(saved["ema"] or {}))
    models = {}
    for device in ("cuda", "cpu"):
        models[device], _ = create_model_from_config(config, 0, device)
        models[device].load_state_dict(weights)
        models[device].eval()
    _, val_loader = get_dataloaders(config)
    batch, _ = split_batch_item(next(iter(val_loader)))
    with torch.no_grad():
        clean = preprocess_tiles(
            torch.as_tensor(batch[:8], device="cuda"), models["cuda"].image_size)
        noisy = corrupt(fold_in(EVAL_SEED, 0), clean, NoiseConfig.from_config(config),
                        impl="pallas")
        clear_launches()
        out = models["cuda"](noisy)
        torch.cuda.synchronize()
        k4, k1 = launched("resblock_fp32"), launched("resblock")
        torch.set_num_threads(8)
        t0 = time.perf_counter()
        ref = models["cpu"](noisy.cpu())
        cpu_seconds = time.perf_counter() - t0
        got_m = {k: float(v) / 8 for k, v in batch_metric_sums(out, clean).items()}
        want_m = {k: float(v) / 8 for k, v in batch_metric_sums(ref, clean.cpu()).items()}
    rel_metrics = {k: abs(got_m[k] - want_m[k]) / max(abs(want_m[k]), 1e-12)
                   for k in ("psnr", "ssim", "sam", "rmse")}
    return {"step": step, "tiles": 8, "k4_launches": k4, "k1_launches": k1,
            "rel_rms_vs_cpu_fp32": rel_rms(out.cpu().numpy(), ref.numpy()),
            "gpu_metrics": got_m, "cpu_metrics": want_m, "rel_metric_diff": rel_metrics,
            "cpu_forward_seconds": cpu_seconds}


def phase_evaluate(torch, failures: list, card: str) -> dict:
    """The evaluate path through the CLIs a user runs: train one epoch and
    checkpoint, then score the checkpoint in bf16, fp32, with TTA and as an
    ensemble, holding each to the trainer's validation line or the CPU."""
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from msid_tpu_torch.scripts import train as train_cli
    from msid_tpu_torch.utils import checkpointing

    result = {"check": "evaluate", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    metrics = ("loss", "psnr", "ssim", "sam", "rmse")
    launches = {"resblock": 0, "noise": 0, "resblock_fp32": 0}
    write_step = checkpointing._write_step
    save_seconds = []

    def timed_write_step(*args, **kwargs):
        t0 = time.perf_counter()
        write_step(*args, **kwargs)
        save_seconds.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        tmp = Path(tmp)
        ckpt = tmp / "run" / "checkpoints"
        common = ["--synthetic", "--device", "cuda"]
        checkpointing._write_step = timed_write_step
        try:
            t0 = time.perf_counter()
            history = train_cli.main(["--config", str(CONFIG), *common, "--epochs", "1",
                                      "--output-dir", str(tmp / "run")])
            result["train_seconds"] = time.perf_counter() - t0
        finally:
            checkpointing._write_step = write_step
        steps = sorted(int(d.name) for d in ckpt.iterdir() if d.name.isdigit())
        files = [f for f in (ckpt / str(steps[-1])).iterdir()]
        result["checkpoint"] = {
            "steps": steps, "bytes": sum(f.stat().st_size for f in files),
            "save_seconds": save_seconds,
            "files": {f.name: f.stat().st_size for f in files}}
        last = {k: history[f"val_{k}"][-1] for k in metrics}
        result["trainer_last_val"] = last

        fp32_config = tmp / "fp32.yaml"
        fp32_config.write_text(f"inherits: {CONFIG}\ntraining:\n  mixed_precision: false\n")
        runs = {
            "bf16": ["--config", str(CONFIG)],
            "fp32": ["--config", str(fp32_config)],
            "tta8_bf16": ["--config", str(CONFIG), "--tta", "8"],
            "ensemble2_bf16": ["--config", str(CONFIG), "--ensemble", str(ckpt)],
        }
        for name, argv in runs.items():
            clear_launches()
            t0 = time.perf_counter()
            out = evaluate_cli.main([*argv, *common, "--checkpoint", str(ckpt),
                                     "--output-dir", str(tmp / name)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {"resblock": launched("resblock"), "noise": launched("noise"),
                      "resblock_fp32": launched("resblock_fp32")}
            for k, v in counts.items():
                launches[k] += v
            result[name] = {"seconds": seconds, "launches": counts,
                            **{k: out[k] for k in metrics}, "num_samples": out["num_samples"]}
        val_batches = result["bf16"]["launches"]["noise"]
        result["val_batches"] = val_batches

        def rel(a, b):
            return {k: abs(a[k] - b[k]) / abs(b[k]) for k in metrics}

        result["bf16_vs_trainer"] = rel(result["bf16"], last)
        result["ensemble_vs_single"] = rel(result["ensemble2_bf16"], result["bf16"])
        result["fp32_vs_cpu"] = evaluate_fp32_against_cpu(torch, fp32_config, ckpt)

    fp32_cpu = result["fp32_vs_cpu"]
    checks = {
        "val_batches": val_batches == 2 and all(
            result[n]["launches"]["noise"] == val_batches for n in runs),
        "bf16_reproduces_trainer": max(result["bf16_vs_trainer"].values()) <= EVAL_RTOL,
        "bf16_launches": result["bf16"]["launches"]["resblock"] == 8 * val_batches
        and result["bf16"]["launches"]["resblock_fp32"] == 0,
        "fp32_launches": result["fp32"]["launches"]["resblock_fp32"] == 8 * val_batches
        and result["fp32"]["launches"]["resblock"] == 0,
        "fp32_forward_launches": fp32_cpu["k4_launches"] == 8 and fp32_cpu["k1_launches"] == 0,
        "fp32_matches_cpu": fp32_cpu["rel_rms_vs_cpu_fp32"] <= FP32_FORWARD_REL_RMS
        and max(fp32_cpu["rel_metric_diff"].values()) <= FP32_METRIC_RTOL,
        "tta8_launches": result["tta8_bf16"]["launches"]["resblock"] == 64 * val_batches,
        "ensemble_equals_single": max(result["ensemble_vs_single"].values()) <= EVAL_RTOL
        and result["ensemble2_bf16"]["launches"]["resblock"] == 16 * val_batches,
        "finite": all(np.isfinite([result[n][k] for k in metrics]).all() for n in runs),
        "checkpoint_written": bool(result["checkpoint"]["steps"]),
    }
    result["checks"] = checks
    result["launches"] = launches
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"evaluate: {name} failed")
    return result


def within(torch, got, want) -> bool:
    """|got - want| <= ATOL + RTOL |want| everywhere, and got finite."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= ATOL + RTOL * want.float().abs()).all()
                and torch.isfinite(got.float()).all())


def phase_probe(torch, F, failures: list) -> dict:
    """K5 and K3 against their plain versions (K3 against K1 too), with
    times, then the kernel probe's entry point for every variant."""
    from msid_tpu_torch.benchmarks import kernel_probe
    from msid_tpu_torch.ops import _build, cuda_decoder, cuda_probe

    result: dict = {"k5": [], "k3": []}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in ANY_DMA_SHAPES:                       # the small one first
        g = torch.Generator(device="cuda").manual_seed(shape[0])
        x = torch.randn(shape, device="cuda", generator=g)
        encodes = [_build.tensor_map_encodes("any_dma")]
        got = cuda_probe.any_dma_scale(x)
        want = cuda_probe.any_dma_scale_reference(x)
        torch.cuda.synchronize()
        encodes.append(_build.tensor_map_encodes("any_dma"))
        cuda_probe.any_dma_scale(x)                    # the same x: its map is kept
        encodes.append(_build.tensor_map_encodes("any_dma"))
        for _ in range(5):                             # the same x, out freed each time
            cuda_probe.any_dma_scale(x)
        torch.cuda.synchronize()
        encodes.append(_build.tensor_map_encodes("any_dma"))
        row = {"check": "any_dma", "shape": list(shape),
               "max_abs_err": float((got - want).abs().max()),
               "ok": torch.equal(got, want),
               "encodes_first_call": encodes[1] - encodes[0],
               "encodes_second_call": encodes[2] - encodes[1],
               "encodes_5_more_calls": encodes[3] - encodes[2],
               "device_ms": graph_ms(torch, lambda: cuda_probe.any_dma_scale(x)),
               "call_ms": time_ms(torch, lambda: cuda_probe.any_dma_scale(x)),
               "plain_device_ms": graph_ms(
                   torch, lambda: cuda_probe.any_dma_scale_reference(x)),
               "plain_call_ms": time_ms(torch, lambda: cuda_probe.any_dma_scale_reference(x)),
               "library_device_ms": graph_ms(torch, lambda: x * 2),
               "library_call_ms": time_ms(torch, lambda: x * 2),
               "library": "x * 2 (one elementwise kernel)",
               "bytes": 2 * x.numel() * 4,
               "bound_ms": 2 * x.numel() * 4 / PEAK_HBM_BYTES * 1e3, "bound_by": "bytes"}
        for name, fn in (("kernel", lambda: cuda_probe.any_dma_scale(x)),
                         ("library", lambda: x * 2)):
            row[f"{name}_profiled_ms"] = device_profile(torch, fn, iters=20)["device_busy_ms"]
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["device_vs_library"] = row["device_ms"] / row["library_device_ms"]
        row["call_vs_library"] = row["call_ms"] / row["library_call_ms"]
        emit(row)
        result["k5"].append(row)
        if not (row["ok"] and row["encodes_first_call"] <= 1
                and row["encodes_second_call"] == 0 and row["encodes_5_more_calls"] == 0):
            failures.append(f"any_dma {shape}: equal to x * 2: {row['ok']} "
                            f"({row['max_abs_err']}), encodes {encodes}")
        del x, got, want

    lib = library_block(torch, F)
    # A wrong byte count on the barrier would hang: the first launch is a
    # small one, synchronised on its own.
    tiny = random_block_inputs(torch, 48, 8, 1, seed=1)
    if not within(torch, cuda_decoder.fused_residual_block_v2(*tiny),
                  cuda_decoder.fused_residual_block_v2_reference(*tiny)):
        failures.append("resblock_v2 [1,8,8,48]: disagrees with its plain version")
    torch.cuda.synchronize()
    cases = [(c, s, b, random_block_inputs(torch, c, s, b, seed=c + b), 20)
             for c, s in SHAPES for b in BATCHES]
    pb, ph, pw, pc = PROBE_SHAPE
    cases.append((pc, ph, pb, kernel_probe.make_inputs(PROBE_SHAPE, torch.device("cuda")), 5))
    for c, s, b, (x, w1, w2, aff), iters in cases:
        got = cuda_decoder.fused_residual_block_v2(x, w1, w2, aff)
        ragged = cuda_decoder.fused_residual_block_v2(x, w1, w2, aff, *K3_RAGGED_TILE)
        want = cuda_decoder.fused_residual_block_v2_reference(x, w1, w2, aff)
        k1 = cuda_decoder.fused_residual_block(x, w1, w2, aff)
        torch.cuda.synchronize()
        ok_plain, ok_k1 = within(torch, got, want), within(torch, got, k1)
        ok_ragged = within(torch, ragged, want)
        kw1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        kw2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
        geometry = cuda_decoder.v2_tile(c, s, s, b, sms=sms)
        w1k, w2k = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
        row = {
            "check": "resblock_v2", "C": c, "H": s, "W": s, "B": b,
            "tile": list(geometry[:2]), "cluster": geometry[2], "stages": geometry[3],
            "k1_geometry": list(cuda_decoder.bf16_tiling(c, s, s, b, sms)),
            "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2(
                x, w1k, w2k, aff), iters=iters),
            "functional_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2(
                x, w1, w2, aff), iters=iters),
            "k1_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
                x, w1k, w2k, aff), iters=iters),
            "plain_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_v2_reference(
                x, w1, w2, aff), iters=min(iters, 10), warmup=1),
            "library_ms": time_ms(torch, lambda: lib(x, kw1, kw2, aff), iters=iters),
            "library": "cuDNN bf16 conv2d composition (channels-last)",
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_abs_vs_k1": float((got.float() - k1.float()).abs().max()),
            "ragged_tile": list(K3_RAGGED_TILE),
            "ragged_max_abs_err": float((ragged.float() - want.float()).abs().max()),
            "ok": ok_plain and ok_k1 and ok_ragged,
        }
        row["tflops"] = flops / row["kernel_ms"] / 1e9
        row["share_of_bound"] = bound_ms / row["kernel_ms"]
        emit(row)
        result["k3"].append(row)
        if not row["ok"]:
            failures.append(f"resblock_v2 C={c} H={s} B={b}: vs plain {row['max_abs_err']} "
                            f"({ok_plain}), vs K1 {row['max_abs_vs_k1']} ({ok_k1}), tile "
                            f"{K3_RAGGED_TILE} vs plain {row['ragged_max_abs_err']} ({ok_ragged})")
    del cases

    # The entry point, one variant per call as a user runs it. Each variant
    # moves its own kernel's count by the calls it makes, and no other.
    kernels = ("resblock", "resblock_fp32", "resblock_v2", "any_dma")
    moves = {"xla": None, "xla_bf16": None, "fused": "resblock_fp32", "v3": "resblock",
             "v2": "resblock_v2", "v2:8:32": "resblock_v2", "any_dma": "any_dma"}
    clear_launches()
    result["launches"] = {k: 0 for k in kernels}
    result["variants"] = {}
    for variant, kernel in moves.items():
        before = {k: launched(k) for k in kernels}
        out = kernel_probe.main([variant, "--shape", ",".join(map(str, PROBE_SHAPE)),
                                 "--iters", str(PROBE_ITERS)])
        torch.cuda.synchronize()
        moved = {k: launched(k) - before[k] for k in kernels}
        expected = {k: (out["calls"] if k == kernel else 0) for k in kernels}
        out["launches"] = moved
        result["variants"][variant] = out
        for k, v in moved.items():
            result["launches"][k] += v
        if moved != expected:
            failures.append(f"probe {variant}: counts moved by {moved}, expected {expected}")
        if variant == "any_dma":
            if out["correct"] is not True:
                failures.append("probe any_dma: not correct")
        elif not (np.isfinite(out["ms"]) and out["ms"] > 0):
            failures.append(f"probe {variant}: bad time {out['ms']}")
        elif out["max_abs_vs_xla"] is not None and not out["max_abs_vs_xla"] <= 0.25:
            # bf16 outputs of |y| <= ~16 differ from the fp32-output block's
            # by a few bf16 ulps (2^-4 at 8..16)
            failures.append(f"probe {variant}: max|d| vs xla {out['max_abs_vs_xla']}")
    emit({"check": "probe", "shape": list(PROBE_SHAPE), "iters": PROBE_ITERS,
          "variants": result["variants"], "launches": result["launches"]})
    return result


def phase_hybrid(torch, failures: list, card: str) -> dict:
    """The folded-BN graphs on the default full-width model: the session's
    choice, agreement with the module's forward, launch counts, device
    times; then ``--forward hybrid`` through the evaluate CLI."""
    from msid_tpu_torch.deployment import fastpath
    from msid_tpu_torch.deployment.inference import (
        CAPTURE_WARMUP,
        CapturedForward,
        InferenceSession,
    )
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from msid_tpu_torch.scripts import train as train_cli

    def block_counts():
        return launched("resblock"), launched("resblock_fp32"), launched("resblock_v2")

    cpu_model = SatMAERestoration().eval()               # the defaults: the model bench.py times
    randomize_(torch, cpu_model, seed=2)
    models = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        models[name] = SatMAERestoration().set_compute_dtype(dtype).to("cuda").eval()
        models[name].load_state_dict(cpu_model.state_dict())
    del cpu_model
    model = models["bfloat16"]
    size, bands = model.image_size, model.in_channels
    result = {"check": "hybrid", "model": "SatMAERestoration() defaults: ViT-Base, "
              "unet_light 384/192/96/48, no fill", "card": card}
    launches = {"resblock": 0, "resblock_fp32": 0}

    def session(b, optimize, m=model):
        return InferenceSession(m, batch_size=b, image_size=size, num_bands=bands,
                                optimize=optimize)

    chosen = {"auto_b1": session(1, "auto").optimized, "auto_b16": session(16, "auto").optimized,
              "true_b1": session(1, True).optimized, "false_b16": session(16, False).optimized}
    result["chosen"] = chosen
    if chosen != {"auto_b1": False, "auto_b16": "hybrid", "true_b1": "fastpath",
                  "false_b16": False}:
        failures.append(f"hybrid: the session chose {chosen}")

    # Agreement and launch counts: bf16 at B=16 through the sessions a user
    # builds (each captured: its warmup and capture move the counts, its
    # replays do not), fp32 at B=2 with the graphs called directly (auto
    # would serve the module's forward at B=2).
    x16 = noisy_tiles(16, size, bands, seed=300)
    clear_launches()
    apply16 = session(16, False)
    ref = apply16.predict(x16)
    after_apply = block_counts()
    folded = {"hybrid": session(16, "auto"), "fastpath": session(16, True)}
    outs = {k: v.predict(x16) for k, v in folded.items()}
    after_folded = block_counts()
    launches["resblock"] += device_launches(after_folded[0], apply16)
    captured = {"apply": apply16.captured_launches,
                **{k: v.captured_launches for k, v in folded.items()}}
    result["bf16_b16"] = {"captured_launches": captured,
                          "apply_launches": list(after_apply),
                          "folded_launches": [a - b for a, b in zip(after_folded, after_apply)],
                          "rel_rms_vs_apply": {k: rel_rms(v, ref) for k, v in outs.items()}}
    # warmup and capture of the module's forward: 3 x 8 K1 launches counted
    expect_apply = (8 * (CAPTURE_WARMUP + 1), 0, 0)
    if (captured != {"apply": 8, "hybrid": 0, "fastpath": 0} or after_apply != expect_apply
            or after_folded != after_apply):
        failures.append(f"hybrid bf16: captured {captured}; block-kernel counts "
                        f"{after_apply} after the module's forward, {after_folded} after the "
                        f"folded graphs")
    for k, v in result["bf16_b16"]["rel_rms_vs_apply"].items():
        if not (v <= MAX_REL_RMS and np.isfinite(outs[k]).all()):
            failures.append(f"hybrid bf16 {k}: rel RMS {v} vs the module's forward")
    del apply16, folded
    torch.cuda.empty_cache()

    m32 = models["float32"]
    x2 = torch.from_numpy(noisy_tiles(2, size, bands, seed=301)).cuda()
    with torch.inference_mode():
        clear_launches()
        ref32 = m32(x2)
        after_apply = block_counts()
        tree = fastpath.optimize_for_inference(m32, upsample="both")
        outs32 = {
            "fastpath_matmul": fastpath.make_fast_inference_fn(m32, True)(tree, x2),
            "fastpath_ct": fastpath.make_fast_inference_fn(m32, False)(tree, x2),
            "hybrid": fastpath.make_hybrid_inference_fn(m32)(
                fastpath.optimize_for_hybrid(m32), x2),
            "hybrid_live_fold": fastpath.make_hybrid_forward(m32)(None, x2),
        }
        torch.cuda.synchronize()
        after_folded = block_counts()
    launches["resblock_fp32"] += after_folded[1]
    result["fp32_b2"] = {"apply_launches": list(after_apply),
                         "rel_rms_vs_apply": {k: rel_rms(v.cpu().numpy(), ref32.cpu().numpy())
                                              for k, v in outs32.items()}}
    if after_apply != (0, 8, 0) or after_folded != after_apply:
        failures.append(f"hybrid fp32: block-kernel counts {after_apply} after the module's "
                        f"forward, {after_folded} after the folded graphs")
    for k, v in result["fp32_b2"]["rel_rms_vs_apply"].items():
        if not v <= HYBRID_FP32_REL_RMS:
            failures.append(f"hybrid fp32 {k}: rel RMS {v} vs the module's forward")
    del tree, outs32, ref32, m32, models["float32"]
    torch.cuda.empty_cache()

    # Device p50 of the three graphs, each eager and captured as a session
    # captures it (CapturedForward), in turns (there and back), each called
    # as the session calls it ("auto" itself serves the module's forward
    # below 8, so a session cannot be asked for the hybrid graph at B=1).
    before = launched("resblock")
    times: dict = {}
    for b in HYBRID_BATCHES:
        iters, warmup = (30, 5) if b < 128 else (10, 3)
        xb = torch.from_numpy(np.random.default_rng(b).uniform(
            -2.0, 2.0, (b, size, size, bands)).astype(np.float32)).cuda()
        hybrid_fn = fastpath.make_hybrid_inference_fn(model)
        fast_fn = fastpath.make_fast_inference_fn(model, matmul_upsample=True)
        with torch.inference_mode():
            hybrid_w = fastpath.optimize_for_hybrid(model)
            fast_w = fastpath.optimize_for_inference(model, upsample="matmul")
        forwards = {"apply": lambda x: model(x.to(model.dtype)).float(),
                    "hybrid": lambda x: hybrid_fn(hybrid_w, x).float(),
                    "fastpath": lambda x: fast_fn(fast_w, x).float()}

        def inference(fn):
            def run(x):
                with torch.inference_mode():
                    return fn(x)
            return run

        captured = {k: CapturedForward(inference(fn), xb, model) for k, fn in forwards.items()}
        turns: dict = {k: {"eager": [], "graph": []} for k in forwards}
        for name in ("apply", "hybrid", "fastpath", "fastpath", "hybrid", "apply"):
            turns[name]["eager"].append(
                time_ms(torch, functools.partial(inference(forwards[name]), xb), iters, warmup))
            turns[name]["graph"].append(time_ms(torch, captured[name], iters, warmup))
        times[f"b{b}"] = {}
        for name in forwards:
            row = times[f"b{b}"][name] = {"captured_launches": captured[name].launches}
            for form, fn in (("eager", functools.partial(inference(forwards[name]), xb)),
                             ("graph", captured[name])):
                p50 = float(np.mean(turns[name][form]))
                prof = device_profile(torch, fn, iters=2)
                row[form] = {"device_p50_ms_turns": turns[name][form], "device_p50_ms": p50,
                             "tiles_per_s": b * 1e3 / p50,
                             "device_busy_ms": prof["device_busy_ms"],
                             "device_launches": prof["device_launches"],
                             "device_idle_share": 1 - prof["device_busy_ms"] / p50}
            if captured[name].launches != (8 if name == "apply" else 0):
                failures.append(f"hybrid B={b} {name}: {captured[name].launches} block "
                                f"kernel launches captured")
            graph_out = captured[name]().clone()
            eager_out = inference(forwards[name])(xb)
            row["graph_equals_eager"] = bool(torch.equal(graph_out, eager_out))
            if not row["graph_equals_eager"]:
                failures.append(f"hybrid B={b} {name}: graph and eager differ, max abs "
                                f"{float((graph_out - eager_out).abs().max())}")
            del graph_out, eager_out
        apply_graph = captured["apply"]
        launches["resblock"] += (apply_graph.replays - 1) * apply_graph.launches
        del xb, hybrid_w, fast_w, captured, apply_graph
        torch.cuda.empty_cache()
    launches["resblock"] += launched("resblock") - before
    result["device_times"] = times

    # --forward hybrid through the CLIs, fp32, on the flagship without its
    # fill stage; and its refusal on the flagship.
    metrics = ("loss", "psnr", "ssim", "sam", "rmse")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as tmp:
        tmp = Path(tmp)
        common = ["--synthetic", "--device", "cuda"]
        t0 = time.perf_counter()
        train_cli.main(["--config", str(SKIP_CONFIG), *common, "--epochs", "1",
                        "--output-dir", str(tmp / "run")])
        result["train_seconds"] = time.perf_counter() - t0
        fp32_config = tmp / "fp32.yaml"
        fp32_config.write_text(
            f"inherits: {SKIP_CONFIG}\ntraining:\n  mixed_precision: false\n")
        scores = {}
        for name, config, impl in (("apply", fp32_config, "apply"),
                                   ("hybrid", fp32_config, "hybrid"),
                                   ("apply_bf16", SKIP_CONFIG, "apply"),
                                   ("hybrid_bf16", SKIP_CONFIG, "hybrid")):
            clear_launches()
            t0 = time.perf_counter()
            out = evaluate_cli.main(["--config", str(config), *common, "--forward", impl,
                                     "--checkpoint", str(tmp / "run" / "checkpoints"),
                                     "--output-dir", str(tmp / name)])
            torch.cuda.synchronize()
            scores[name] = {"seconds": time.perf_counter() - t0,
                            "block_launches": list(block_counts()),
                            **{k: out[k] for k in metrics}}
        launches["resblock_fp32"] += scores["apply"]["block_launches"][1]
        launches["resblock"] += scores["apply_bf16"]["block_launches"][0]
        refused = False
        try:
            evaluate_cli.main(["--config", str(CONFIG), *common, "--forward", "hybrid",
                               "--output-dir", str(tmp / "refused")])
        except ValueError as err:
            refused = "input_fill" in str(err)
    result["evaluate"] = scores
    result["evaluate_rel_diff"] = {k: abs(scores["hybrid"][k] - scores["apply"][k])
                                   / abs(scores["apply"][k]) for k in metrics}
    result["evaluate_rel_diff_bf16"] = {
        k: abs(scores["hybrid_bf16"][k] - scores["apply_bf16"][k])
        / abs(scores["apply_bf16"][k]) for k in metrics}
    result["flagship_forward_hybrid_refused"] = refused
    checks = {
        "evaluate_hybrid_equals_apply":
            max(result["evaluate_rel_diff"].values()) <= HYBRID_METRIC_RTOL,
        "evaluate_apply_launches_k4": scores["apply"]["block_launches"][1] > 0
        and scores["apply"]["block_launches"][0] == 0,
        "evaluate_hybrid_launches_no_block_kernel": scores["hybrid"]["block_launches"] == [0, 0, 0]
        and scores["hybrid_bf16"]["block_launches"] == [0, 0, 0],
        "evaluate_bf16_hybrid_close_to_apply":
            max(result["evaluate_rel_diff_bf16"].values()) <= HYBRID_BF16_METRIC_RTOL
            and scores["apply_bf16"]["block_launches"][0] > 0,
        "flagship_refused": refused,
        "finite": all(np.isfinite([scores[i][k] for k in metrics]).all() for i in scores),
    }
    result["checks"] = checks
    result["launches"] = launches
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"hybrid: {name} failed")
    return result


def scene_windows(h: int, w: int) -> int:
    from msid_tpu_torch.deployment.sliding_window import _window_origins

    stride = SCENE_WINDOW - SCENE_OVERLAP
    return (len(_window_origins(h, SCENE_WINDOW, stride))
            * len(_window_origins(w, SCENE_WINDOW, stride)))


def max_rel(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(a - ref) / np.maximum(np.abs(ref), 1e-6)))


def scene_cli(torch, cfg: dict, weights: dict, dev_step, failures: list) -> dict:
    """``python -m msid_tpu_torch.scripts.restore --streaming auto`` on a
    4096x4096x13 uint16 TIFF from a checkpoint of ``weights``, in a child
    process; its output against the same scene streamed in this process by
    ``dev_step`` (the same weights in bf16)."""
    from msid_tpu_torch.data.tiff import read_tiff, write_tiff
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.scripts.restore import AUTO_STREAM_PIXELS
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState
    from msid_tpu_torch.utils.checkpointing import CheckpointManager
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config

    h, w, _ = CLI_SCENE_SHAPE
    result = {"shape": list(CLI_SCENE_SHAPE), "mpix": h * w / 1e6,
              "streams_by_auto": h * w > AUTO_STREAM_PIXELS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as tmp:
        tmp = Path(tmp)
        model, _ = create_model_from_config(cfg, 0, "cpu")
        model.load_state_dict(weights)
        optimizer, _ = build_optimizer_from_config(cfg, model)
        CheckpointManager(tmp / "ckpt").save(1, TrainState.create(model, optimizer),
                                             metrics={"val_psnr": 0.0})
        del model, optimizer
        scene = np.random.default_rng(9).integers(0, 10000, CLI_SCENE_SHAPE, dtype=np.uint16)
        write_tiff(tmp / "scene.tif", scene)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "msid_tpu_torch.scripts.restore", "--config", str(CONFIG),
             "--checkpoint", str(tmp / "ckpt"), "--input", str(tmp / "scene.tif"),
             "--output", str(tmp / "restored.tif"), "--streaming", "auto"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        result["cli_seconds"] = time.perf_counter() - t0
        log = proc.stderr + proc.stdout
        result["returncode"] = proc.returncode
        result["cli_log_tail"] = log.strip().splitlines()[-4:]
        result["streamed"] = "Streaming restore" in log
        rate = [line for line in log.splitlines() if "Mpix/s" in line]
        result["cli_restore_line"] = rate[-1].split(": ", 1)[-1] if rate else None
        if proc.returncode != 0 or not result["streamed"]:
            failures.append(f"scene CLI: rc {proc.returncode}, streamed {result['streamed']}: "
                            f"{log[-2000:]}")
            return result
        out = read_tiff(tmp / "restored.tif")
        t0 = time.perf_counter()
        want = sw.restore_scene_streaming(None, None, scene, window=SCENE_WINDOW,
                                          overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH,
                                          step=dev_step, output_dtype=np.float32)
        seconds = time.perf_counter() - t0
    result.update(in_process_streaming_seconds=seconds,
                  in_process_streaming_mpix_per_s=h * w / 1e6 / seconds,
                  output_shape=list(out.shape), output_dtype=str(out.dtype),
                  finite=bool(np.isfinite(out).all()),
                  cli_vs_in_process_max_abs=float(np.abs(out - want).max()),
                  cli_vs_in_process_equal=bool(np.array_equal(out, want)))
    ok = (out.shape == CLI_SCENE_SHAPE and out.dtype == np.float32 and result["finite"]
          and np.allclose(out, want, rtol=SCENE_STREAM_RTOL, atol=SCENE_STREAM_RTOL))
    result["ok"] = bool(ok)
    if not ok:
        failures.append(f"scene CLI: output {out.shape} {out.dtype}, finite {result['finite']}, "
                        f"max abs vs in-process {result['cli_vs_in_process_max_abs']}")
    return result


def phase_scene(torch, failures: list, card: str) -> dict:
    """The full-width flagship restores a ragged uint16 scene through the
    host, device and streaming assemblies, in bf16 (K1) and fp32 (K4):
    the paths against each other, 8 block launches per window batch (the
    steps' captured launches times their replays, and by the profiler per
    replay and over a whole run of each path), Mpix/s of each path in
    turns, device busy time and idle share per batch from each path's own
    profiled run, peak memory; a small scene through the same B=64 graph
    against the plain fp32 restore on the CPU, in both dtypes; then the
    restore CLI streaming a 4096x4096 scene."""
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder

    cfg = load_flagship()
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    randomize_(torch, cpu_model, seed=3)
    weights = cpu_model.state_dict()
    size = cpu_model.image_size
    h, w, _ = SCENE_SHAPE
    scene = np.random.default_rng(4).integers(0, 10000, SCENE_SHAPE, dtype=np.uint16)
    small = scene[:SCENE_SMALL[0], :SCENE_SMALL[1]]
    torch.set_num_threads(8)
    small_want = sw.restore_scene(cpu_model, None, small, window=SCENE_WINDOW,
                                  overlap=SCENE_OVERLAP, model_size=size, batch_size=4,
                                  device_assembly=True, device="cpu")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    windows = scene_windows(h, w)
    batches = -(-windows // SCENE_BATCH)
    stride = SCENE_WINDOW - SCENE_OVERLAP
    xs = sw._window_origins(w, SCENE_WINDOW, stride)
    groups, _ = sw._band_plan(sw._window_origins(h, SCENE_WINDOW, stride), SCENE_WINDOW,
                              stride, SCENE_BAND_ROWS)
    per_run = {"host": batches, "device": batches,      # streaming: batches of each band
               "streaming": sum(-(-len(sub) * len(xs) // SCENE_BATCH) for _, sub in groups)}
    kw = dict(window=SCENE_WINDOW, overlap=SCENE_OVERLAP, model_size=size,
              batch_size=SCENE_BATCH)
    result = {"check": "scene", "config": str(CONFIG.relative_to(ROOT)), "card": card,
              "scene": list(SCENE_SHAPE), "scene_dtype": "uint16", "windows": windows,
              "batches": per_run, "window": SCENE_WINDOW, "overlap": SCENE_OVERLAP,
              "batch_size": SCENE_BATCH}
    launches = {}
    dev_step_bf16 = None
    for name, dtype, counter, other, tag, small_bound, tiling in (
            ("bf16", torch.bfloat16, "resblock", "resblock_fp32", "resblock_kernel",
             MAX_REL_RMS, cuda_decoder.bf16_tiling),
            ("fp32", torch.float32, "resblock_fp32", "resblock", "resblock_fp32_kernel",
             FP32_FORWARD_REL_RMS, cuda_decoder.fp32_tiling)):
        model = SatMAERestoration.from_config(cfg, dtype=dtype)
        model.load_state_dict(weights)
        clear_launches()
        host_step = sw.make_scene_step(model, None, SCENE_WINDOW, size)
        dev_step = sw.make_device_scene_step(model, None, SCENE_WINDOW, size, SCENE_OVERLAP)
        del model
        steps = {"host": host_step, "device": dev_step, "streaming": dev_step}
        paths = {
            "host": lambda: sw.restore_scene(None, None, scene, step=host_step, **kw),
            "device": lambda: sw.restore_scene(None, None, scene, step=dev_step,
                                               device_assembly=True, **kw),
            "streaming": lambda: sw.restore_scene_streaming(
                None, None, scene, step=dev_step, output_dtype=np.float32,
                band_origin_rows=SCENE_BAND_ROWS, **kw),
        }
        row: dict = {"paths": {}}
        outs = {}
        for path, run in paths.items():        # the first run captures the step's graph
            torch.cuda.reset_peak_memory_stats()
            replays = steps[path].replays
            t0 = time.perf_counter()
            outs[path] = run()
            row["paths"][path] = {
                "first_seconds": time.perf_counter() - t0,
                "first_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "replays_per_run": steps[path].replays - replays, "seconds": []}
        for path in ("host", "device", "streaming", "streaming", "device", "host"):
            torch.cuda.reset_peak_memory_stats()
            replays = steps[path].replays
            t0 = time.perf_counter()
            out = paths[path]()
            seconds = time.perf_counter() - t0
            p = row["paths"][path]
            p["seconds"].append(seconds)
            p["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
            p["repeat_equal"] = p.get("repeat_equal", True) and bool(np.array_equal(out, outs[path]))
            p["replays_per_run_steady"] = steps[path].replays - replays
        # by the profiler: one whole run of each path (its device time over
        # its own batches: copies, gathers, replays, blends, carries,
        # finalizes) and a replay alone
        profiles = {path: device_profile(torch, run, iters=1, tags={"block_ms": tag},
                                         expect={"block_ms": 8 * per_run[path]})
                    for path, run in paths.items()}
        origins = [(y, x) for y in sw._window_origins(h, SCENE_WINDOW, stride)
                   for x in xs][:SCENE_BATCH]
        windows_dev = torch.from_numpy(np.stack(
            [scene[y:y + SCENE_WINDOW, x:x + SCENE_WINDOW] for y, x in origins])).cuda()
        profiles["replay"] = device_profile(torch, lambda: dev_step.run(windows_dev),
                                            tags={"block_ms": tag}, expect={"block_ms": 8})
        del windows_dev
        for path, p in row["paths"].items():
            mean = float(np.mean(p["seconds"]))
            prof, n = profiles[path], per_run[path]
            p.update(mean_seconds=mean, mpix_per_s=h * w / 1e6 / mean,
                     batch_ms=mean * 1e3 / n,
                     device_busy_ms_per_batch=prof["device_busy_ms"] / n,
                     device_active_ms_per_batch=prof["device_active_ms"] / n,
                     device_launches_per_batch=prof["device_launches"] / n,
                     block_launches_per_batch=prof["block_ms_launches"] / n,
                     device_idle_share=1 - prof["device_active_ms"] / (mean * 1e3),
                     profiler_sessions_full=prof["sessions_full"],
                     profiler_sessions_over=prof["sessions_over"],
                     profile_top_ms=prof["top_ms"][:6])
        row["replay_profile"] = {k: profiles["replay"][k] for k in (
            "device_busy_ms", "device_launches", "block_ms", "block_ms_launches",
            "sessions_full", "sessions_over", "top_ms")}
        # 4 windows padded to SCENE_BATCH: the graph the scene path replays,
        # against the plain fp32 restore on the CPU
        small_got = sw.restore_scene(None, None, small, step=dev_step, device_assembly=True,
                                     **kw)
        row["small_scene"] = {"shape": list(SCENE_SMALL), "batch_size": SCENE_BATCH,
                              "rel_rms_vs_cpu_fp32": rel_rms(small_got, small_want),
                              "max_abs_vs_cpu_fp32": float(np.abs(small_got - small_want).max()),
                              "bound_rel_rms": small_bound}
        # the tiles K1 or K4 took in the B=SCENE_BATCH forward
        row["block_tiles"] = {f"C{c}": list(tiling(c, s, s, SCENE_BATCH, sms))
                              for c, s in SHAPES}
        captured = {k: steps[k].captured_launches for k in ("host", "device")}
        replays = host_step.replays + dev_step.replays
        counted, wrong = launched(counter), launched(other)
        # the count moved at each graph's warmup and capture; a replay runs
        # the captured launches
        device = counted - sum(captured.values()) + replays * captured["device"]
        launches[name] = device
        row.update(captured_launches=captured, replays=replays, device_launches=device,
                   other_kernel_launches=wrong)
        row["host_vs_device_max_abs"] = float(np.abs(outs["host"] - outs["device"]).max())
        row["streaming_vs_device_max_abs"] = float(
            np.abs(outs["streaming"] - outs["device"]).max())
        row["streaming_vs_device_max_rel"] = max_rel(outs["streaming"], outs["device"])
        checks = {
            "finite_shape": all(o.shape == SCENE_SHAPE and np.isfinite(o).all()
                                for o in outs.values()),
            "host_vs_device": bool(np.allclose(outs["host"], outs["device"],
                                               rtol=SCENE_DEVICE_VS_HOST,
                                               atol=SCENE_DEVICE_VS_HOST)),
            "streaming_vs_device": bool(np.allclose(outs["streaming"], outs["device"],
                                                    rtol=SCENE_STREAM_RTOL,
                                                    atol=SCENE_STREAM_RTOL)),
            "captured_8": captured == {"host": 8, "device": 8},
            "one_replay_per_batch": all(p["replays_per_run"] == per_run[path]
                                        and p["replays_per_run_steady"] == per_run[path]
                                        for path, p in row["paths"].items()),
            "profiler_8_per_replay": profile_complete(profiles["replay"], "block_ms", 8),
            "profiler_8_per_batch": all(profile_complete(profiles[path], "block_ms",
                                                         8 * per_run[path])
                                        for path in paths),
            "small_scene_vs_cpu": bool(np.isfinite(small_got).all()
                                       and small_got.shape == SCENE_SMALL
                                       and row["small_scene"]["rel_rms_vs_cpu_fp32"]
                                       <= small_bound),
            "no_other_kernel": wrong == 0,
            "repeatable": all(p["repeat_equal"] for p in row["paths"].values()),
        }
        row["checks"] = checks
        for check, ok in checks.items():
            if not ok:
                failures.append(f"scene {name}: {check} failed ({captured}, replays {replays}, "
                                f"host-device {row['host_vs_device_max_abs']}, stream-device "
                                f"{row['streaming_vs_device_max_abs']}, small vs CPU "
                                f"{row['small_scene']['rel_rms_vs_cpu_fp32']})")
        if name == "fp32":
            row["device_vs_bf16_rel_rms"] = rel_rms(outs["device"], result["bf16"]["device_out"])
        row["device_out"] = outs["device"]
        result[name] = row
        del host_step, steps, paths
        if name == "bf16":
            dev_step_bf16 = dev_step
        del dev_step
        torch.cuda.empty_cache()
    for name in ("bf16", "fp32"):
        result[name].pop("device_out")
    result["launches"] = launches
    result["cli"] = scene_cli(torch, cfg, weights, dev_step_bf16, failures)
    del dev_step_bf16
    torch.cuda.empty_cache()
    side = WHOLE_SCENE_SIDE
    result["whole_scene_device_gb"] = {
        "side": side, "scene_uint16": side * side * 13 * 2 / 1e9,
        "out_sum_fp32": side * side * 13 * 4 / 1e9, "w_sum_fp32": side * side * 4 / 1e9,
        "total": side * side * (13 * 2 + 13 * 4 + 4) / 1e9,
        "source": "shapes, not measured"}
    emit(result)
    return result


def phase_data_cache(torch, failures: list, card: str) -> dict:
    """1024 uint16 EuroSAT-shaped tiles written as TIFFs: the device cache
    narrows them to uint16 and gives the host loader's batches bit for bit;
    then the flagship's train step fed by the cache and by the host loader,
    one epoch each, in turns."""
    from msid_tpu_torch.data.pipeline import BatchLoader, DeviceCachedLoader, get_dataloaders
    from msid_tpu_torch.data.tiff import write_tiff
    from msid_tpu_torch.training.eval import split_batch_item
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    cfg = load_flagship()
    result = {"check": "data_cache", "config": str(CONFIG.relative_to(ROOT)), "card": card,
              "tiles": CACHE_TILES}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as tmp:
        root = Path(tmp) / "EuroSAT_MS"
        rng = np.random.default_rng(6)
        t0 = time.perf_counter()
        for i in range(CACHE_TILES):
            d = root / ("AnnualCrop", "Forest", "River", "SeaLake")[i % 4]
            d.mkdir(parents=True, exist_ok=True)
            write_tiff(d / f"{d.name}_{i}.tif",
                       rng.integers(0, 10000, (64, 64, 13), dtype=np.uint16))
        result["write_seconds"] = time.perf_counter() - t0
        config = dict(cfg, data=dict(cfg["data"], root_dir=str(root), device_cache=True))
        host_config = dict(config, data=dict(config["data"], device_cache=False))
        t0 = time.perf_counter()
        cached = get_dataloaders(config)
        result["cache_build_seconds"] = time.perf_counter() - t0
        host = get_dataloaders(host_config)
        nbytes = sum(getattr(loader, "nbytes", 0) for loader in cached)
        equal = []
        for c_loader, h_loader in zip(cached, host):
            for c_item, h_item in zip(list(c_loader), list(h_loader)):
                (cb, cn), (hb, hn) = split_batch_item(c_item), split_batch_item(h_item)
                equal.append(cn == hn and bool(np.array_equal(
                    cb.float().cpu().numpy(), np.asarray(hb, np.float32))))
        result.update(
            nbytes=nbytes, expected_nbytes=CACHE_TILES * 64 * 64 * 13 * 2,
            storage_dtypes=[str(getattr(loader, "_tiles", None).dtype) for loader in cached
                            if isinstance(loader, DeviceCachedLoader)],
            batches_compared=len(equal), train_batches=len(cached[0]),
            val_batches=len(cached[1]))
        checks = {
            "cached": all(isinstance(loader, DeviceCachedLoader) for loader in cached)
            and not any(isinstance(loader, DeviceCachedLoader) for loader in host)
            and all(isinstance(loader, BatchLoader) for loader in host),
            "uint16": result["storage_dtypes"] == ["torch.uint16"] * 2
            and nbytes == result["expected_nbytes"],
            "batches_equal": bool(equal) and all(equal)
            and len(equal) == len(cached[0]) + len(cached[1]),
        }
        del cached, host

        run_dir = Path(tmp) / "run"
        session = setup_training_session(config, output_dir=run_dir, epochs=1, seed=0)
        trainer = session["trainer"]
        loaders = {"cache": session["train_loader"],
                   "host": get_dataloaders(host_config)[0]}
        result["step_loader_types"] = {k: type(v).__name__ for k, v in loaders.items()}
        step = trainer.train_step
        stamps: list = []

        def timed_step(state, batch, seed):
            out = step(state, batch, seed)          # ends in a host sync (the finite check)
            stamps.append(time.perf_counter())
            return out

        trainer.train_step = timed_step
        trainer.train_epoch(loaders["cache"], 0)          # warmup
        times: dict = {"cache": [], "host": []}
        noise_launches = 0
        for epoch, turn in enumerate(CACHE_TURNS, start=1):
            stamps.clear()
            torch.cuda.reset_peak_memory_stats()
            clear_launches()
            trainer.train_epoch(loaders[turn], epoch)
            if turn == "cache":
                noise_launches += launched("noise")
            times[turn] += list(np.diff(stamps) * 1e3)   # step to step, data included
            result[f"{turn}_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        trainer.train_step = step
        steps_per_epoch = len(loaders["cache"])
        for turn, t in times.items():
            p50 = float(np.percentile(t, 50))
            result[f"step_p50_ms_{turn}"] = p50
            result[f"step_p90_ms_{turn}"] = float(np.percentile(t, 90))
            result[f"tiles_per_s_{turn}"] = 64 * 1e3 / p50
        result.update(steps_per_epoch=steps_per_epoch, nan_skips=trainer.state.nan_skips,
                      train_cache_noise_launches=noise_launches)
        checks["noise_per_cached_step"] = (
            noise_launches == CACHE_TURNS.count("cache") * steps_per_epoch)
        checks["no_skipped_step"] = trainer.state.nan_skips == 0
        session["checkpoint_manager"].close()
        del session, trainer, loaders
        torch.cuda.empty_cache()
    result["checks"] = checks
    result["launches"] = {"noise": noise_launches}
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"data_cache: {name} failed")
    return result


def count_block_nodes(torch, path: Path) -> int:
    """``msid::fused_residual_block`` nodes in an artifact's exported graph."""
    from msid_tpu_torch.deployment.export import MODULE_FILE

    program = torch.export.load(path / MODULE_FILE)
    op = torch.ops.msid.fused_residual_block.default
    return sum(n.target is op for n in program.graph.nodes)


def artifact_turns(torch, artifact, live, x, tag: str, iters: int) -> dict:
    """An artifact session against the live session on the same weights: in
    turns (live, artifact, artifact, live) the device p50 of a replay
    (``benchmark``); then the tensor maps K1's libraries encode over
    ``iters`` artifact replays and a profiler breakdown of one artifact
    replay (the live session's is the serve phases')."""
    clock = Stopwatch()
    turns: dict = {"live": [], "artifact": []}
    with clock("turns"):
        for form in ("live", "artifact", "artifact", "live"):
            session = artifact if form == "artifact" else live
            turns[form].append(session.benchmark(warmup_runs=3,
                                                 benchmark_iterations=iters)["p50_ms"])
    xd = torch.from_numpy(x).cuda()
    encodes = resblock_encodes()
    for _ in range(iters):
        artifact.forward(xd)
    torch.cuda.synchronize()
    with clock("profile"):
        prof = device_profile(torch, lambda: artifact.forward(xd), tags={"block": tag},
                              expect={"block": artifact.captured_launches})
    live_ms, artifact_ms = (float(np.mean(turns[k])) for k in ("live", "artifact"))
    return {"turns_device_p50_ms": turns, "live_device_p50_ms": live_ms,
            "device_p50_ms": artifact_ms, "artifact_over_live": artifact_ms / live_ms,
            "captured_launches": artifact.captured_launches,
            "encodes_per_replay": (resblock_encodes() - encodes) / iters,
            "device_launches_per_replay": prof["device_launches"],
            "block_kernels_per_replay": prof["block_launches"], "block_ms": prof["block"],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": 1 - prof["device_busy_ms"] / artifact_ms,
            "profiler_sessions_full": prof["sessions_full"],
            "profiler_sessions_over": prof["sessions_over"], "seconds": clock.seconds}


def artifact_new_batch(torch, artifact, model, b: int, size: int, bands: int) -> dict:
    """A B=1 artifact session serving a batch of ``b``: the first call
    captures a second graph (``artifact.graphs[b]``), later calls replay it
    with no tensor-map encode, and its output is held against a live
    session of batch ``b`` on the same weights. K1's device launches: the
    new graph's warmup (the capture only records) and its replays."""
    from msid_tpu_torch.deployment.inference import InferenceSession

    x = noisy_tiles(b, size, bands, seed=500)
    counted = launched("resblock")
    first = artifact.predict(x)                          # captures the graph at b
    counted = launched("resblock") - counted
    encodes = resblock_encodes()
    again = [artifact.predict(x) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    encodes = resblock_encodes() - encodes
    graph = artifact.graphs.get(b)
    live = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands)
    row = {"batch": b, "graphs": sorted(artifact.graphs),
           "captured_launches": artifact.captured_launches,
           "new_graph_launches": None if graph is None else graph.launches,
           "new_graph_replays": None if graph is None else graph.replays,
           "encodes_per_replay": encodes / REQUESTS,
           "replays_equal": all(np.array_equal(first, y) for y in again),
           "rel_rms_vs_live": rel_rms(first, live.predict(x)),
           "finite": bool(np.isfinite(first).all()),
           "k1_device_launches": 0 if graph is None else
           counted - graph.launches + graph.replays * graph.launches}
    del live
    return row


def phase_export(torch, failures: list, card: str) -> dict:
    """The flagship exported on the card in bf16 and fp32 and served from
    the artifacts (``InferenceSession(artifact_path=...)``) beside the live
    sessions: layout, custom-op nodes, verification, agreement, launches
    and device times; the bf16 B=1 artifact serving a batch of 3 (a graph
    captured for it); an int8 artifact, a ``tta=8`` one, the ``unet_light``
    fastpath, and the export CLI in a child process. ``seconds`` holds the
    host seconds of each sub-step."""
    from msid_tpu_torch.deployment.export import (
        MODULE_FILE,
        PARAMS_FILE,
        QPARAMS_FILE,
        compare_live_vs_exported,
        export_program,
        verify_exported_model,
    )
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.deployment.quantize import quantization_report
    from msid_tpu_torch.models.restoration import SatMAERestoration

    clock = Stopwatch()
    cfg = load_flagship()
    with clock("cpu_reference"):
        cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
        randomize_(torch, cpu_model, seed=0)
        size, bands = cpu_model.image_size, cpu_model.in_channels
        shape = (1, size, size, bands)
        x0 = noisy_tiles(1, size, bands, seed=100)
        torch.set_num_threads(8)
        with torch.no_grad():
            ref = cpu_model(torch.from_numpy(x0)).numpy()
    params = list(cpu_model.parameters())
    result = {"check": "export", "config": str(CONFIG.relative_to(ROOT)), "card": card,
              "parameters": sum(p.numel() for p in params),
              "parameters_2d": sum(p.numel() for p in params if p.dim() >= 2)}
    launches = {"export": 0, "export_fp32": 0, "export_new_batch": 0}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
    models = {}
    for name, dtype, counter, tag in (
            ("bfloat16", torch.bfloat16, "resblock", "resblock_kernel"),
            ("float32", torch.float32, "resblock_fp32", "resblock_fp32_kernel")):
        model = SatMAERestoration.from_config(cfg, dtype=dtype).eval()
        model.load_state_dict(cpu_model.state_dict())
        models[name] = model
        with clock(f"{name}_export"):
            t0 = time.perf_counter()
            path = export_program(model, Path(tmp.name) / name, input_shape=shape)
        row = {"export_seconds": time.perf_counter() - t0,
               "module_bytes": (path / MODULE_FILE).stat().st_size,
               "payload_bytes": (path / PARAMS_FILE).stat().st_size,
               "block_nodes": count_block_nodes(torch, path)}
        with clock(f"{name}_verify_b1_b3"):
            row["verify_b1_b3"] = verify_exported_model(path, shape, (1, 3))
        if not (row["module_bytes"] < max(2e6, row["payload_bytes"] / 2)
                and row["block_nodes"] == 8 and row["verify_b1_b3"]):
            failures.append(f"export {name}: {row}")
        if dtype == torch.float32:
            with clock("float32_live_vs_exported"):
                cmp = compare_live_vs_exported(model, None, path, shape)
            row["live_vs_exported"] = dataclasses.asdict(cmp)
            if not cmp.allclose:
                failures.append(f"export float32: live vs exported {cmp}")
        for b in BATCHES:
            clear_launches()
            with clock(f"{name}_b{b}_artifact_session"):
                artifact = InferenceSession(artifact_path=path, batch_size=b, image_size=size,
                                            num_bands=bands)
            requests = [x0] if b == 1 else [noisy_tiles(b, size, bands, seed=400 + i)
                                             for i in range(REQUESTS)]
            outs = [artifact.predict(r) for r in requests]
            counted = launched(counter)
            with clock(f"{name}_b{b}_live_session"):
                live = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands)
                want = [live.predict(r) for r in requests]
            with clock(f"{name}_b{b}_turns"):
                b_row = artifact_turns(torch, artifact, live, requests[0], tag, 20)
            b_row["rel_rms_vs_live"] = max(rel_rms(o, w) for o, w in zip(outs, want))
            b_row["finite"] = all(np.isfinite(o).all() for o in outs)
            if b == 1:
                b_row["rel_rms_vs_cpu_fp32"] = rel_rms(outs[0], ref)
            launches["export" if dtype == torch.bfloat16 else "export_fp32"] += (
                counted + (artifact.graphs[b].replays - 1) * artifact.captured_launches)
            bound = (ARTIFACT_VS_LIVE_BF16 if dtype == torch.bfloat16
                     else FP32_FORWARD_REL_RMS)
            cpu_bound = MAX_REL_RMS if dtype == torch.bfloat16 else FP32_FORWARD_REL_RMS
            if not (artifact.compiled == "cuda_graph" and artifact.captured_launches == 8
                    and b_row["block_kernels_per_replay"] == 8
                    and not b_row["profiler_sessions_over"]
                    and b_row["encodes_per_replay"] == 0 and b_row["finite"]
                    and b_row["rel_rms_vs_live"] <= bound
                    and b_row.get("rel_rms_vs_cpu_fp32", 0.0) <= cpu_bound):
                failures.append(f"export {name} B={b}: {b_row}")
            row[f"b{b}"] = b_row
            if dtype == torch.bfloat16 and b == 1:
                # the B=1 artifact serves a batch of 3 from a graph of its own
                with clock("bfloat16_b1_serves_b3"):
                    new = row["b1_serves_b3"] = artifact_new_batch(
                        torch, artifact, model, 3, size, bands)
                launches["export_new_batch"] += new["k1_device_launches"]
                if not (new["graphs"] == [1, 3] and new["captured_launches"] == 8
                        and new["new_graph_launches"] == 8 and new["encodes_per_replay"] == 0
                        and new["replays_equal"] and new["finite"]
                        and new["rel_rms_vs_live"] <= ARTIFACT_VS_LIVE_BF16):
                    failures.append(f"export bf16 B=1 artifact at B=3: {new}")
            del artifact, live
            torch.cuda.empty_cache()
        result[name] = row

    # int8 weights (bf16 compute), and a tta=8 artifact against the live tta=8 session
    model = models["bfloat16"]
    t0 = time.perf_counter()
    with clock("int8_export"):
        path = export_program(model, Path(tmp.name) / "int8", input_shape=shape,
                              int8_weights=True)
    with clock("int8_report"):
        state = {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}
        report = quantization_report(state, model, torch.from_numpy(x0).cuda())
    with clock("int8_live_vs_exported"):
        cmp = compare_live_vs_exported(model, None, path, shape, rtol=0.1, atol=0.05)
    result["int8"] = dict(report, export_seconds=time.perf_counter() - t0,
                          payload_bytes=(path / QPARAMS_FILE).stat().st_size,
                          payload_ratio=result["bfloat16"]["payload_bytes"]
                          / (path / QPARAMS_FILE).stat().st_size,
                          live_vs_exported=dataclasses.asdict(cmp))
    if not cmp.cosine_similarity > INT8_COSINE:
        failures.append(f"export int8: {result['int8']}")
    with clock("tta8_export"):
        path = export_program(model, Path(tmp.name) / "tta8", input_shape=shape, tta=8)
    with clock("tta8_artifact_session"):
        artifact = InferenceSession(artifact_path=path, batch_size=1, image_size=size,
                                    num_bands=bands)
    with clock("tta8_live_session"):
        live = InferenceSession(model, batch_size=1, image_size=size, num_bands=bands, tta=8)
    with clock("tta8_turns"):
        result["tta8_b1"] = tta = artifact_turns(torch, artifact, live, x0, "resblock_kernel",
                                                 10)
        tta["rel_rms_vs_live"] = rel_rms(artifact.predict(x0), live.predict(x0))
    if not (artifact.captured_launches == 64 and tta["block_kernels_per_replay"] == 64
            and tta["rel_rms_vs_live"] <= ARTIFACT_VS_LIVE_BF16):
        failures.append(f"export tta=8: {tta}")
    del artifact, live, models, model
    torch.cuda.empty_cache()

    # the unet_light fastpath (optimize=True) at B=16, against the live fastpath session
    with clock("light_model"):
        light = SatMAERestoration().eval()
        randomize_(torch, light, seed=2)
        light = light.set_compute_dtype(torch.bfloat16).cuda()
    with clock("light_export"):
        path = export_program(light, Path(tmp.name) / "light", input_shape=shape,
                              optimize=True)
    with clock("light_sessions"):
        artifact = InferenceSession(artifact_path=path, batch_size=16, image_size=size,
                                    num_bands=bands)
        live = InferenceSession(light, batch_size=16, image_size=size, num_bands=bands,
                                optimize=True)
    with clock("light_turns"):
        x16 = noisy_tiles(16, size, bands, seed=300)
        result["unet_light_fastpath_b16"] = fast = artifact_turns(
            torch, artifact, live, x16, "resblock_kernel", 10)
        fast["rel_rms_vs_live"] = rel_rms(artifact.predict(x16), live.predict(x16))
        fast["block_nodes"] = count_block_nodes(torch, path)
    if not (artifact.captured_launches == 0 and fast["block_nodes"] == 0
            and fast["rel_rms_vs_live"] <= ARTIFACT_VS_LIVE_BF16):
        failures.append(f"export unet_light fastpath: {fast}")
    del artifact, live, light
    torch.cuda.empty_cache()

    # the export CLI, as a user runs it: seeded flagship weights, int8, verified
    with clock("cli"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "msid_tpu_torch.scripts.export", "--model-config",
             str(CONFIG), "--output", str(Path(tmp.name) / "cli"), "--verify", "--int8"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
    result["cli"] = {"seconds": time.perf_counter() - t0, "rc": proc.returncode,
                     "log_tail": proc.stderr.strip().splitlines()[-12:]}
    if proc.returncode != 0:
        failures.append(f"export CLI: rc {proc.returncode}: {proc.stderr[-2000:]}")
    tmp.cleanup()
    result["launches"] = launches
    result["seconds"] = clock.seconds
    emit(result)
    return result


def phase_decoders(torch, failures: list, card: str) -> dict:
    """The flagship's configuration with the ``unet`` and then the
    ``attention`` decoder, full width, seeded random weights: served in
    bf16 at B=16 against the fp32 CPU forward, and in fp32 at B=1 against
    it, through ``InferenceSession``, which serves the module's forward
    (no folded graph, cuDNN convs, no fused-block kernel); device p50,
    busy time and the block kernels the profiler sees per replay."""
    import copy

    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration

    cfg = load_flagship()
    result = {"check": "decoders", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    torch.set_num_threads(8)
    for arch in ("unet", "attention"):
        t0 = time.perf_counter()
        arch_cfg = copy.deepcopy(cfg)
        arch_cfg["model"]["decoder"]["architecture"] = arch
        cpu_model = SatMAERestoration.from_config(arch_cfg, device="cpu").eval()
        randomize_(torch, cpu_model, seed=6)
        size, bands = cpu_model.image_size, cpu_model.in_channels
        x16 = noisy_tiles(16, size, bands, seed=600)
        with torch.no_grad():
            ref16 = cpu_model(torch.from_numpy(x16)).numpy()
            ref1 = cpu_model(torch.from_numpy(x16[:1])).numpy()
        row = {"parameters": sum(p.numel() for p in cpu_model.parameters())}
        for dtype, b, ref, bound in ((torch.bfloat16, 16, ref16, MAX_REL_RMS),
                                     (torch.float32, 1, ref1, FP32_FORWARD_REL_RMS)):
            model = SatMAERestoration.from_config(arch_cfg, dtype=dtype).eval()
            model.load_state_dict(cpu_model.state_dict())
            before = (launched("resblock"), launched("resblock_fp32"))
            session = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands)
            out = session.predict(x16[:b])
            bench = session.benchmark(warmup_runs=3, benchmark_iterations=20)
            xd = torch.from_numpy(x16[:b]).cuda()
            prof = device_profile(torch, lambda: session.forward(xd),
                                  tags={"k1": "resblock_kernel", "k4": "resblock_fp32_kernel"})
            try:
                InferenceSession(model, batch_size=b, image_size=size, num_bands=bands,
                                 optimize=True)
                refused = False
            except ValueError:
                refused = True
            d_row = {"batch": b, "optimized": session.optimized,
                     "captured_launches": session.captured_launches,
                     "block_launches_counted": [launched("resblock") - before[0],
                                                launched("resblock_fp32") - before[1]],
                     "rel_rms_vs_cpu_fp32": rel_rms(out, ref),
                     "finite": bool(np.isfinite(out).all()),
                     "device_p50_ms": bench["p50_ms"], "tiles_per_s": bench["images_per_sec"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "device_idle_share": 1 - prof["device_busy_ms"] / bench["p50_ms"],
                     "device_launches": prof["device_launches"],
                     "k1_per_replay": prof["k1_launches"], "k4_per_replay": prof["k4_launches"],
                     "top_ms": prof["top_ms"][:5], "optimize_true_refused": refused}
            row[str(dtype).removeprefix("torch.")] = d_row
            if not (d_row["optimized"] is False and d_row["captured_launches"] == 0
                    and d_row["block_launches_counted"] == [0, 0]
                    and d_row["k1_per_replay"] == 0 and d_row["k4_per_replay"] == 0
                    and d_row["finite"] and d_row["rel_rms_vs_cpu_fp32"] <= bound
                    and refused):
                failures.append(f"decoders {arch} {dtype} B={b}: {d_row}")
            del session, model
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        result[arch] = row
    emit(result)
    return result


def phase_perceptual(torch, failures: list, card: str) -> dict:
    """The VGG16 perceptual loss from a weights file: the flagship's bf16
    train step at B=64 with and without it, in turns, and the VGG term on
    the card against the CPU."""
    from msid_tpu_torch.models.restoration import SatMAERestoration, exact_fp32
    from msid_tpu_torch.ops.noise import NoiseConfig
    from msid_tpu_torch.training.losses import LossConfig
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.perceptual import (
        init_vgg16_params,
        resolve_perceptual,
        vgg_perceptual_per_sample,
    )
    from msid_tpu_torch.training.train_state import TrainState, make_train_step

    cfg = load_flagship()
    result = {"check": "perceptual", "config": str(CONFIG.relative_to(ROOT)), "card": card,
              "perceptual_weight": VGG_WEIGHT}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vgg_") as tmp:
        weights = Path(tmp) / "vgg16.npz"
        np.savez(weights, **{k: v.numpy() for k, v in init_vgg16_params(0).items()})
        impl, vgg = resolve_perceptual({"perceptual_impl": "vgg",
                                        "perceptual_weights_path": str(weights)}, "cuda")
    result["impl"] = impl
    model = SatMAERestoration.from_config(cfg, device="cpu")
    randomize_(torch, model, seed=1)
    model.cuda()
    optimizer, _ = build_optimizer_from_config(cfg, model)
    state = TrainState.create(model, optimizer)
    loss_cfg = dataclasses.replace(LossConfig.from_config(cfg), perceptual_weight=VGG_WEIGHT)
    steps = {name: make_train_step(model, loss_cfg, NoiseConfig.from_config(cfg),
                                   image_size=model.image_size, compute_dtype=torch.bfloat16,
                                   vgg_params=params)
             for name, params in (("edge", None), ("vgg", vgg))}
    batch = train_batch(13, 64, seed=6)
    times: dict = {"edge": [], "vgg": []}
    metrics = {}
    for name in ("edge", "vgg", "vgg", "edge"):          # in turns, each after a warmup
        for i in range(TIMED_STEPS + 1):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            _, metrics[name] = steps[name](state, batch, 100 + i)
            end.record()
            torch.cuda.synchronize()
            if i:
                times[name].append(start.elapsed_time(end))
    for name, t in times.items():
        result[f"step_{name}_p50_ms"] = float(np.median(t))
        result[f"{name}_loss"] = float(metrics[name]["loss"])
    result["vgg_step_cost_ms"] = result["step_vgg_p50_ms"] - result["step_edge_p50_ms"]
    rng = np.random.default_rng(7)
    pred, target = (torch.from_numpy(rng.uniform(-2, 2, (2, 192, 192, 13)).astype(np.float32))
                    for _ in range(2))
    with exact_fp32(torch.float32):
        got = vgg_perceptual_per_sample(vgg, pred.cuda(), target.cuda()).cpu().numpy()
    want = vgg_perceptual_per_sample(init_vgg16_params(0), pred, target).numpy()
    result["vgg_vs_cpu_max_rel"] = float(np.max(np.abs(got - want) / np.abs(want)))
    ok = (impl == "vgg" and result["vgg_vs_cpu_max_rel"] <= VGG_CPU_RTOL
          and all(np.isfinite(result[f"{n}_loss"]) for n in times)
          and result["vgg_loss"] != result["edge_loss"] and state.nan_skips == 0)
    if not ok:
        failures.append(f"perceptual: {result}")
    del model, state, steps, vgg
    torch.cuda.empty_cache()
    emit(result)
    return result


def satmae_state(torch, rng, dim: int = 768, depth: int = 12, tokens: int = 197) -> dict:
    """A torch SatMAE ViT-Base state dict (3-band patch embed, fused qkv, a
    CLS token: 197 positions of a 224 px model) from a seeded generator."""
    def normal(std, *shape):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))

    state = {"patch_embed.proj.weight": normal(0.02, dim, 3, 16, 16),
             "patch_embed.proj.bias": normal(0.02, dim),
             "pos_embed": normal(0.02, 1, tokens, dim),
             "cls_token": normal(0.02, 1, 1, dim),
             "norm.weight": 1 + normal(0.02, dim), "norm.bias": normal(0.02, dim)}
    for i in range(depth):
        p = f"blocks.{i}."
        state.update({p + "norm1.weight": 1 + normal(0.02, dim),
                      p + "norm1.bias": normal(0.02, dim),
                      p + "norm2.weight": 1 + normal(0.02, dim),
                      p + "norm2.bias": normal(0.02, dim),
                      p + "attn.qkv.weight": normal(0.02, 3 * dim, dim),
                      p + "attn.qkv.bias": normal(0.02, 3 * dim),
                      p + "attn.proj.weight": normal(0.02, dim, dim),
                      p + "attn.proj.bias": normal(0.02, dim),
                      p + "mlp.fc1.weight": normal(0.02, 4 * dim, dim),
                      p + "mlp.fc1.bias": normal(0.02, 4 * dim),
                      p + "mlp.fc2.weight": normal(0.02, dim, 4 * dim),
                      p + "mlp.fc2.bias": normal(0.02, dim)})
    return state


def phase_pretrained(torch, failures: list, card: str) -> dict:
    """A synthetic ViT-Base SatMAE checkpoint (197 positions) through
    ``setup_training_session``'s ``pretrained_path``: the encoder on the
    card against the same checkpoint loaded on the CPU, fp32."""
    import copy

    from msid_tpu_torch.models.convert import adapt_pos_embed, load_pretrained_encoder
    from msid_tpu_torch.models.restoration import SatMAERestoration, exact_fp32
    from msid_tpu_torch.utils.setup_helpers import setup_training_session

    cfg = load_flagship()
    result = {"check": "pretrained", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_satmae_") as tmp:
        state = satmae_state(torch, np.random.default_rng(8))
        ckpt = Path(tmp) / "satmae_vitb.pth"
        torch.save({"model": state}, ckpt)
        result["checkpoint_bytes"] = ckpt.stat().st_size
        config = copy.deepcopy(cfg)
        config["model"]["encoder"]["pretrained_path"] = str(ckpt)
        t0 = time.perf_counter()
        session = setup_training_session(config, output_dir=Path(tmp) / "run", synthetic=True,
                                         epochs=1, seed=0)
        result["setup_seconds"] = time.perf_counter() - t0
        encoder = session["model"].encoder.eval()
        cpu_model = SatMAERestoration.from_config(cfg, device="cpu")
        load_pretrained_encoder(ckpt, cpu_model)
        session["checkpoint_manager"].close()
    pos = adapt_pos_embed(state["pos_embed"].numpy(), encoder.num_patches)
    size = cpu_model.image_size
    x = torch.from_numpy(np.random.default_rng(9).normal(
        0, 0.5, (2, cpu_model.in_channels, size, size)).astype(np.float32))
    with torch.no_grad():
        want = cpu_model.encoder.eval()(x).numpy()
        with exact_fp32(torch.float32):
            got = encoder(x.cuda().contiguous(memory_format=torch.channels_last)).cpu().numpy()
    result.update(
        pos_embed_equal=bool(np.array_equal(encoder.pos_embed.detach().cpu().numpy(), pos)),
        qkv_equal=bool(torch.equal(encoder.blocks[11].attn.value.weight.detach().cpu(),
                                   state["blocks.11.attn.qkv.weight"][1536:])),
        encoder_rel_rms_vs_cpu=rel_rms(got, want))
    if not (result["pos_embed_equal"] and result["qkv_equal"]
            and result["encoder_rel_rms_vs_cpu"] <= FP32_FORWARD_REL_RMS):
        failures.append(f"pretrained: {result}")
    del session, encoder
    torch.cuda.empty_cache()
    emit(result)
    return result


def parallel_k2_offset(torch, failures: list) -> dict:
    """(a) K2 on the back half of a batch with its sample offset, against
    K2 on the whole batch (bit-equal) and against its plain version."""
    from msid_tpu_torch.ops import cuda_noise
    from msid_tpu_torch.ops.noise import NoiseConfig

    cfg = NoiseConfig(enable_striping=True, stripe_prob=0.5)
    b, half = PARALLEL_NOISE_SHAPE[0], PARALLEL_NOISE_SHAPE[0] // 2
    out = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(7)
        x = (torch.rand(PARALLEL_NOISE_SHAPE, device="cuda", generator=g) * 5 - 2.5).to(dtype)
        whole, masks = cuda_noise.apply_sensor_noise_kernel(21, x, cfg, return_masks=True)
        rows, row_masks = cuda_noise.apply_sensor_noise_kernel(
            21, x[half:].contiguous(), cfg, return_masks=True, sample_offset=half)
        plain = cuda_noise.apply_sensor_noise_kernel_reference(21, x[half:], cfg,
                                                               sample_offset=half)
        torch.cuda.synchronize()
        diff = (rows.float() - plain.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            within = err <= NOISE_ATOL
        else:
            ulp = bf16_ulp(torch, torch.maximum(rows.float().abs(), plain.float().abs()))
            within = bool((diff <= ulp + NOISE_ATOL).all())
        row = {"bit_equal_to_whole": bool(torch.equal(rows, whole[half:])),
               "masks_equal": bool(torch.equal(row_masks, masks[half:])),
               "max_abs_err_vs_plain": err, "within_plain_bound": within,
               "gated_samples": int(row_masks[:, -1].sum())}
        out[dtype_name] = row
        if not (row["bit_equal_to_whole"] and row["masks_equal"] and within):
            failures.append(f"parallel (a) K2 offset {dtype_name}: {row}")
    return out


def parallel_dp_world_one(torch, failures: list, cfg: dict, weights: dict,
                          batches: list) -> dict:
    """(b) The flagship's Trainer with a data-parallel mesh over a one-rank
    NCCL group against the plain Trainer from the same weights, one step
    each in turns on each batch; K2's launches on the mesh's steps."""
    import torch.distributed as dist

    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops.noise import fold_in
    from msid_tpu_torch.parallel import make_mesh
    from msid_tpu_torch.parallel.dryrun import free_port
    from msid_tpu_torch.training.optim import build_optimizer_from_config
    from msid_tpu_torch.training.train_state import TrainState
    from msid_tpu_torch.training.trainer import Trainer

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        trainers = {}
        for form in ("plain", "dp"):
            model = SatMAERestoration.from_config(cfg, device="cpu")
            model.load_state_dict(weights)
            model.to("cuda")
            optimizer, schedule = build_optimizer_from_config(cfg, model)
            trainers[form] = Trainer(model, TrainState.create(model, optimizer), config=cfg,
                                     lr_schedule=schedule, device="cuda",
                                     mesh=make_mesh() if form == "dp" else None)
        launches = 0
        times: dict = {"plain": [], "dp": []}
        losses: dict = {"plain": [], "dp": []}
        turns = []
        base = fold_in(0, 0)
        for i, batch in enumerate(batches):
            for form in (("plain", "dp") if i % 2 == 0 else ("dp", "plain")):
                t = trainers[form]
                clear_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.state, metrics = t.train_step(t.state, batch, fold_in(base, i))
                loss = float(metrics["loss"])                     # ends in a host sync
                times[form].append((time.perf_counter() - t0) * 1e3)
                losses[form].append(loss)
                turns.append(form)
                if form == "dp":
                    launches += launched("noise")
        with torch.no_grad():
            gap = max(float((a - b).abs().max()) for a, b in zip(
                trainers["plain"].model.parameters(), trainers["dp"].model.parameters()))
            scale = max(float(p.abs().max()) for p in trainers["plain"].model.parameters())
        rel = [abs(a - b) / abs(a) for a, b in zip(losses["plain"], losses["dp"])]
        row = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "batch": int(batches[0].shape[0]), "steps": len(batches),
               "accum_steps": {f: trainers[f].accum_steps for f in trainers},
               "turns": turns, "losses": losses, "loss_rel_diff": rel,
               "step_ms": times,
               "step_p50_ms": {f: float(np.median(v)) for f, v in times.items()},
               "param_max_abs_gap": gap, "param_max_abs": scale,
               "nan_skips": {f: trainers[f].state.nan_skips for f in trainers},
               "k2_launches": launches}
        if not (max(rel) <= PARALLEL_DP_LOSS_RTOL and launches == len(batches)
                and all(v == 0 for v in row["nan_skips"].values())
                and all(np.isfinite(v).all() for v in losses.values())):
            failures.append(f"parallel (b) data parallel over one NCCL rank: {row}")
        return row
    finally:
        dist.destroy_process_group()


def parallel_two_ranks_one_card(torch, failures: list, weights_path: str,
                                batch_path: str) -> dict:
    """(c) Two gloo ranks sharing the card, 32 rows each of a B=64 batch,
    one train step against one process's step on the whole batch. In the
    same launch, a control: the same step with each rank's BatchNorm
    moments over its own 32 rows (``local_norms``) must fall outside the
    bounds, or they could not see the cross-replica reduction."""
    from msid_tpu_torch.parallel.dryrun import run_step, spawn

    spec = dict(task="step", config=str(CONFIG), weights=weights_path, batch=batch_path,
                dtype="bfloat16", seed=5)
    t0 = time.perf_counter()
    launched = spawn(2, {"c": spec, "control": dict(spec, local_norms=True)},
                     PARALLEL_TIMEOUT_S, device="cuda", backend="gloo", share_device=True)
    spawn_seconds = time.perf_counter() - t0
    ranks, controls = [r["c"] for r in launched], [r["control"] for r in launched]
    one = run_step(spec, torch.device("cuda"))
    torch.cuda.synchronize()

    def rel_diff(results):
        return {k: [abs(r["metrics"][k] - one["metrics"][k]) / abs(one["metrics"][k])
                    for r in results] for k in ("loss", "grad_norm")}

    def within(rel):
        return (max(rel["loss"]) <= PARALLEL_LOSS_RTOL
                and max(rel["grad_norm"]) <= PARALLEL_GNORM_RTOL)

    noisy_equal = bool(torch.equal(torch.cat([r["noisy"] for r in ranks]), one["noisy"]))
    rel, control_rel = rel_diff(ranks), rel_diff(controls)
    row = {"ranks": 2, "backend": "gloo", "devices": [r["device"] for r in ranks],
           "rows_per_rank": [int(r["noisy"].shape[0]) for r in ranks],
           "noisy_bit_equal": noisy_equal,
           "rank_metrics": [r["metrics"] for r in ranks], "one_process": one["metrics"],
           "rel_diff": rel, "bounds": {"loss": PARALLEL_LOSS_RTOL,
                                       "grad_norm": PARALLEL_GNORM_RTOL},
           "control_local_norms_rel_diff": control_rel,
           "control_outside_bounds": not within(control_rel),
           "k2_launches_by_rank": [r["noise_launches"] for r in ranks],
           "one_process_k2_launches": one["noise_launches"],
           "spawn_seconds": spawn_seconds}
    ok = (noisy_equal and within(rel) and row["control_outside_bounds"]
          and row["k2_launches_by_rank"] == [1, 1]
          and all(r["metrics"]["skipped"] == 0 for r in ranks))
    if not ok:
        failures.append(f"parallel (c) two ranks on one card: {row}")
    return row


def parallel_mesh_session(torch, failures: list, cfg: dict, weights: dict) -> dict:
    """(d) A bf16 session over a mesh of two replicas on the card against a
    B/2 session: each half bit-equal, 16 K1 launches a call."""
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.parallel import make_mesh

    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    model.load_state_dict(weights)
    size, bands, b = model.image_size, model.in_channels, PARALLEL_SERVE_BATCH
    requests = [noisy_tiles(b, size, bands, seed=300 + i) for i in range(REQUESTS)]
    clear_launches()
    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    session = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands, mesh=mesh)
    outs = [session.predict(r) for r in requests]
    torch.cuda.synchronize()
    counted = launched("resblock")
    launches = counted + sum((r.replays - 1) * r.captured_launches for r in session.replicas)
    single = InferenceSession(model, batch_size=b // 2, image_size=size, num_bands=bands)
    halves_equal = all(np.array_equal(out[:b // 2], single.predict(r[:b // 2])) and
                       np.array_equal(out[b // 2:], single.predict(r[b // 2:]))
                       for out, r in zip(outs, requests))
    xd = torch.from_numpy(requests[0]).to("cuda")
    prof = device_profile(torch, lambda: session.forward(xd),
                          tags={"block_ms": "resblock_kernel"}, expect={"block_ms": 16})
    row = {"replicas": len(session.replicas), "devices": [str(d) for d in mesh.devices],
           "batch": b, "dtype": "bfloat16", "compiled": session.compiled,
           "captured_launches": session.captured_launches, "halves_bit_equal": halves_equal,
           "k1_per_call_profiled": prof["block_ms_launches"],
           "profiler_sessions_full": prof["sessions_full"],
           "profiler_sessions_over": prof["sessions_over"],
           "device_busy_ms": prof["device_busy_ms"], "k1_device_launches": launches,
           "finite": all(np.isfinite(o).all() for o in outs)}
    if not (halves_equal and row["finite"] and session.compiled == "cuda_graph"
            and session.captured_launches == 16 and profile_complete(prof, "block_ms", 16)):
        failures.append(f"parallel (d) mesh session: {row}")
    # benchmark at the whole batch: every timed call replays both replicas
    bench = {}
    for pipelined in (False, True):
        before = [r.replays for r in session.replicas]
        out = session.benchmark(warmup_runs=3, benchmark_iterations=20, pipelined=pipelined)
        out["replays_by_replica"] = [r.replays - n for r, n in zip(session.replicas, before)]
        bench["pipelined" if pipelined else "per_call"] = out
    row["benchmark"] = bench
    row["k1_benchmark_device_launches"] = sum(
        8 * n for out in bench.values() for n in out["replays_by_replica"])
    if not all(set(out) >= BENCHMARK_KEYS and out["batch_size"] == b
               and out["replays_by_replica"] == [23, 23] and out["mean_ms"] > 0
               for out in bench.values()):
        failures.append(f"parallel (d) mesh benchmark: {bench}")
    del session, single
    torch.cuda.empty_cache()
    return row


def phase_parallel(torch, failures: list, card: str) -> dict:
    """The parallel layer on one card: (a) K2's sample offset, (b) the
    data-parallel Trainer over a one-rank NCCL group against the plain one,
    (c) two gloo ranks sharing the card against one process, (d) mesh
    serving with two replicas on the card. K2's launches on the mesh's
    train steps (b, and each rank's in c) are the ``train_dp`` path, K1's
    on the mesh session the ``serve_mesh`` path."""
    from msid_tpu_torch.models.restoration import SatMAERestoration

    cfg = load_flagship()
    result = {"check": "parallel", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    t0 = time.perf_counter()
    result["k2_offset"] = parallel_k2_offset(torch, failures)
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu")
    randomize_(torch, cpu_model, seed=4)
    weights = cpu_model.state_dict()
    batches = [train_batch(13, PARALLEL_TRAIN_BATCH, seed=20 + i) for i in range(3)]
    result["dp_world_one"] = parallel_dp_world_one(torch, failures, cfg, weights, batches)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        weights_path, batch_path = f"{tmp}/weights.pt", f"{tmp}/batch.npy"
        torch.save(weights, weights_path)
        np.save(batch_path, batches[0])
        result["two_ranks_one_card"] = parallel_two_ranks_one_card(
            torch, failures, weights_path, batch_path)
    torch.cuda.empty_cache()
    result["mesh_session"] = parallel_mesh_session(torch, failures, cfg, weights)
    result["launches"] = {
        "train_dp": (result["dp_world_one"]["k2_launches"]
                     + sum(result["two_ranks_one_card"]["k2_launches_by_rank"])),
        "serve_mesh": result["mesh_session"]["k1_device_launches"],
        "serve_mesh_benchmark": result["mesh_session"]["k1_benchmark_device_launches"]}
    result["seconds"] = time.perf_counter() - t0
    emit(result)
    return result


def phase_nccl_shared(torch, failures: list) -> dict:
    """Two NCCL ranks on one card: what NCCL says (it is expected to refuse
    them, which is why the two-rank check of the parallel phase is gloo)."""
    from msid_tpu_torch.parallel.dryrun import TINY_FLAGSHIP, spawn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        np.save(f"{tmp}/batch.npy", np.random.default_rng(0).uniform(
            0, 10000, (4, 64, 64, 13)).astype(np.float32))
        spec = dict(task="step", model=TINY_FLAGSHIP, batch=f"{tmp}/batch.npy")
        debug = os.environ.get("NCCL_DEBUG")
        os.environ["NCCL_DEBUG"] = "WARN"          # NCCL then says why it refuses
        try:
            spawn(2, {"nccl": spec}, 90, device="cuda", backend="nccl", share_device=True)
            row = {"refused": False, "message": None}
        except (RuntimeError, TimeoutError) as err:
            lines = str(err).splitlines()
            said = [ln for i, ln in enumerate(lines) if "NCCL WARN" in ln or "Duplicate" in ln
                    or "DistBackendError" in ln or (i and "Last error" in lines[i - 1])]
            row = {"refused": True, "error": type(err).__name__, "message": said[-8:]}
        finally:
            if debug is None:
                os.environ.pop("NCCL_DEBUG")
            else:
                os.environ["NCCL_DEBUG"] = debug
    row["check"] = "nccl_two_ranks_one_card"
    emit(row)
    return row


@contextlib.contextmanager
def sessions_built():
    """The ``InferenceSession``s built inside the block, in a list: their
    replays are device launches that ``_build.launched`` does not count."""
    from msid_tpu_torch.deployment.inference import InferenceSession

    built, init = [], InferenceSession.__init__

    def tracked(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    InferenceSession.__init__ = tracked
    try:
        yield built
    finally:
        InferenceSession.__init__ = init


def run_example(torch, name: str, argv: list) -> dict:
    """``msid_tpu_torch/examples/<name>`` run in this process as
    ``__main__`` with ``argv`` and the card as its device: its seconds and
    the device launches of each kernel over the run, the count cleared just
    before and read just after (the replays of a session it built added:
    bf16 ones to K1, fp32 to K4)."""
    import runpy

    path = EXAMPLES_DIR / name
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv = [str(path), *map(str, argv)]
    clear_launches()
    t0 = time.perf_counter()
    try:
        with sessions_built() as sessions:
            runpy.run_path(str(path), run_name="__main__")
        torch.cuda.synchronize()
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
    seconds = time.perf_counter() - t0
    launches = {kernel: launched(kernel) for kernel in ENTRIES}
    for session in sessions:
        if session.compiled:
            key = "resblock" if session.dtype == torch.bfloat16 else "resblock_fp32"
            launches[key] += (session.replays - 1) * session.captured_launches
    row = {"seconds": seconds, "launches": launches,
           "sessions": [{"compiled": s.compiled, "optimized": s.optimized,
                         "captured_launches": s.captured_launches, "replays": s.replays}
                        for s in sessions]}
    del sessions
    torch.cuda.empty_cache()
    return row


def is_png(path: Path) -> bool:
    return path.is_file() and path.read_bytes()[:8] == PNG_SIGNATURE


def phase_examples(torch, failures: list, card: str) -> dict:
    """The port's three walkthroughs (``msid_tpu_torch/examples``), each run
    in this process on the card at full width into a temporary directory:
    00 and 03 on the flagship (``long_skip_fill.yaml``), 02 on its two
    stage configurations (ViT-Base, ``unet_light``) for one epoch each, all
    on synthetic tiles. K1 must launch in all three (00's forward, 02's
    validation, 03's evaluation, export and session) and K2 in 02 and 03;
    K4 is recorded. Then each one's files: the PNGs, 02's history with one
    epoch a stage, 03's results with finite PSNR/SSIM/SAM, its artifact
    verified and held against the same seeded model, allclose."""
    from msid_tpu_torch.deployment import compare_live_vs_exported, verify_exported_model
    from msid_tpu_torch.training.trainer import compute_dtype_from_config
    from msid_tpu_torch.utils.setup_helpers import create_model_from_config, setup_config

    result = {"check": "examples", "config": str(CONFIG.relative_to(ROOT)), "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        tmp = Path(tmp)
        flagship = ["--config", str(CONFIG), "--synthetic"]
        runs = {"00_quick_start": ("00_quick_start.py", [*flagship, "--output-dir", tmp / "00"]),
                "02_two_stage_training": ("02_two_stage_training.py", [
                    "--synthetic", "--epochs", "1", "--output-dir", tmp / "02"]),
                "03_evaluation_and_export": ("03_evaluation_and_export.py", [
                    *flagship, "--output-dir", tmp / "03"])}
        for key, (name, argv) in runs.items():
            result[key] = run_example(torch, name, argv)
            print(f"example {name}: {result[key]['seconds']:.1f} s, launches "
                  f"{result[key]['launches']}", flush=True)

        history = json.loads((tmp / "02" / "logs" / "training_history.json").read_text())
        result["02_two_stage_training"]["history"] = history
        results = json.loads((tmp / "03" / "evaluation_results.json").read_text())
        result["03_evaluation_and_export"]["results"] = results
        figures = sorted(p.name for p in (tmp / "03" / "figures").iterdir())

        config = setup_config(CONFIG)
        size, bands = config["data"]["image_size"], config["data"]["num_bands"]
        shape = (1, size, size, bands)
        artifact = tmp / "03" / "model"
        verified = verify_exported_model(artifact, input_shape=shape, batch_sizes=(1, 3))
        model, _ = create_model_from_config(config)        # the example's seed, on the card
        model.set_compute_dtype(compute_dtype_from_config(config))
        comparison = compare_live_vs_exported(model, None, artifact, input_shape=shape)
        meta = json.loads((artifact / "meta.json").read_text())
        result["03_evaluation_and_export"]["artifact"] = {
            "verified": verified, "comparison": str(comparison), "meta": meta}
        del model
        torch.cuda.empty_cache()

        launches = {k: result[k]["launches"] for k in runs}
        checks = {
            "k1_launched": all(launches[k]["resblock"] > 0 for k in runs),
            "k2_launched": all(launches[k]["noise"] > 0
                               for k in ("02_two_stage_training", "03_evaluation_and_export")),
            "k1_once_a_block_in_00": launches["00_quick_start"]["resblock"] == 8,
            "only_k1_k2_k4": all(launches[k]["resblock_v2"] == launches[k]["any_dma"] == 0
                                 for k in runs),
            "quick_start_png": is_png(tmp / "00" / "noise_preview.png"),
            "history_one_epoch_a_stage": len(history["train_loss"]) == 2 and all(
                len(v) == 2 for v in history.values())
            and bool(np.isfinite(history["train_loss"] + history["val_psnr"]).all()),
            "curves_png": is_png(tmp / "02" / "logs" / "training_curves.png"),
            "results_finite": all(np.isfinite(results[k]) for k in ("psnr", "ssim", "sam")),
            "figures_png": figures == [f"sample_{i:02d}{s}.png" for i in range(3)
                                       for s in ("", "_spectra")]
            and all(is_png(tmp / "03" / "figures" / f) for f in figures),
            "artifact_verified": verified,
            "artifact_on_the_card_in_bf16": (meta["device_type"], meta["dtype"])
            == ("cuda", "bfloat16"),
            "live_vs_exported_allclose": comparison.allclose,
            "session_compiled": [s["compiled"] for s in
                                 result["03_evaluation_and_export"]["sessions"]] == ["cuda_graph"],
        }
    result["checks"] = checks
    result["launches"] = {kernel: sum(launches[k][kernel] for k in runs)
                          for kernel in ("resblock", "noise", "resblock_fp32", "batchnorm")}
    result["seconds"] = {k: result[k]["seconds"] for k in runs}
    emit(result)
    for name, ok in checks.items():
        if not ok:
            failures.append(f"examples: {name} failed")
    return result


def kernel_row(torch, lib, c: int, s: int, b: int, sms: int) -> dict:
    """K1 at [b, s, s, c] against its plain version, with its prepared
    operands and through the functional entry (HWIO), timed beside the
    plain version, the cuDNN composition and the bound."""
    from msid_tpu_torch.ops import cuda_decoder

    x, w1, w2, aff = random_block_inputs(torch, c, s, b, seed=c + b)
    p1, p2 = (cuda_decoder.prepare_bf16_weights(w) for w in (w1, w2))
    got = cuda_decoder.fused_residual_block(x, p1, p2, aff)
    functional = cuda_decoder.fused_residual_block(x, w1, w2, aff)
    want = cuda_decoder.fused_residual_block_reference(x, w1, w2, aff)
    torch.cuda.synchronize()
    k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bound_ms, bound_by, flops, nbytes = block_bound(c, s, b)
    th, tw, g, stages = cuda_decoder.bf16_tiling(c, s, s, b, sms)
    row = {"check": "widths_k1", "C": c, "padded": cuda_decoder.bf16_padded(c),
           "H": s, "W": s, "B": b, "tile": [th, tw], "cluster": g, "stages": stages,
           "body": cuda_decoder.BF16_VARIANTS[(cuda_decoder.bf16_padded(c), g)][3],
           "taps": cuda_decoder.BF16_VARIANTS[(cuda_decoder.bf16_padded(c), g)][4],
           "window": "tma" if c % 8 == 0 else "plain loads",
           "kernel_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block(
               x, p1, p2, aff), iters=10),
           "plain_ms": time_ms(torch, lambda: cuda_decoder.fused_residual_block_reference(
               x, w1, w2, aff), iters=5, warmup=1),
           "library_ms": time_ms(torch, lambda: lib(x, k1, k2, aff), iters=10),
           "library": "cuDNN bf16 conv2d composition (channels-last)",
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
           "max_abs_err": float((got.float() - want.float()).abs().max()),
           "ok": bool(within(torch, got, want) and torch.equal(got, functional))}
    row["share_of_bound"] = bound_ms / row["kernel_ms"]
    return row


def capacity_artifact(torch, failures: list, model, request: np.ndarray,
                      live: np.ndarray) -> dict:
    """The bf16 capacity_2x exported on the card (``export_program``, 8
    ``msid::fused_residual_block`` nodes) and served from the artifact by a
    captured session at B=1: 8 K1 launches captured, no K4, within
    ``ARTIFACT_VS_LIVE_BF16`` relative RMS of the live session's output on
    the same request."""
    from msid_tpu_torch.deployment.export import export_program
    from msid_tpu_torch.deployment.inference import InferenceSession

    with tempfile.TemporaryDirectory(prefix="chip_smoke_widths_export_") as tmp:
        t0 = time.perf_counter()
        path = export_program(model.eval(), Path(tmp) / "capacity_bf16",
                              input_shape=request.shape)
        row = {"export_seconds": time.perf_counter() - t0,
               "block_nodes": count_block_nodes(torch, path)}
        clear_launches()
        session = InferenceSession(artifact_path=path, batch_size=1,
                                   image_size=request.shape[1], num_bands=request.shape[-1])
        got = session.predict(request)
        row.update(compiled=session.compiled, captured_launches=session.captured_launches,
                   k1_device_launches=device_launches(launched("resblock"), session),
                   k4_launches=launched("resblock_fp32"),
                   rel_rms_vs_live=rel_rms(got, live))
        del session
    if not (row["block_nodes"] == 8 and row["compiled"] == "cuda_graph"
            and row["captured_launches"] == 8 and row["k4_launches"] == 0
            and row["rel_rms_vs_live"] <= ARTIFACT_VS_LIVE_BF16):
        failures.append(f"widths: capacity_2x artifact: {row}")
    return row


def capacity_serve(torch, failures: list, cfg: dict, cpu_model, weights: dict) -> dict:
    """capacity_2x served by captured sessions of the module's forward: bf16
    at B=1 and B=16 (K1), fp32 at B=1 (K4), each against the same weights
    in fp32 on the CPU, 8 block launches captured per forward and seen by
    the profiler per replay, device p50 of a replay; then the bf16 model
    exported and served from its artifact (``capacity_artifact``)."""
    from msid_tpu_torch.deployment.inference import InferenceSession
    from msid_tpu_torch.models.restoration import SatMAERestoration

    size, bands = cpu_model.image_size, cpu_model.in_channels
    requests = {b: noisy_tiles(b, size, bands, seed=700 + b) for b in WIDTHS_BATCHES}
    # the CPU's fp32 forward of the B=1 tile and of the first and last B=16 tiles
    picks = np.concatenate([requests[1], requests[16][[0, -1]]])
    torch.set_num_threads(8)
    with torch.no_grad():
        ref = cpu_model(torch.from_numpy(picks)).numpy()
    out: dict = {"launches": {"bf16": 0, "fp32": 0}}
    for name, dtype, batches, counter, other, tag, bound in (
            ("bf16", torch.bfloat16, WIDTHS_BATCHES, "resblock", "resblock_fp32",
             "resblock_kernel", MAX_REL_RMS),
            ("fp32", torch.float32, (1,), "resblock_fp32", "resblock",
             "resblock_fp32_kernel", FP32_FORWARD_REL_RMS)):
        model = SatMAERestoration.from_config(cfg, dtype=dtype)
        model.load_state_dict(weights)
        for b in batches:
            clear_launches()
            session = InferenceSession(model, batch_size=b, image_size=size, num_bands=bands,
                                       optimize=False)
            got = session.predict(requests[b])
            got = session.predict(requests[b])
            rel = ([rel_rms(got, ref[:1])] if b == 1
                   else [rel_rms(got[[0]], ref[1:2]), rel_rms(got[[-1]], ref[2:3])])
            xd = torch.from_numpy(requests[b]).cuda()
            prof = device_profile(torch, lambda: session.forward(xd), tags={"block_ms": tag},
                                  expect={"block_ms": 8})
            bench = session.benchmark(warmup_runs=3, benchmark_iterations=20)
            launches = device_launches(launched(counter), session)
            row = {"dtype": name, "B": b, "compiled": session.compiled,
                   "captured_launches": session.captured_launches,
                   "device_launches": launches,
                   "other_kernel_launches": launched(other),
                   "rel_rms_vs_cpu_fp32": rel, "device_p50_ms": bench["p50_ms"],
                   "tiles_per_s": b * 1e3 / bench["p50_ms"],
                   "device_busy_ms": prof["device_busy_ms"],
                   "device_idle_share": 1 - prof["device_busy_ms"] / bench["p50_ms"],
                   "block_kernels_per_replay": prof["block_ms_launches"],
                   "block_ms": prof["block_ms"], "top_ms": prof["top_ms"][:5]}
            out[f"{name}_b{b}"] = row
            out["launches"][name] += launches
            bad = [k for k, ok in (
                ("compiled", session.compiled == "cuda_graph"),
                ("captured", session.captured_launches == 8),
                ("profiled", profile_complete(prof, "block_ms", 8)),
                ("other kernel", launched(other) == 0),
                ("finite", bool(np.isfinite(got).all()) and got.shape == requests[b].shape),
                ("cpu", max(rel) <= bound)) if not ok]
            if bad:
                failures.append(f"widths: capacity_2x {name} B={b}: {bad}: {row}")
            del session
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16 and b == 1:
                out["bf16_artifact_b1"] = capacity_artifact(torch, failures, model,
                                                            requests[1], got)
                out["launches"]["bf16"] += out["bf16_artifact_b1"]["k1_device_launches"]
        del model
    return out


def capacity_train_evaluate(torch, failures: list) -> dict:
    """capacity_2x through the CLIs a user runs, at full width on
    ``CAPACITY_SAMPLES`` synthetic tiles: ``scripts.train`` for one epoch (a
    few bf16 steps of ``Trainer.fit``, K2 once a step and a validation
    batch, K1 8 times a validation batch) into a checkpoint, then
    ``scripts.evaluate`` of it in bf16 (K1 8 times a batch, no K4), whose
    metrics reproduce the trainer's last validation line."""
    from msid_tpu_torch.scripts import evaluate as evaluate_cli
    from msid_tpu_torch.scripts import train as train_cli

    metrics = ("loss", "psnr", "ssim", "sam", "rmse")
    row: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_widths_") as tmp:
        tmp = Path(tmp)
        config = tmp / "capacity_2x_short.yaml"
        config.write_text(f"inherits: {CAPACITY_CONFIG}\n"
                          f"data:\n  synthetic_samples: {CAPACITY_SAMPLES}\n")
        common = ["--config", str(config), "--synthetic", "--device", "cuda"]
        outs = {}
        for name, cli, argv in (
                ("train", train_cli, ["--epochs", "1", "--output-dir", str(tmp / "run")]),
                ("evaluate", evaluate_cli, ["--checkpoint", str(tmp / "run" / "checkpoints"),
                                            "--output-dir", str(tmp / "eval")])):
            clear_launches()
            t0 = time.perf_counter()
            outs[name] = cli.main([*common, *argv])
            torch.cuda.synchronize()
            row[name] = {"seconds": time.perf_counter() - t0,
                         "launches": {"noise": launched("noise"),
                                      "resblock": launched("resblock"),
                                      "resblock_fp32": launched("resblock_fp32")}}
    history, scores = outs["train"], outs["evaluate"]
    val_batches = row["evaluate"]["launches"]["noise"]
    last = {k: history[f"val_{k}"][-1] for k in metrics}
    row.update(val_batches=val_batches,
               steps=row["train"]["launches"]["noise"] - val_batches,
               trainer_last_val=last, history=history,
               evaluate={**row["evaluate"], **{k: scores[k] for k in metrics}},
               evaluate_vs_trainer={k: abs(scores[k] - last[k]) / abs(last[k])
                                    for k in metrics})
    ok = (val_batches >= 1 and row["steps"] >= 2
          and all(np.isfinite(v).all() for k, v in history.items() if k != "lr")
          and all(row[n]["launches"]["resblock"] == 8 * val_batches
                  and row[n]["launches"]["resblock_fp32"] == 0 for n in ("train", "evaluate"))
          and max(row["evaluate_vs_trainer"].values()) <= EVAL_RTOL)
    if not ok:
        failures.append(f"widths: capacity_2x train and evaluate: {row}")
    return row


def capacity_scene(torch, failures: list, cfg: dict, weights: dict) -> dict:
    """One device-assembly batch of 64 windows through capacity_2x in bf16:
    a 400 x 400 uint16 scene (8 x 8 windows of 64 at stride 48), its step
    captured with 8 K1 launches."""
    from msid_tpu_torch.deployment import sliding_window as sw
    from msid_tpu_torch.models.restoration import SatMAERestoration

    model = SatMAERestoration.from_config(cfg, dtype=torch.bfloat16)
    model.load_state_dict(weights)
    side = SCENE_WINDOW + 7 * (SCENE_WINDOW - SCENE_OVERLAP)
    scene = np.random.default_rng(9).integers(0, 10000, (side, side, model.in_channels),
                                              dtype=np.uint16)
    clear_launches()
    step = sw.make_device_scene_step(model, None, SCENE_WINDOW, model.image_size,
                                     SCENE_OVERLAP, optimize=False)
    del model
    kw = dict(window=SCENE_WINDOW, overlap=SCENE_OVERLAP, batch_size=SCENE_BATCH,
              step=step, device_assembly=True)
    t0 = time.perf_counter()
    out = sw.restore_scene(None, None, scene, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = sw.restore_scene(None, None, scene, **kw)
    row = {"scene": [side, side, int(scene.shape[2])], "windows": scene_windows(side, side),
           "batch_size": SCENE_BATCH, "replays": step.replays,
           "captured_launches": step.captured_launches,
           "k1_device_launches": launched("resblock")
           + (step.replays - 1) * (step.captured_launches or 0),
           "k4_launches": launched("resblock_fp32"),
           "first_seconds": first, "seconds": time.perf_counter() - t0,
           "repeat_equal": bool(np.array_equal(out, again))}
    row["mpix_per_s"] = side * side / 1e6 / row["seconds"]
    if not (row["windows"] == SCENE_BATCH and step.replays == 2
            and step.captured_launches == 8 and row["k4_launches"] == 0
            and out.shape == scene.shape and np.isfinite(out).all() and row["repeat_equal"]):
        failures.append(f"widths: capacity_2x scene: {row}")
    return row


def phase_widths(torch, F, failures: list, card: str) -> dict:
    """The block kernels at every decoder width of the repo's configs and
    off the builds' grid, then ``capacity_2x.yaml`` (decoder 768/384/192/96)
    at full width through its entry points: K1 against its plain version at
    the config widths, each at its config's resolution, and at widths
    between the builds (odd, no multiple of 8), B=1 and B=16; K4 at widths
    whose picked cluster is 3, 5, 6, 7 and 8 CTAs; capacity_2x served by
    captured sessions (bf16 B=1 and B=16, fp32 B=1) against fp32 on the
    CPU; ``scripts.train`` for a short bf16 ``Trainer.fit`` with one
    validation pass and ``scripts.evaluate`` of its checkpoint; one
    device-assembly scene batch of 64 windows."""
    from msid_tpu_torch.models.restoration import SatMAERestoration
    from msid_tpu_torch.ops import cuda_decoder
    from msid_tpu_torch.utils.config import load_config

    if cuda_decoder.BF16_BUILDS != tuple(sorted(RESBLOCK_BUILDS)):
        failures.append(f"widths: K1's builds {cuda_decoder.BF16_BUILDS} are not the "
                        f"ones built here {RESBLOCK_BUILDS}")
    t0 = time.perf_counter()
    lib = library_block(torch, F)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result: dict = {"check": "widths", "card": card, "k1": [], "k4": []}
    cases = [(c, s, b) for c, s in WIDTH_SHAPES + OFF_GRID_SHAPES for b in WIDTHS_BATCHES]
    cases += [(c, s, b) for c, s in WIDE_SHAPES for b in WIDE_BATCHES if (c, s, b) not in cases]
    for c, s, b in cases:
        row = kernel_row(torch, lib, c, s, b, sms)
        row["config_width"] = (c, s) in WIDTH_SHAPES
        emit(row)
        result["k1"].append(row)
        if not row["ok"]:
            failures.append(f"widths: K1 C={c} H={s} B={b}: max_abs_err "
                            f"{row['max_abs_err']}")
    result["wide"] = {f"C{r['C']}B{r['B']}": {k: r[k] for k in (
        "kernel_ms", "library_ms", "plain_ms", "bound_ms", "tile", "cluster", "stages", "body",
        "taps")}
        for r in result["k1"] if (r["C"], r["H"]) in WIDE_SHAPES}
    builds = {r["padded"] for r in result["k1"]}
    if builds != set(RESBLOCK_BUILDS):
        failures.append(f"widths: K1 rows ran builds {sorted(builds)}, not all of "
                        f"{sorted(RESBLOCK_BUILDS)}")
    result["k1_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for c, s in K4_WIDTH_SHAPES:
        for b in WIDTHS_BATCHES:
            row = fp32_kernel_row(torch, lib, c, s, b, sms, "widths_k4")
            emit(row)
            result["k4"].append(row)
            if not row["ok"]:
                failures.append(f"widths: K4 C={c} H={s} B={b}: max_abs_err "
                                f"{row['max_abs_err']}, rel RMS {row['rel_rms']}")
    clusters = {r["cluster"] for r in result["k4"]}
    if not {3, 5, 6, 7, 8} <= clusters:
        failures.append(f"widths: K4 ran clusters {sorted(clusters)}, not 3, 5, 6, 7 and 8")
    result["k4_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg = load_config(CAPACITY_CONFIG)
    cpu_model = SatMAERestoration.from_config(cfg, device="cpu").eval()
    randomize_(torch, cpu_model, seed=11)
    weights = cpu_model.state_dict()
    result["capacity_2x"] = {
        "config": str(CAPACITY_CONFIG.relative_to(ROOT)),
        "decoder_channels": list(cfg["model"]["decoder"]["channels"]),
        "serve": capacity_serve(torch, failures, cfg, cpu_model, weights)}
    result["capacity_2x"]["serve_seconds"] = time.perf_counter() - t0
    del cpu_model
    t0 = time.perf_counter()
    result["capacity_2x"]["fit"] = capacity_train_evaluate(torch, failures)
    result["capacity_2x"]["fit_phase_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["capacity_2x"]["scene"] = capacity_scene(torch, failures, cfg, weights)
    result["capacity_2x"]["scene_phase_seconds"] = time.perf_counter() - t0
    k1_768 = [r for r in result["k1"] if r["C"] == 768]
    result["k1_stage_768_b16"] = {
        k: 2 * sum(r[k] for r in k1_768 if r["B"] == 16)       # the stage's two blocks
        for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    fit = result["capacity_2x"]["fit"]
    result["launches"] = {
        "resblock": (result["capacity_2x"]["serve"]["launches"]["bf16"]
                     + fit["train"]["launches"]["resblock"]
                     + fit["evaluate"]["launches"]["resblock"]
                     + result["capacity_2x"]["scene"]["k1_device_launches"]),
        "resblock_fp32": result["capacity_2x"]["serve"]["launches"]["fp32"],
        "noise": fit["train"]["launches"]["noise"] + fit["evaluate"]["launches"]["noise"]}
    emit({k: v for k, v in result.items() if k not in ("k1", "k4")})
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from msid_tpu_torch.ops._build import build, load_library, nvcc_path

    card = card_line()
    print(card, flush=True)
    failures: list[str] = []

    t0 = time.perf_counter()
    def timed_build(kernel):
        start = time.perf_counter()
        build(*kernel)
        return time.perf_counter() - start

    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per build, together
        build_seconds = list(pool.map(timed_build, KERNELS))
    for name, defines in KERNELS:
        load_library(name, defines)
    emit({"check": "build",
          "sources": sorted({f"msid_tpu_torch/csrc/{k}.cu" for k, _ in KERNELS}),
          "builds": {" ".join((k, *d)): t for (k, d), t in zip(KERNELS, build_seconds)},
          "nvcc": nvcc_path(), "seconds": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    only = sys.argv[1:]
    if only:
        # Named phases alone, while working on one: no result lines.
        partial = {"kernel": lambda: phase_kernel(torch, F, failures),
                   "kernel_fp32": lambda: phase_kernel_fp32(torch, F, failures),
                   "widths": lambda: phase_widths(torch, F, failures, card),
                   "noise": lambda: phase_noise(torch, failures),
                   "norm": lambda: phase_norm(torch, failures),
                   "layernorm": lambda: phase_layernorm(torch, F, failures),
                   "probe": lambda: phase_probe(torch, F, failures),
                   "hybrid": lambda: phase_hybrid(torch, failures, card),
                   "scene": lambda: phase_scene(torch, failures, card),
                   "data_cache": lambda: phase_data_cache(torch, failures, card),
                   "export": lambda: phase_export(torch, failures, card),
                   "decoders": lambda: phase_decoders(torch, failures, card),
                   "perceptual": lambda: phase_perceptual(torch, failures, card),
                   "pretrained": lambda: phase_pretrained(torch, failures, card),
                   "train": lambda: phase_train(torch, failures, card),
                   "parallel": lambda: phase_parallel(torch, failures, card),
                   "nccl_shared": lambda: phase_nccl_shared(torch, failures),
                   "examples": lambda: phase_examples(torch, failures, card)}
        for name in only:
            if name not in partial:
                print(f"chip_smoke: only {sorted(partial)} run alone, got {name!r}",
                      file=sys.stderr)
                return 2
            partial[name]()
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        print(f"partial run of {only}: {'failed' if failures else 'passed'}", flush=True)
        return 1 if failures else 0

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, phase, *args):
        start = time.perf_counter()
        out = phase(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        return out

    rows = timed("kernel", phase_kernel, torch, F, failures)
    rows_fp32 = timed("kernel_fp32", phase_kernel_fp32, torch, F, failures)
    widths = timed("widths", phase_widths, torch, F, failures, card)
    noise = timed("noise", phase_noise, torch, failures)
    norm = timed("norm", phase_norm, torch, failures)
    layernorm = timed("layernorm", phase_layernorm, torch, F, failures)
    serve, reference = timed("serve", phase_serve, torch, failures, card)
    serve_fp32 = timed("serve_fp32", phase_serve_fp32, torch, failures, card, reference)
    scene = timed("scene", phase_scene, torch, failures, card)
    train = timed("train", phase_train, torch, failures, card)
    data_cache = timed("data_cache", phase_data_cache, torch, failures, card)
    evaluate = timed("evaluate", phase_evaluate, torch, failures, card)
    probe = timed("probe", phase_probe, torch, F, failures)
    hybrid = timed("hybrid", phase_hybrid, torch, failures, card)
    export = timed("export", phase_export, torch, failures, card)
    timed("decoders", phase_decoders, torch, failures, card)
    timed("perceptual", phase_perceptual, torch, failures, card)
    timed("pretrained", phase_pretrained, torch, failures, card)
    parallel = timed("parallel", phase_parallel, torch, failures, card)
    examples = timed("examples", phase_examples, torch, failures, card)
    emit({"check": "phase_seconds", **seconds})

    def per_forward(kernel_rows, b=max(BATCHES)):
        big = [r for r in kernel_rows if r["B"] == b and (r["C"], r["H"]) in SHAPES]
        out = {k: 2 * sum(r[k] for r in big)       # 2 blocks per stage
               for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "bound_ffma_ms")
               if k in big[0]}
        out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in big)
                           else "bytes")
        return out

    k1, k4 = per_forward(rows), per_forward(rows_fp32)
    scene_per = f"the 8 launches of one B={SCENE_BATCH} window batch of the scene path"
    k1_scene = dict(per_forward(rows, SCENE_BATCH), per=scene_per)
    k4_scene = dict(per_forward(rows_fp32, SCENE_BATCH), per=scene_per)
    resblock_by_path = {"serve": serve["launches"], "serve_fp32": serve_fp32["k1_launches"],
                        "scene": scene["launches"]["bf16"],
                        "train": train["launches"]["resblock"],
                        "evaluate": evaluate["launches"]["resblock"],
                        "probe": probe["launches"]["resblock"],
                        "hybrid": hybrid["launches"]["resblock"],
                        "export": export["launches"]["export"],
                        "export_new_batch": export["launches"]["export_new_batch"],
                        "serve_mesh": parallel["launches"]["serve_mesh"],
                        "serve_mesh_benchmark": parallel["launches"]["serve_mesh_benchmark"],
                        "examples": examples["launches"]["resblock"],
                        "widths": widths["launches"]["resblock"]}
    noise_by_path = {"serve": serve["noise_launches"], "train": train["launches"]["noise"],
                     "train_cache": data_cache["launches"]["noise"],
                     "evaluate": evaluate["launches"]["noise"],
                     "train_dp": parallel["launches"]["train_dp"],
                     "examples": examples["launches"]["noise"],
                     "widths": widths["launches"]["noise"]}
    fp32_by_path = {"evaluate": evaluate["launches"]["resblock_fp32"],
                    "serve_fp32": serve_fp32["k4_launches"],
                    "scene_fp32": scene["launches"]["fp32"],
                    "probe": probe["launches"]["resblock_fp32"],
                    "hybrid": hybrid["launches"]["resblock_fp32"],
                    "export_fp32": export["launches"]["export_fp32"],
                    "examples": examples["launches"]["resblock_fp32"],
                    "widths": widths["launches"]["resblock_fp32"]}
    norm_by_path = {"norm": norm["launches"], "train": train["launches"]["batchnorm"],
                    "examples": examples["launches"]["batchnorm"]}
    layernorm_by_path = {"layernorm": layernorm["launches"],
                         "scene": layernorm["scene"]["launches_at_capture"]}
    v2_by_path = {"probe": probe["launches"]["resblock_v2"]}
    any_dma_by_path = {"probe": probe["launches"]["any_dma"]}
    k3 = per_forward(probe["k3"])
    k3_probe = probe["k3"][-1]              # one launch at the probe's shape
    k5_small, k5_large, k5_ragged = probe["k5"]
    # Serving corrupts nothing: K2 runs on the training and evaluate paths.
    for name, by_path, paths in (
            ("fused_residual_block", resblock_by_path, resblock_by_path),
            ("apply_sensor_noise", noise_by_path, ("train", "train_cache", "evaluate",
                                                   "train_dp", "examples", "widths")),
            # The walkthroughs run bf16 configurations: K4 is recorded there.
            ("fused_residual_block_fp32", fp32_by_path,
             [p for p in fp32_by_path if p != "examples"]),
            ("fused_residual_block_v2", v2_by_path, v2_by_path),
            ("batch_norm_train", norm_by_path, norm_by_path),
            ("bias_free_norm", layernorm_by_path, layernorm_by_path),
            ("any_dma_scale", any_dma_by_path, any_dma_by_path)):
        if not all(by_path[p] > 0 for p in paths):
            failures.append(f"{name}: a path launched it no time: {by_path}")
    emit({"kernels": [{
        "name": "fused_residual_block",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:402",
        "launches": sum(resblock_by_path.values()),
        "launches_by_path": resblock_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": k1["kernel_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
        "scene_forward": k1_scene,
        "tiles": {f"C{r['C']}B{r['B']}": r["tile"] + [r["cluster"]] for r in rows},
        "widths": "8..768, 11 builds by padded width (widths phase)",
        "bodies": "resident window at builds 16..192, streamed window (chunks multicast "
                  "across the cluster) at 256..768",
        "wide": widths["wide"],
        "capacity_2x_stage_768": dict(widths["k1_stage_768_b16"],
                                      per="the 2 launches of the C=768 stage of one "
                                          "B=16 capacity_2x forward (24x24)"),
        "widths_max_abs_err": max(r["max_abs_err"] for r in widths["k1"]),
    }, {
        "name": "apply_sensor_noise",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/noise.cu",
        "replaces": "msid_tpu/ops/pallas_noise.py:152",
        "launches": sum(noise_by_path.values()),
        "launches_by_path": noise_by_path,
        "max_abs_err": noise["max_abs_err"],
        "ms": noise["kernel_ms"],
        "plain_ms": noise["plain_ms"],
        "bound_ms": noise["bound_ms"],
        "bound_by": noise["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call draws and composes the five "
                   "noise components",
        "per": "one launch on a [64,192,192,13] fp32 batch (one train step)",
        "issue_bound_ms": noise["issue_bound_ms"],
        "instructions_per_element": noise["instructions_per_element"],
        "loop_instructions": noise["float32"]["loop_instructions"],
        "hbm_share_of_peak": noise["hbm_share_of_peak"],
        "bf16": {k: noise["bfloat16"][k] for k in (
            "kernel_ms", "bound_ms", "issue_bound_ms", "instructions_per_element",
            "hbm_share_of_peak")},
    }, {
        "name": "fused_residual_block_fp32",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock_fp32.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:470",
        "launches": sum(fp32_by_path.values()),
        "launches_by_path": fp32_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows_fp32),
        "ms": k4["kernel_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "bound_ffma_ms": k4["bound_ffma_ms"],
        "library_ms": k4["library_ms"],
        "library": "cuDNN fp32 conv2d composition of the same block (TF32 off)",
        "peak": "bound_ms: three TF32 passes at 495 TFLOP/s dense on the tensor cores "
                "(165 TFLOP/s of fp32 work), the route the kernel takes; bound_ffma_ms: "
                "66.9 TFLOP/s fp32 outside the tensor cores; 3.35 TB/s HBM (H100 SXM)",
        "tiles": {f"C{r['C']}B{r['B']}": r["tile"] + [r["cluster"]] for r in rows_fp32},
        "per": f"the 8 launches of one B={max(BATCHES)} flagship forward",
        "scene_forward": k4_scene,
        "clusters": {f"C{r['C']}B{r['B']}": [r["cluster"], r["kernel_ms"]]
                     for r in widths["k4"]},
        "widths_max_abs_err": max(r["max_abs_err"] for r in widths["k4"]),
    }, {
        "name": "fused_residual_block_v2",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/resblock.cu",
        "replaces": "msid_tpu/ops/pallas_decoder.py:220",
        "launches": sum(v2_by_path.values()),
        "launches_by_path": v2_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in probe["k3"]),
        "ms": k3_probe["kernel_ms"],
        "plain_ms": k3_probe["plain_ms"],
        "bound_ms": k3_probe["bound_ms"],
        "bound_by": k3_probe["bound_by"],
        "library_ms": k3_probe["library_ms"],
        "library": "cuDNN bf16 conv2d composition of the same block",
        "functional_ms": k3_probe["functional_ms"],
        "k1_ms": k3_probe["k1_ms"],
        "tile": k3_probe["tile"], "cluster": k3_probe["cluster"],
        "per": f"one launch at the probe's {list(PROBE_SHAPE)} (its main path)",
        "flagship_forward": dict(
            k3, k1_ms=2 * sum(r["k1_ms"] for r in probe["k3"][:-1] if r["B"] == max(BATCHES)),
            per=f"8 launches at the shapes of one B={max(BATCHES)} flagship forward"),
    }, {
        "name": "any_dma_scale",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/any_dma.cu",
        "replaces": "benchmarks/pallas_probe.py:145",
        "launches": sum(any_dma_by_path.values()),
        "launches_by_path": any_dma_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in probe["k5"]),
        "ms": k5_small["device_ms"],
        "plain_ms": k5_small["plain_device_ms"],
        "bound_ms": k5_small["bound_ms"],
        "bound_by": k5_small["bound_by"],
        "library_ms": k5_small["library_device_ms"],
        "library": "x * 2 (one elementwise kernel; also the plain version)",
        "timing": f"ms, plain_ms, library_ms: device time per launch in a CUDA graph of "
                  f"{GRAPH_LAUNCHES}; call_ms: CUDA events around one call (host included)",
        "call_ms": k5_small["call_ms"], "library_call_ms": k5_small["library_call_ms"],
        "per": f"one launch on {k5_small['shape']} fp32 (the probe's slice)",
        "large": {k: k5_large[k] for k in (
            "shape", "device_ms", "call_ms", "plain_device_ms",
            "library_device_ms", "library_call_ms", "bound_ms", "bound_by",
            "share_of_bound")},
        "ragged": {k: k5_ragged[k] for k in ("shape", "device_ms",
                                              "library_device_ms", "ok")},
    }, {
        "name": "batch_norm_train",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/batchnorm.cu",
        "replaces": "none: Norm's fp32 composition (msid_tpu_torch/models/blocks.py), which "
                    "the JAX package leaves to XLA",
        "launches": sum(norm_by_path.values()),
        "launches_by_path": norm_by_path,
        "max_abs_err": max(max(r["max_abs_err"][k] for k in ("y", "dx"))
                           for r in norm["rows"]),
        "ms": sum(r["kernel_ms"] for r in norm["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in norm["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in norm["rows"]),
        "bound_by": "bytes",
        "library_ms": None,
        "library": "none called: cuDNN's batch norm keeps the unbiased variance in "
                   "running_var, the port the biased one",
        "timing": f"ms: device time of the forward's and the backward's launches, each "
                  f"in a CUDA graph of {NORM_GRAPH_LAUNCHES}; plain_ms: CUDA events "
                  f"around the composition's eager forward and backward",
        "per": f"forward and backward once at each of the {len(NORM_SHAPES)} flagship "
               f"norm shapes at B={NORM_BATCH}, bf16",
        "stages": {f"C{r['C']}H{r['H']}": [r["forward_ms"], r["backward_ms"],
                                           r["bound_forward_ms"], r["bound_backward_ms"],
                                           r["plain_ms"]] for r in norm["rows"]},
        "stages_columns": ["forward_ms", "backward_ms", "bound_forward_ms",
                           "bound_backward_ms", "plain_ms"],
    }, {
        "name": "bias_free_norm",
        "route": "cuda",
        "source": "msid_tpu_torch/csrc/layernorm.cu",
        "replaces": "none: Restormer's bias-free LayerNorm composition "
                    "(msid_tpu_torch/models/restormer.py); the JAX package has no Restormer",
        "launches": sum(layernorm_by_path.values()),
        "launches_by_path": layernorm_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in layernorm["rows"]),
        **layernorm["shapes"],
        "bound_by": "bytes",
        "library": "F.layer_norm over the channels (centring, no bias), never called by "
                   "the port; copy_ms: x.clone(), the same bytes read and written",
        "timing": f"device time a launch in a CUDA graph of {NORM_GRAPH_LAUNCHES}, bf16",
        "per": f"one launch at the norm shape of each of the {layernorm['levels']} levels "
               f"of a B={LN_BATCH} batch of 512-px windows",
        "scene": {k: layernorm["scene"][k] for k in (
            "captured_launches", "forwards_at_capture", "launches_at_capture", "replays",
            "launches_at_replays")},
        "forward": dict(layernorm["forward"],
                        per=f"the {layernorm['norms']} norms of one B={LN_BATCH} forward"),
    }]})
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
