#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bpx_torch``) on one CUDA card.

    python3 chip_smoke.py              # build, check, serve, train; last
                                       # line is JSON
    python3 chip_smoke.py --profile    # also print a kernel-time breakdown of
                                       # one served forward and one train step

Phases, each of which fails the script (non-zero exit) if it fails:

1. build the CUDA kernels from ``bpx_torch/csrc`` with nvcc for sm_90a;
   print the card's name and power limit;
2. serving: build ``bpx_torch.serve.Predictor`` for the ``moviescope``
   preset at full width (BERT-base T=512, 12 four-layer hidden-768
   encoders, conv audio encoder, GMUs), batch 8, bf16, seeded random
   weights, and serve one warm-up request while recording the arguments of
   every kernel launch: these are the shape classes of the served forward;
3. the flash-attention forward kernel and the LayerNorm forward kernel
   against their plain PyTorch versions at every served class: max errors,
   kernel / plain / library (``F.scaled_dot_product_attention``, with the
   backend that ran and the first kernel whose name told it; called with
   ``is_causal`` where the visible mask is exactly the causal triangle,
   else with the mask; and ``F.layer_norm``) times (CUDA events, median of 10
   groups of 5 warm runs; ``Timer``), the bound (the larger of bytes / 3.35 TB/s and
   flops / 989 TFLOP/s), the share of the bound reached and the ratio to
   the library call; for LayerNorm also the device kernels one call runs
   and their times, from the profiler (exactly one, no memset), and its
   scalar path once on a misaligned view (the profiler must name the
   scalar kernel);
4. the serving path: numpy-seeded synthetic requests, one of them ragged,
   with the launch counters set to 0 before and read after (84 flash and
   181 LayerNorm launches per forward), outputs checked for shape, range and
   finiteness and against the plain versions forced on the card; planted
   faults (the flash kernel without its ``kv_lens`` or its band) must move
   that comparison past its limits;
5. training: the same model in training mode (every configured dropout),
   Adam, BCE with ``pos_weight`` from synthetic label frequencies.  One
   micro-step (batch 8) with the kernels, recording every launch, against
   the same micro-step under ``plain_versions()`` (same weights, batch and
   dropout seeds): the loss and each parameter group's gradient; planted
   faults (the flash backward without its dropout mask, or without its
   band) must move the gradients past their limit;
6. the new kernels at the recorded micro-step's classes against their plain
   versions, with the same timings: the flash forward with dropout, the
   flash backward (at head_dim 64 and 96 the delta, dK/dV and dQ kernels;
   at every other head dim the dQ kernel, which computes delta, and the
   dK/dV kernel; timed together, with the profiler's split, each kernel
   beside its own bound) at rate 0 and 0.1 (SDPA's backward as the library
   yardstick) and its delta kernel alone, the LayerNorm backward
   (``F.layer_norm``'s backward; bitwise-equal reruns; the device kernels
   one call runs, from the profiler: exactly one, the cooperative launch,
   and no memset; its scalar kernel once on a misaligned view); the plain
   hash dropout's time; an exact
   check of the kernels' dropout masks (q = 0, V = I, dO = I); one long
   multi-tile shape (B*H 2, 640 x 1280, band and dropout), checked, then
   timed: the forward, the dQ and the dK/dV kernel each beside its bound
   and SDPA;
7. two train steps at micro-batch 8 x A = 2 on numpy-seeded synthetic
   super-batches: counters set to 0 before each step and checked after it
   (168 flash forward launches, 72 of them with dropout, 168 flash
   backward calls, 458 LayerNorm forward and 458 backward launches); finite
   losses; after step 1 every parameter has a finite gradient and BERT's
   embedding, LayerNorm and q/k/v gradients are non-zero.  Prints the step
   time (median, host clock, synchronised), samples/s and peak memory;
8. the ``iemocap`` preset's ``mmtrvat`` at full width and depth (BERT-base,
   12 eight-layer hidden-300 encoders over 12 heads, so head_dim 25, raw
   audio, 3-ary GMU): phases 2-7 again on its own path.  The served
   forward's 108 flash launches (96 at head_dim 25, 12 at 64) and 325
   LayerNorm launches; no q/k/v/dO/O copied by the wrapper at head_dim 25;
   the forward at its head_dim-25 class and LayerNorm at 4096 x 300 timed;
   2 requests against the plain path with its own limits, which both
   planted faults must cross; one request of the same model with
   ``fusion="mag"`` against the plain path.  Training: one micro-step
   against the plain path (planted backward faults), the head_dim-25
   dropout forward and backward at its classes (each backward row also
   with the dQ and dK/dV kernels' own bounds), the exact dropout mask at
   (8, 12, 512, 512, 25), the long shape at head_dim 25, then 2 train
   steps (216 flash forward, 88 with dropout, 216 backward, 842 LayerNorm
   forward and backward per step);
9. the ``cmu-mosei`` preset (10 heads, so head_dim 30): one served
   forward's classes recorded, one request against the plain path and one
   train step, with exact counters; the forward, the backward and the
   delta kernel at its head_dim-30 classes (rate 0 and 0.1) against their
   plain versions, and the long shape at head_dim 30;
10. the ``mmimdb`` preset's ``mmtrvapt`` at full width and depth (hidden
   768 over 6 heads, so head_dim 128; T = 512 on every stream; the audio
   stream raw and 1 wide, no audio encoder): phases 2-7 on its own path,
   with its own limits, which both planted faults must cross; the served
   forward's 84 flash launches (72 at head_dim 128, 12 at 64) and 181
   LayerNorm launches, no tensor copied by the flash wrappers; training:
   one micro-step against the plain path, the head_dim-128 kernels with
   dropout at its classes, the exact dropout mask at (8, 6, 512, 512,
   128), 2 train steps (168 / 72 / 168 / 458 / 458 launches per step) with
   the peak memory, the long shape at head_dim 128; the profiler must
   name the head_dim-128 forward kernel (``flash_fwd_wide_kernel``) at
   every one of its classes, as it names each head dim's own forward
   kernel on every path;
11. the ``counseling`` and ``cmu-mosi`` presets (``mmtrvat`` at 5 layers,
   head_dim 30; counseling's video and audio unprojected, cmu-mosi's one
   output with the L1 loss): one request against the plain path and one
   train step each, with exact counters;
12. the ``synthetic-tiny`` preset (fp32, head_dim 16, ``attention_impl``
   "xla"): one request and one train step through the einsum attention,
   with no flash launch and exact LayerNorm counters;
13. the training loop: a moviescope dataset at full width written in the
   reference's layout under a temporary directory (32 train, 16 dev, 16
   test records), trained through ``bpx_torch.cli.train.cli_main`` in this
   process with the README's command (``mmtrvapt``, hidden 768, 8 heads, 4
   layers, micro-batch 8 x A = 2, ``attention_impl`` pallas) for 1 epoch:
   the memmap cache, checkpoints, ``test``.  Counters set to 0 before and
   read after, and checked per train step (168 flash forward, 72 with
   dropout, 168 backward, 458 LayerNorm forward and backward) and per
   evaluation forward (84 flash, 181 LayerNorm); every launch class among
   those phases 3-6 held against the plain versions; no tensor copied.
   Then the run resumed to 2 epochs (it must start at epoch 1, with weights
   and Adam moments equal to the saved ones bitwise, and run one epoch),
   and ``Predictor.from_checkpoint`` on the test records against ``test``'s
   ``preds_raw.npy``; per-epoch times, the cache build and the peak memory.

14. the kernels as ``torch.library`` custom ops (``bpx_torch::flash_fwd``,
   ``flash_bwd``, ``flash_delta``, ``layer_norm``, ``layer_norm_bwd``):
   after the build, the host time one call of each public wrapper adds
   over its impl alone (the launch path without the op) under
   inference_mode, in turns, and a call with grad enabled; in phase 13,
   ``python -m bpx_torch.cli.export`` (``Predictor.export`` of the restored
   moviescope model at batch 8) on the loop's run directory, its archive
   served in a new process that must not import the model code or the
   config, on the test records and a ragged request: 84 flash and 181
   LayerNorm launches per exported forward, probabilities bitwise equal to
   ``Predictor.from_checkpoint``'s, both served medians;
15. recompute, after phase 10, at the presets' own settings: iemocap (every
   encoder and BERT layer recomputed in full) and mmimdb (``save_attn`` in
   the encoders, BERT in full).  One micro-step (batch 8, every dropout)
   without and with recompute on the same weights, batch and seeds: the
   loss and every parameter group's gradient bitwise equal (BERT's
   embeddings, whose backward adds with atomics, within REMAT_EMBED_TOL,
   as between two runs without recompute), the launches exact (a
   recomputed layer runs its LayerNorms again, and its flash forwards
   unless ``save_attn`` keeps them), a lower peak memory; a replay that
   draws fresh dropout seeds (planted) must change the gradients.  Then
   one train step at the preset's ``batch_sz`` (128, A = 1) with
   recompute: its time, peak memory and launches.  Phases 2-12 run every
   preset without recompute, as before recompute was ported.
16. the options the training CLI accepts, after phase 15: first (d)
   every flash kernel at (8, H, 32, 32, D) for D 25, 30, 64, 96, 128, rate
   0 and 0.1, forward and backward against the plain versions, timed
   beside the bound and SDPA, and the exact dropout masks there; then (a)
   moviescope with ``hybrid`` (three self-attention encoders over 32
   positions, a 5-ary final GMU): 2 requests (one ragged) against the
   plain path with both planted faults (96 flash, 208 LayerNorm launches
   per forward), one micro-step against the plain path with the planted
   backward faults, then 6 RAdam steps at 8 x A = 1 (the adaptive step
   from step 5, recorded; 96 / 48 / 96 / 256 / 256 launches per step);
   (b) moviescope with ``group_encoders`` (each pair one attention over a
   doubled batch): the served path (48 flash, 181 LayerNorm launches per
   forward) and micro-step with the planted faults, one A = 2 step's
   gradients with bf16 and with fp32 accumulation on the same weights,
   batch and seeds (they must differ, within BF16_ACCUM_ERR of each
   other), then 2 steps at 8 x A = 2 accumulating in bf16; (c) iemocap's
   ``mmtrvat`` with ``hybrid`` (4-ary GMU, early encoders at head_dim 25):
   one request, one micro-step against the plain path with the planted
   faults and one step, exact counters.  Each recorded forward and
   micro-step of (a)-(c) holds every class that no earlier phase held
   (flash and LayerNorm, forward and backward: the 2B flash classes, the
   profiler naming each head dim's kernel, and the early encoders'
   LayerNorms at 256 rows) against its plain version.
17. the vmapped multi-seed step (``bpx_torch.train.multiseed``), after
   phase 13: iemocap's ``mmtrvat`` at full width and depth and at its
   preset's own config (full recompute), seeds 1-5 stacked, micro-batch 8
   a seed, A = 1, bf16, every dropout, Adam.  One vmapped step that keeps
   the weights (SGD at lr 0): its launches exact against a recorded
   single-seed A = 1 step with recompute, itself exact against the
   structure (``remat_launches``: the flash kernels launched as often as
   one seed's micro-step, 216 / 88 / 108 with the replays: one folded
   launch over S·B·H; the LayerNorms S times as often, one launch a
   seed), nothing copied; seeds 1 and 5 against their own single-seed
   steps on the same weights and base seeds (the loss and each module's
   gradient, relative L2, within MULTISEED_LOSS_TOL / MULTISEED_GRAD_TOL);
   every seed against the same vmapped step under ``plain_versions()``;
   two planted faults of the folded launch, each a build of the kernels
   with ``-DBPX_PLANT_SEED_FAULT``, built in the background during the
   phase's untimed first part (every group hashing with group 0's
   seed; bh not reduced to its group) and a replay that draws seeds past
   its first pass's, which the comparison with the single-seed steps must
   catch.  The folded launches' masks exact against
   each group's own launch at head_dim 25 and 64 (q = 0, V = dO = I).
   Then 2 Adam steps with exact counters: the median beside the
   single-seed step's, ``S * t_single / t_vmapped``, the peak memory; one
   folded launch against S launches (CUDA events) at the encoders' D 25
   class and BERT's D 64 class; the folded classes against the plain
   versions with bound and SDPA, each with dropout at its five seed groups,
   so on the kernels' build for several groups, which the profiler must
   name (the LayerNorms run at iemocap's classes).  Then two seeds of
   mmimdb's ``mmtrvapt`` at its own recompute (``save_attn`` in the
   encoders: their head_dim-128 flash forward launched once a call, BERT's
   twice) and of ``mmtrvpa`` at moviescope's widths (head_dim 192 in its
   memory encoders), each in one vmapped step with launches exact against
   the structure and the first seed against its own single-seed step
   within the path's limits, every folded flash class both ways against the plain
   version; ``Predictor.export`` of mmtrvpa (moviescope's widths, one
   layer a crossmodal encoder: 27 flash and 70 LayerNorm launches a
   forward) served in a process without the model code, bitwise against
   the eager ``Predictor``; and one vmapped
   flash call over 20 seeds (head_dim 25, rate 0.1): one launch a chunk of
   at most 16 seed groups each way, against the plain version, bitwise
   against each seed's own launch, every keep bit of both directions
   exact, each chunk's class timed;
18. the task farm: ``python -m bpx_torch.cluster.scheduler`` over a
   temporary jobs file (two one-epoch ``python -m bpx_torch.cli.train``
   runs on synthetic data and a line that exits 3), two workers on card 0,
   one retry: exit 1, both runs rc 0 with a log naming the ``cuda``
   device, the failing line rc 3 after 2 attempts, one log a job;
19. the notebook-era models (``bpx_torch/models/legacy.py``) at
   moviescope's full width (the preset with only ``model`` changed; bf16,
   seeded weights): each of the seven classes served, 2 requests at batch
   8 (one ragged) against the plain path within moviescope's limits, with
   exact counters per forward (mmtrvpa 48 flash launches, 12 of them at
   head_dim 192 in its 1536-wide memory encoders, and 130 LayerNorm;
   tmmtrvpa 60 and 181; gmu, gmu_bi, gmu_hier, gmu_softmax and bertclf 12
   and 25), ``bert`` against ``bertclf`` (within ALIAS_TOL); mmtrvpa,
   tmmtrvpa and gmu_hier trained: one micro-step against the plain path
   (the planted backward faults on the two with encoders), then one Adam
   step at 8 x A = 2 with every dropout and exact counters (per step
   96 / 64 / 96 / 308 / 308, 120 / 56 / 120 / 458 / 458, 24 / 24 / 24 / 50
   / 50); every class no earlier phase held (the head_dim-192 flash forward
   and backward at 512 x 512 and 200 x 200 causal, rate 0 and 0.1, the
   profiler naming their kernels; the LayerNorms at width 1536) against
   its plain version, timed beside the bound and the library call; the
   exact dropout masks at (8, 8, 512, 512, 192); one ``python -m
   bpx_torch.cli.train --model mmtrvpa`` epoch on a written moviescope
   dataset, rc 0 on the card.
20. ``mmtrvpa`` at iemocap, cmu-mosei and mmimdb, after phase 19: each the
   preset with only ``model`` changed, at full width and depth (bf16,
   seeded weights), its 2E-wide memory encoders at head_dim 50, 60 and 256.
   Each served, 2 requests at batch 8 (one ragged) against the plain path
   within the preset's limits, exact counters per forward (84, 84 and 48
   flash launches, 24, 24 and 12 of them at the memory head dim; 226, 226
   and 130 LayerNorm); iemocap and mmimdb trained (one micro-step against
   the plain path with the band fault planted, then one Adam step at 8 x A
   = 2 with every dropout and exact counters: 168 / 104 / 168 / 548 / 548
   and 96 / 64 / 96 / 308 / 308 per step), cmu-mosei one step; every class
   no earlier phase held (the memory encoders' flash forward and backward
   at (8, 12, 512, 512, 50), (8, 10, 512, 512, 60) and (8, 6, 512, 512,
   256) causal, rate 0 and 0.1, the profiler naming their kernels (the
   forward's wide kernel at 50 and 60, its tall one at 256), bitwise on a
   rerun; also the kernels built for two seed groups at rate 0.1; the
   600-wide LayerNorms) against its plain version, timed beside the bound
   and the library call; the exact dropout masks at those three shapes,
   with one seed and with two seed groups, each group's bits its own
   launch's.
21. ``[mesh]``, the multi-card trainer on the one card: an NCCL process
   group of world size 1 from a file store and its (1, 1, 1) mesh.
   Moviescope's model at full width and depth (bf16, 8 x A = 2, Adam,
   every dropout) takes 2 steps through the one-process trainer, then
   through the sharded one with DDP and with FSDP2 from the same weights,
   batches and seeds: step 1 of each within the micro-step limits of the
   one-process step (loss, per-group gradients) and within 1e-5 of it
   (``MESH_TOL``, from the readings), exact counters per step
   (168 / 72 / 168 / 458 / 458), medians and peak memory.  The placed
   kernels: at D 25, 64, 128 and 192 (8 x 12, 12, 6, 8 heads x 512 x
   512, causal, rate 0.1) the (B/2, H/2) piece a rank of a data=2 x
   tensor=2 mesh holds, with its block placement, must equal the global
   call's slice bit for bit (O, lse, dQ, dK, dV and both kernels' mask
   bits) and match the plain version with the placement.  The stress
   preset (BERT-large, 2.21 B parameters, recompute): one served request
   of 8 with exact counters, then one FSDP2 step of 64 rows at the
   largest micro-batch that fits, with exact counters, its time and peak
   memory; the step's flash classes (1024 / 768 queries x 768 / 1024
   keys, BERT's 512 x 512, D 64, 16 heads a row, dropout 0.1 where the
   step draws it) against the plain versions both ways (the plain ones
   in placed chunks of 8 rows) and timed.
22. the flash kernels' whole domain up to head_dim 256: bf16 at an
   untabled head dim on the tabled kernels' panel builds
   (``csrc/flash_panel_fwd.cu``, ``csrc/flash_panel_bwd.cu``, the narrow,
   wide and tall kernels at a runtime head dim) and fp32 on the generic
   kernels (``csrc/flash_generic.cu``; ``kernel_route``).  (a) moviescope
   at 16 heads (head_dim 48 in the encoders: 72 of the 84 flash launches
   per forward on the panel builds, 0 generic, BERT's 12 tabled) and (b)
   iemocap's ``mmtrvat`` in fp32 (all 108 generic, at 25 and 64; TF32 off,
   printed), each at full width: 2 requests at batch 8 (one ragged)
   against the plain path with both planted faults, the launches exact by
   route; its classes on its route both ways against the plain versions
   and timed (fp32's LayerNorm classes too); one micro-step against the
   plain path with the planted backward faults, launches by route; one
   Adam step at 8 x A = 2 with exact counters.  (c) the README's
   synthetic quick start with ``--attention_impl pallas`` through ``python
   -m bpx_torch.cli.train`` for one epoch: rc 0, every flash launch
   generic (fp32).  (d) one class in each panel band (bf16 at head_dim 16,
   32, 80, 112, 160, 224 on the panel builds; fp32 at 48, 128, 256 on the
   generic kernels: the band with an offset, an empty ``kv_lens`` row,
   rate 0.1, two seed groups, Tk 1100) both ways against the plain
   versions, timed beside the bound (fp32's: three TF32 passes, 165
   TFLOP/s) and SDPA; the exact masks at one seed, two seed groups and
   placed (bf16 at 48 and 33, fp32 at 25); every bf16 head dim from 1 to
   256 outside the table (247) at one small class both ways against the
   plain versions, each counted on the panel route, and fused views at
   odd head dims above 32 taken uncopied on the words build; one planted
   fault per panel kernel (at one head dim of each panel width and at 33)
   and per generic kernel (one build with ``DOMAIN_FAULTS``, made in the
   background meanwhile), each past its limit while the sound build is
   within it.
23. the flash kernels past head_dim 256, last: the chunked kernels
   (``csrc/flash_chunked.cu``; bf16 and fp32 at any head_dim above 256,
   ``kernel_route``).  (a) moviescope at 2 heads (head_dim 384 in the
   encoders: 72 of the 84 flash launches per forward chunked, BERT's 12
   tabled) and (b) iemocap's ``mmtrvat`` in fp32 at 1 head (96 chunked at
   300, BERT's 12 generic at 64), each at full width through
   ``domain_path``: 2 requests at batch 8 (one ragged) against the plain
   path with both planted faults, the launches exact by route; its
   chunked classes both ways against the plain versions and timed; one
   micro-step against the plain path with the planted backward faults; 2
   Adam steps at 8 x A = 2 with exact counters and the peak memory.  (c)
   CHUNKED_CLASSES (bf16 and fp32 at head_dim 257, 384, 512, 768 and 1536;
   the band with an offset, an empty ``kv_lens`` row, rate 0.1, two seed
   groups, Tk 1100) both ways against the plain versions, timed beside the
   bound (the function's own work; the kernels' flops over it, the scores
   recomputed once per 128-column chunk, printed beside it as
   ``recompute``) and SDPA; the exact masks at one seed, two seed groups and placed; one
   planted fault per chunked kernel (a build with
   ``-DBPX_PLANT_CHUNKED_FAULT=7``, made in the background meanwhile),
   caught in O, dQ and dV while the sound build is within its limits.

The loop (13), the recompute phase (15), counseling, cmu-mosi and
synthetic-tiny (11-12) and the farm (18) run in that order after phase 10
and before the options phase (16), since they time no kernel; the
three CLI checks that run in processes of their own (the loop's export
CLI and its archive served, mmtrvpa's CLI run of phase 19 and the
README's command of phase 22) run on side threads beside them, each held
as before and its line printed when it is joined.

The build phase prints ptxas' registers and spills of every kernel, holds
the tabled, the fp32 generic and the chunked kernels to ``PTXAS_RECORD``
(a failure under the record's nvcc release), and prints, per
head dim and panel width, the blocks of the forward, dK/dV and dQ kernels
one SM holds.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
(per kernel, mix-weighted times, ``bound_share`` and ``library_ratio``, its
rows by shape class, and on the moviescope rows the training loop's launches in
phase 13 and per epoch; the narrow backward and forward also alone, at
head_dim 25 from iemocap's train steps and at 30 from cmu-mosei's, and the
head_dim-128 backward and forward from mmimdb's; phase 16's 32 x 32
sweep, hybrid's and the grouped pairs' classes; phase 17's folded
classes; phase 19's head_dim-192 and 1536-wide classes; phase 20's
head_dim 50, 60 and 256 and 600-wide classes; phase 21's stress
classes; phase 22's panel and generic forward, dQ and dK/dV kernels;
phase 23's chunked ones) and, last,
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package; without a CUDA device, or without ``bpx_torch`` beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# fp32's bound: three TF32 passes at 495 TFLOP/s, the fastest route on the
# card that keeps fp32's precision (the generic kernels' own FFMA design
# tops out at 67 TFLOP/s, the CUDA cores' fp32 rate)
PEAK_FP32_FLOPS = 495e12 / 3
FLASH_TOL = dict(atol=2e-2, rtol=2e-2)    # bf16 output
# fp32 output and gradients (the generic kernels): the same function summed
# in another order, as the CPU tests' 2e-5; on an H100 the sound kernels
# read 3e-7 (O) and 2e-7 (gradients, relative)
FLASH_TOL_FP32 = dict(atol=2e-5, rtol=2e-5)
FLASH_GRAD_TOL_FP32 = 2e-5
LSE_TOL = dict(atol=1e-3, rtol=1e-3)      # fp32 statistics
LN_TOL = dict(atol=2e-2, rtol=2e-2)       # bf16 output
LN_STAT_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 statistics
# kernels vs plain versions through the whole bf16 forward (12 BERT layers,
# two rounds of 4-layer encoders): rounding differs at every attention
# (per-tile bf16 probabilities) and LayerNorm, and compounds with depth.
# On an H100 the sound kernels read probs 0.0125 / gates 0.0156, a flash
# kernel without its band 0.044 / 0.0508, one without kv_lens 0.32 / 0.462;
# the limits sit between the sound and the faulty readings
PROBS_TOL = 2.5e-2
GATES_TOL = 3e-2
BATCH = 8
REQUESTS = 2               # the second one is ragged
# launches per served forward, counted from the model's structure: BERT's
# 12 layers, and 12 encoders x 4 layers with one attention each in the
# first round and two in the biprojection round; LayerNorm: BERT's
# embedding norm and 2 per layer, and 3 per encoder layer plus a final one
FLASH_PER_FORWARD = 12 + 6 * 4 + 6 * 4 * 2
LN_PER_FORWARD = 1 + 2 * 12 + 12 * (4 * 3 + 1)
# training: V is embedded apart from K (embedding dropout), one more
# LayerNorm per encoder layer; dropout in BERT's 12 attentions and in the
# encoders with attn_dropout 0.1 (trans_v_with_l, trans_a_with_l: 4 layers
# x 1; trans_v_with_a2l, trans_a_with_v2l: 4 layers x 2)
LN_PER_TRAIN_FORWARD = LN_PER_FORWARD + 12 * 4
FLASH_DROPOUT_PER_FORWARD = 12 + 2 * 4 + 2 * 4 * 2
TRAIN_A = 2                # micro-batches per step (BATCH each)
TRAIN_STEPS = 2
LR = 1e-3
FLASH_GRAD_TOL = 2e-2      # bf16 dq/dk/dv, relative to the largest entry
DELTA_TOL = dict(atol=1e-4, rtol=1e-4)    # fp32 sums of D products
LN_PARAM_GRAD_TOL = 1e-4   # fp32 dw/db, relative to the largest entry
# one full-width bf16 micro-step, kernels vs plain versions (same weights,
# batch and dropout seeds): the loss, and each parameter group's gradient
# (relative L2 error).  On an H100 (700 W) the sound kernels read loss
# 5.0e-4 and gradients 0.017-0.164 by group: bf16 rounding, as large as the
# plain bf16 path's own distance from the same step in fp32 (0.020-0.302).
# A backward without its dropout mask reads 1.88, one without its band
# non-finite.  The gradient limit sits between (3x over, 3.8x under); the
# kernels must also stay within 1.5x + 0.02 of the plain path's distance
# from fp32, group by group (sound: at most 1.48x).
LOSS_TOL = 1e-2
GRAD_TOL = 0.5
FP32_FACTOR = 1.5
FP32_SLACK = 0.02


@dataclasses.dataclass(frozen=True)
class ModelPath:
    """One model path the script drives: its preset, the launches its
    structure gives per forward, and the limits of its kernels-vs-plain
    comparisons (each set between the sound and the planted faults'
    readings on the card)."""
    preset: str
    flash: int             # flash launches per served forward
    ln: int                # LayerNorm launches per served forward
    ln_train: int          # LayerNorm launches per training forward
    dropout: int           # flash launches with dropout per training forward
    probs_tol: float
    gates_tol: float
    loss_tol: float = LOSS_TOL
    grad_tol: float = GRAD_TOL
    fusion: str = "gmu"
    options: tuple = ()    # (field, value) pairs the model config takes
    generic: int = 0       # of the flash launches per forward, those of
    #                        the generic kernels (kernel_route)
    chunked: int = 0       # ... and those of the chunked kernels
    panel: int = 0         # ... and those of the tabled kernels' panel
    #                        builds

    @property
    def name(self) -> str:
        """The preset, and the options the path sets on it (a flag by its
        name, the model by itself, another value as name=value)."""
        return " ".join([self.preset] + [
            k if v is True else str(v) if k == "model" else f"{k}={v}"
            for k, v in self.options])


MOVIESCOPE = ModelPath("moviescope", FLASH_PER_FORWARD, LN_PER_FORWARD,
                       LN_PER_TRAIN_FORWARD, FLASH_DROPOUT_PER_FORWARD,
                       PROBS_TOL, GATES_TOL)
# mmtrvat at 8 layers (iemocap, cmu-mosei): BERT's 12 attentions and 12
# encoders x 8 layers with one attention each (the second round is plain
# crossmodal, not biprojection), 96 of them at head_dim 300 / H; LayerNorm:
# BERT's 25, and 3 per encoder layer plus a final one; training adds one per
# encoder layer (V embedded apart from K); dropout in BERT's 12 attentions
# and in the 4 encoders keyed by l (attn_dropout 0.1: trans_v_with_l,
# trans_a_with_l, trans_v_with_a2l, trans_a_with_v2l), 8 layers each
def vat_counts(layers: int):
    """(flash, LayerNorm, LayerNorm in training, flash with dropout) per
    forward of an mmtrvat with ``layers`` per encoder, as above."""
    ln = 1 + 2 * 12 + 12 * (layers * 3 + 1)
    return 12 + 12 * layers, ln, ln + 12 * layers, 12 + 4 * layers


VAT_FLASH, VAT_LN, VAT_LN_TRAIN, VAT_DROPOUT = vat_counts(8)
# kernels vs plain versions through the whole bf16 iemocap forward (12 BERT
# layers, two rounds of 8-layer encoders, every encoder attention causal
# 512 x 512).  On an H100 (700 W) the sound kernels read probs 0.0159 /
# gates 0.0156, a flash kernel without its band 0.0787 / 0.137, one without
# kv_lens 0.286 / 0.64: the limits sit at about the geometric mean of the
# sound and the nearer faulty reading (probs 2.2x from each, gates 2.9x).  The
# micro-step's gradients: sound worst group 0.0768 (proj1), a backward
# without its dropout mask 0.326 (only BERT and the 4 l-keyed encoders
# drop attention, at 0.1), one without its band non-finite: limit 0.16
# (2.1x over, 2.0x under); the loss reads 0.00198 against 1e-2.  MAG
# (probs 0.0086, alpha 5.7e-6) and cmu-mosei (0.013 / 0.0156) are held
# to the same limits.
IEMOCAP_PROBS_TOL = 3.5e-2
IEMOCAP_GATES_TOL = 4.5e-2
IEMOCAP_GRAD_TOL = 0.16
IEMOCAP = ModelPath("iemocap", VAT_FLASH, VAT_LN, VAT_LN_TRAIN,
                    VAT_DROPOUT, IEMOCAP_PROBS_TOL, IEMOCAP_GATES_TOL,
                    grad_tol=IEMOCAP_GRAD_TOL)
# MAG in place of the 3-ary GMU: one LayerNorm more; its gates are alpha
IEMOCAP_MAG = dataclasses.replace(IEMOCAP, ln=VAT_LN + 1,
                                  ln_train=VAT_LN_TRAIN + 1, fusion="mag")
CMU_MOSEI = dataclasses.replace(IEMOCAP, preset="cmu-mosei")
# counseling and cmu-mosi: the same mmtrvat at 5 layers (72 flash, 217 and
# 277 LayerNorm, 32 with dropout per forward), held to iemocap's limits
COUNSELING = dataclasses.replace(IEMOCAP, preset="counseling",
                                 **dict(zip(("flash", "ln", "ln_train",
                                             "dropout"), vat_counts(5))))
CMU_MOSI = dataclasses.replace(COUNSELING, preset="cmu-mosi")
# mmimdb: moviescope's structure (BERT's 12 attentions at head_dim 64, 12
# encoders x 4 layers, the second round biprojection; the same dropout
# table), so the same counts per forward: 84 flash (72 at head_dim 128),
# 181 LayerNorm, 229 in training, 36 flash with dropout (24 at 128).
# Kernels vs plain versions through the whole bf16 mmimdb forward: on an
# H100 (700 W) the sound kernels read probs 0.0152 / gates 0.0176, a flash
# kernel without its band 0.246 / 0.215, one without kv_lens 0.474 / 0.69;
# the micro-step's gradients: sound worst group 0.143 (trans_l_with_a2v), a
# backward without its dropout mask 2.05, one without its band non-finite.
# The limits sit at about the geometric mean of the sound and the nearer
# faulty reading: probs 0.06 (3.9x over, 4.1x under), gates 0.06 (3.4x,
# 3.6x), gradients 0.5 (3.5x, 4.1x)
MMIMDB_PROBS_TOL = 6e-2
MMIMDB_GATES_TOL = 6e-2
MMIMDB_GRAD_TOL = 0.5
MMIMDB = dataclasses.replace(MOVIESCOPE, preset="mmimdb",
                             probs_tol=MMIMDB_PROBS_TOL,
                             gates_tol=MMIMDB_GATES_TOL,
                             grad_tol=MMIMDB_GRAD_TOL)
# synthetic-tiny: the einsum attention (attention_impl "xla"), so no flash
# launch; LayerNorm: BERT's 1 + 2 x 2, and 12 encoders x (2 x 3 + 1);
# training adds one per encoder layer
SYNTHETIC_TINY = dataclasses.replace(
    MOVIESCOPE, preset="synthetic-tiny", flash=0, ln=1 + 2 * 2 + 12 * 7,
    ln_train=1 + 2 * 2 + 12 * 7 + 12 * 2, dropout=0)


def with_hybrid(path: ModelPath, layers: int) -> ModelPath:
    """``path`` with ``hybrid``: three self-attention encoders of max(layers,
    3) layers over reduced_dim = 32 positions add 3 x max(layers, 3) flash
    launches per forward (all with dropout in training: their rate is
    attn_dropout, 0.1 on every preset) and 3 x (2 x max(layers, 3) + 1)
    LayerNorms (one input, so none more in training)."""
    early = max(layers, 3)
    ln = 3 * (2 * early + 1)
    return dataclasses.replace(
        path, flash=path.flash + 3 * early, ln=path.ln + ln,
        ln_train=path.ln_train + ln, dropout=path.dropout + 3 * early,
        options=path.options + (("hybrid", True),))


# phase 16.  moviescope with hybrid: 96 flash launches (84 + 3 x 4), 208 /
# 256 LayerNorms, 48 with dropout; iemocap with hybrid: 132 (120 at head_dim
# 25), 376 / 472, 68.  moviescope with group_encoders: each pair's attention
# one call over the pair folded into the batch, 12 BERT + 3 x 4 + 3 x 4 x 2
# = 48 flash launches, 24 with dropout (BERT's 12, g_xl's 4, g_x2l's 8), the
# LayerNorms unchanged (one call per member).  Each is held to its base
# preset's limits, which both planted faults must still cross.
MOVIESCOPE_HYBRID = with_hybrid(MOVIESCOPE, 4)
IEMOCAP_HYBRID = with_hybrid(IEMOCAP, 8)
MOVIESCOPE_GROUPED = dataclasses.replace(
    MOVIESCOPE, flash=12 + 3 * 4 + 3 * 4 * 2, dropout=12 + 4 + 4 * 2,
    options=(("group_encoders", True),))
#: RAdam steps at A = 1: the adaptive (rectified) step starts at step 5
RADAM_STEPS = 6
#: (head_dim, heads) of each preset's encoders: the 32 x 32 sweep
HEAD_DIMS = ((25, 12), (30, 10), (64, 12), (96, 8), (128, 6))
#: bf16 accumulation at A = 2 against fp32: g1, g2 and their sum each round
#: to 8 significant bits (half a unit: at most 2**-8 of the value; the sum
#: is at most (|g1| + |g2|)(1 + 2**-8)), so after the 1/2 the bf16 gradient
#: is within 2**-8 (|g1| + |g2|)(1 + 2**-9) of the fp32 one, elementwise;
#: plus 1e-6 of each tensor's largest entry for the run to run differences
#: of BERT's embedding backward (atomics).  On an H100 (700 W) the sound
#: step reads 0.99 of this bound at its worst entry
BF16_ACCUM_ERR = 2.0 ** -8
BF16_ACCUM_SLACK = 1e-6


#: host seconds the run spent in its measurement machinery (kernel, plain
#: and library timings; profiler windows, and how many; waits for the
#: planted-fault builds), printed beside the phases' [time] lines
SPENT = collections.Counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Device time of one call: the median over ``reps`` groups of
    ``inner`` back-to-back calls, each group bracketed by CUDA events, over
    ``inner`` (so the events' own cost is spread thin).  The device is
    first held busy (``torch.cuda._sleep``) while the host enqueues every
    group, so host-side launch overhead never shows up as device time: for
    twice the median host time of a warm-up call (a first call's set-up,
    such as a library's plan, does not lengthen it), times the calls of
    the groups, between ``MIN_HOLD_S`` and ``MAX_HOLD_S`` (the sleep's
    cycles counted at ``CYCLES_PER_S``, above the card's boost clock, so
    the hold is never shorter).  Inputs stay warm in L2, as on the served
    path, where each kernel reads what the op before it just wrote.

    The defaults: 10 groups of 5 calls after 3 warm-up calls (20 groups
    of 10 after 5 before, ``EARLIER_TIMING``, whose holds and enqueues took
    159 s of a 1053 s run on an H100).  ``phase_timing_check`` reads both
    settings in turns at three kernels and prints how far their medians
    differ."""

    MIN_HOLD_S, MAX_HOLD_S = 0.01, 0.2
    CYCLES_PER_S = 2.0e9

    def __init__(self, torch):
        self.torch = torch

    def hold_cycles(self, per_call_s: float, calls: int) -> int:
        """The sleep, in cycles, that covers enqueueing ``calls`` calls of
        ``per_call_s`` host seconds each twice over."""
        hold = min(self.MAX_HOLD_S, max(self.MIN_HOLD_S,
                                        2.0 * per_call_s * calls))
        return int(hold * self.CYCLES_PER_S)

    def __call__(self, fn, reps: int = 10, inner: int = 5,
                 warmup: int = 3) -> float:
        torch = self.torch
        t0 = time.perf_counter()
        calls = []
        for _ in range(warmup):
            t = time.perf_counter()
            fn()
            calls.append(time.perf_counter() - t)
        per_call = statistics.median(calls) if warmup else self.MAX_HOLD_S
        torch.cuda.synchronize()
        torch.cuda._sleep(self.hold_cycles(per_call, reps * inner))
        events = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        SPENT["timing_s"] += time.perf_counter() - t0
        return statistics.median(s.elapsed_time(e)
                                 for s, e in events) / inner


#: the earlier timings (Timer's arguments), read beside the defaults by
#: ``phase_timing_check``
EARLIER_TIMING = dict(reps=20, inner=10, warmup=5)


def phase_timing_check(torch, timer, gen):
    """The kernel rows' timing at ``Timer``'s defaults against
    ``EARLIER_TIMING``, in turns (earlier, now, now, earlier), at
    moviescope's D 96 flash forward and backward class and a 4096 x 768
    LayerNorm: the two medians' ratio per kernel."""
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.norm import layer_norm
    q, k, v, _ = attention_inputs(torch, gen, BATCH, 8, 512, 512, 96, False)
    out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
    x = torch.randn(4096, 768, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.rand(768, generator=gen, device="cuda") + 0.5
    b = torch.randn(768, generator=gen, device="cuda")
    calls = {"flash forward": lambda: fa.flash_attention(q, k, v, True),
             "flash backward": lambda: fa._launch_bwd(
                 q, k, v, out, lse, out, True, None),
             "layer_norm": lambda: layer_norm(x, w, b, 1e-6,
                                              torch.bfloat16)}
    ratios = {}
    for name, fn in calls.items():
        earlier = [timer(fn, **EARLIER_TIMING)]
        now = [timer(fn), timer(fn)]
        earlier.append(timer(fn, **EARLIER_TIMING))
        ratios[name] = statistics.median(now) / statistics.median(earlier)
        print(f"[timing] {name}: {statistics.median(now):.4f} ms at the "
              f"defaults, {statistics.median(earlier):.4f} ms at "
              f"{EARLIER_TIMING} (ratio {ratios[name]:.4f})")
    return ratios


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def read_launches() -> dict:
    """The wrappers' launch counters: flash forward, those with dropout,
    flash backward, LayerNorm forward and backward."""
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    from bpx_torch.ops.norm import layer_norm, layer_norm_backward
    return dict(flash=flash_attention.launches,
                dropout=flash_attention.dropout_launches,
                flash_bwd=flash_attention_backward.launches,
                ln=layer_norm.launches, ln_bwd=layer_norm_backward.launches)


def zero_launches() -> None:
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    from bpx_torch.ops.norm import layer_norm, layer_norm_backward
    for c in (flash_attention, flash_attention_backward, layer_norm,
              layer_norm_backward):
        c.launches = 0
    flash_attention.dropout_launches = 0
    for c in (flash_attention, flash_attention_backward):
        c.generic_launches = 0
        c.chunked_launches = 0
        c.panel_launches = 0


#: the flash routes besides the tabled kernels that the counters split out
COUNTED_ROUTES = ("generic", "chunked", "panel")


def read_routes() -> dict:
    """The generic, the chunked and the panel kernels' shares of the flash
    launches: "generic", "generic_bwd", "chunked", "chunked_bwd", "panel",
    "panel_bwd"."""
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    return {f"{route}{kind}": getattr(c, f"{route}_launches")
            for route in COUNTED_ROUTES
            for kind, c in (("", flash_attention),
                            ("_bwd", flash_attention_backward))}


# ---------------------------------------------------------------------------
# the served forward's kernel launches, seen at each wrapper's launch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def wrapped_launch(module, wrap, name: str = "_launch"):
    """Route every kernel launch of ``module`` (its ``name(*args)``, the
    forward ``_launch`` or the backward ``_launch_bwd``) through
    ``wrap(launch, *args)`` inside the context."""
    launch = getattr(module, name)
    setattr(module, name, lambda *args: wrap(launch, *args))
    try:
        yield
    finally:
        setattr(module, name, launch)


def flash_class(q, k, masked, kv_lens, rate, seed):
    """(B, H, Tq, Tk, D, masked, has kv_lens, seed groups, dropout rate):
    the seed groups pick the kernel's build, one group's or several's."""
    from bpx_torch.ops.dropout import seed_list
    groups = len(seed_list(seed)) if rate > 0.0 else 1
    return (*q.shape[:3], k.shape[2], q.shape[3], masked,
            kv_lens is not None, groups, rate)


@contextlib.contextmanager
def recording():
    """Record the shape classes of every kernel launch (and every hash
    dropout) inside the context: a dict of Counters keyed by "flash",
    "flash_bwd", "ln", "ln_bwd" and "dropout"; and under "copies", by head
    dim, the tensors (q, k, v, dO, O) the flash wrappers had to copy
    before a launch; under "routes", the flash launches by (kind, route:
    ``kernel_route``'s "tabled", "panel", "generic" or "chunked")."""
    from bpx_torch.ops import dropout, flash_attention as fa, norm
    seen = {k: collections.Counter()
            for k in ("flash", "flash_bwd", "ln", "ln_bwd", "dropout",
                      "copies", "routes")}
    kernel_ready = fa._kernel_ready

    def ready(name, t, device, *route):
        got = kernel_ready(name, t, device, *route)
        seen["copies"][t.shape[3]] += got is not t
        return got

    def flash(launch, q, k, v, masked, kv_lens, rate=0.0, seed=None,
              place=None):
        seen["flash"][flash_class(q, k, masked, kv_lens, rate, seed)] += 1
        seen["routes"][("flash", fa.kernel_route(q.dtype, q.shape[3]))] += 1
        return launch(q, k, v, masked, kv_lens, rate, seed, place)

    def flash_bwd(launch, q, k, v, dout, lse, out, masked, kv_lens,
                  rate=0.0, seed=None, place=None):
        seen["flash_bwd"][flash_class(q, k, masked, kv_lens, rate,
                                      seed)] += 1
        seen["routes"][("flash_bwd",
                        fa.kernel_route(q.dtype, q.shape[3]))] += 1
        return launch(q, k, v, dout, lse, out, masked, kv_lens, rate, seed,
                      place)

    def ln(launch, x, w, b, eps, out_dtype):
        seen["ln"][(x.numel() // x.shape[-1], x.shape[-1], eps, x.dtype,
                    out_dtype)] += 1
        return launch(x, w, b, eps, out_dtype)

    def ln_bwd(launch, x, w, mu, rstd, dy):
        seen["ln_bwd"][(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                        dy.dtype)] += 1
        return launch(x, w, mu, rstd, dy)

    hash_dropout = dropout.hash_dropout

    def drop(x, rate, seed, axis=None, place=None):
        seen["dropout"][(tuple(x.shape), x.dtype, rate)] += 1
        return hash_dropout(x, rate, seed, axis, place)

    dropout.hash_dropout = drop
    fa._kernel_ready = ready
    try:
        with wrapped_launch(fa, flash), wrapped_launch(norm, ln), \
                wrapped_launch(fa, flash_bwd, "_launch_bwd"), \
                wrapped_launch(norm, ln_bwd, "_launch_bwd"):
            yield seen
    finally:
        dropout.hash_dropout = hash_dropout
        fa._kernel_ready = kernel_ready


def launch_classes(pred, batch):
    """Serve ``batch`` once and return, per kernel, a Counter of the
    launches' shape classes: (B, H, Tq, Tk, D, masked, has kv_lens, seed
    groups, rate)
    for the flash kernel, (rows, E, eps, in dtype, out dtype) for
    LayerNorm; and the wrappers' copies by head dim."""
    with recording() as seen:
        pred(batch)
    return seen["flash"], seen["ln"], seen["copies"]


# a flash kernel launched without part of its mask, to show that the
# whole-forward comparison with the plain path catches a wrong kernel
PLANTED_FAULTS = {
    "flash kernel ignores kv_lens":
        lambda launch, q, k, v, masked, kv_lens, *drop:
            launch(q, k, v, masked, None, *drop),
    "flash kernel ignores the band":
        lambda launch, q, k, v, masked, kv_lens, *drop:
            launch(q, k, v, False, kv_lens, *drop),
}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    from bpx_torch.ops import _cuda
    t0 = time.time()
    path = _cuda.build()
    _cuda.library()
    print(f"[build] {path.name} in {time.time() - t0:.1f} s")
    # ptxas' report, one line per kernel: registers, shared memory, spills
    name = spill = ""
    for line in _cuda.build_log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"[build] {name}: {line.split(':', 1)[1].strip()}; {spill}")
    import torch
    from bpx_torch.ops.flash_attention import (GENERIC_WIDTHS,
                                               KERNEL_HEAD_DIMS, PANEL_WIDTHS,
                                               blocks_per_sm)
    for d in KERNEL_HEAD_DIMS:
        print(f"[build] blocks per SM at head_dim {d} (occupancy "
              f"calculator): {blocks_per_sm(d)}")
    for w in PANEL_WIDTHS:
        print(f"[build] blocks per SM of the panel builds (chunks) at "
              f"head_dim {w - 1} (width {w}): {blocks_per_sm(w - 1)}")
    for w in GENERIC_WIDTHS:
        print(f"[build] blocks per SM of the generic kernels, fp32 at "
              f"head_dim {w - 1} (width {w}): "
              f"{blocks_per_sm(w - 1, torch.float32)}")
    for dt in (torch.bfloat16, torch.float32):
        print(f"[build] blocks per SM of the chunked kernels, {dt} (any "
              f"head_dim above 256): {blocks_per_sm(257, dt)}")
    check_ptxas_record(ptxas_table(_cuda.build_log))


def ptxas_table(log: str) -> dict:
    """{kernel: (registers, spill stores, spill loads)} of a build's ptxas
    report, the kernels named as ``kernel_name`` names them."""
    got, name, spill = {}, "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", spill)
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            got[name] = (regs, int(m.group(1)), int(m.group(2)))
    return got


#: the tabled flash kernels', the fp32 generic and the chunked ones'
#: (registers, spill stores, spill loads bytes) as the parent of the panel
#: builds (9a98b48) compiled them with the nvcc release below for sm_90a,
#: which a build must keep; a kernel of ``kernel_name``'s naming
PTXAS_RELEASE = "12.9"
PTXAS_RECORD = {
    "flash_bwd_dkdv_kernel<64, false>": (180, 0, 0),
    "flash_bwd_dkdv_kernel<64, true>": (182, 0, 0),
    "flash_bwd_dkdv_kernel<96, false>": (254, 0, 0),
    "flash_bwd_dkdv_kernel<96, true>": (253, 0, 0),
    "flash_bwd_dq_kernel<64, false>": (164, 0, 0),
    "flash_bwd_dq_kernel<64, true>": (166, 0, 0),
    "flash_bwd_dq_kernel<96, false>": (183, 0, 0),
    "flash_bwd_dq_kernel<96, true>": (184, 0, 0),
    "flash_bwd_keysplit_dq_kernel<192, false>": (144, 0, 0),
    "flash_bwd_keysplit_dq_kernel<192, true>": (144, 0, 0),
    "flash_bwd_keysplit_dq_kernel<256, false>": (156, 0, 0),
    "flash_bwd_keysplit_dq_kernel<256, true>": (160, 0, 0),
    "flash_bwd_narrow_dkdv_kernel<25, false>": (168, 0, 0),
    "flash_bwd_narrow_dkdv_kernel<25, true>": (168, 0, 0),
    "flash_bwd_narrow_dkdv_kernel<30, false>": (168, 0, 0),
    "flash_bwd_narrow_dkdv_kernel<30, true>": (168, 0, 0),
    "flash_bwd_narrow_dq_kernel<25, false>": (128, 60, 60),
    "flash_bwd_narrow_dq_kernel<25, true>": (128, 60, 60),
    "flash_bwd_narrow_dq_kernel<30, false>": (128, 68, 68),
    "flash_bwd_narrow_dq_kernel<30, true>": (128, 0, 0),
    "flash_bwd_rowsplit_dkdv_kernel<192, false>": (185, 0, 0),
    "flash_bwd_rowsplit_dkdv_kernel<192, true>": (185, 0, 0),
    "flash_bwd_rowsplit_dkdv_kernel<256, false>": (209, 0, 0),
    "flash_bwd_rowsplit_dkdv_kernel<256, true>": (213, 0, 0),
    "flash_bwd_wide_dkdv_kernel<128, false>": (230, 0, 0),
    "flash_bwd_wide_dkdv_kernel<128, true>": (230, 0, 0),
    "flash_bwd_wide_dkdv_kernel<50, false>": (168, 104, 112),
    "flash_bwd_wide_dkdv_kernel<50, true>": (168, 52, 52),
    "flash_bwd_wide_dkdv_kernel<60, false>": (168, 104, 112),
    "flash_bwd_wide_dkdv_kernel<60, true>": (168, 52, 52),
    "flash_bwd_wide_dq_kernel<128, false>": (223, 0, 0),
    "flash_bwd_wide_dq_kernel<128, true>": (224, 0, 0),
    "flash_bwd_wide_dq_kernel<50, false>": (168, 16, 16),
    "flash_bwd_wide_dq_kernel<50, true>": (168, 24, 24),
    "flash_bwd_wide_dq_kernel<60, false>": (166, 0, 0),
    "flash_bwd_wide_dq_kernel<60, true>": (167, 0, 0),
    "flash_chunked_delta_kernel<__nv_bfloat16>": (30, 0, 0),
    "flash_chunked_delta_kernel<float>": (29, 0, 0),
    "flash_chunked_dkdv_kernel<__nv_bfloat16, false>": (128, 0, 0),
    "flash_chunked_dkdv_kernel<__nv_bfloat16, true>": (127, 0, 0),
    "flash_chunked_dkdv_kernel<float, false>": (128, 0, 0),
    "flash_chunked_dkdv_kernel<float, true>": (128, 0, 0),
    "flash_chunked_dq_kernel<__nv_bfloat16, false>": (168, 0, 0),
    "flash_chunked_dq_kernel<__nv_bfloat16, true>": (168, 0, 0),
    "flash_chunked_dq_kernel<float, false>": (168, 0, 0),
    "flash_chunked_dq_kernel<float, true>": (168, 0, 0),
    "flash_chunked_fwd_kernel<__nv_bfloat16, false>": (168, 0, 0),
    "flash_chunked_fwd_kernel<__nv_bfloat16, true>": (168, 0, 0),
    "flash_chunked_fwd_kernel<float, false>": (168, 0, 0),
    "flash_chunked_fwd_kernel<float, true>": (168, 0, 0),
    "flash_delta_kernel<128>": (22, 0, 0),
    "flash_delta_kernel<192>": (26, 0, 0),
    "flash_delta_kernel<256>": (29, 0, 0),
    "flash_delta_kernel<25>": (18, 0, 0),
    "flash_delta_kernel<30>": (18, 0, 0),
    "flash_delta_kernel<50>": (17, 0, 0),
    "flash_delta_kernel<60>": (17, 0, 0),
    "flash_delta_kernel<64>": (22, 0, 0),
    "flash_delta_kernel<96>": (22, 0, 0),
    "flash_fwd_kernel<64, false>": (121, 0, 0),
    "flash_fwd_kernel<64, true>": (128, 0, 0),
    "flash_fwd_kernel<96, false>": (127, 0, 0),
    "flash_fwd_kernel<96, true>": (167, 0, 0),
    "flash_fwd_narrow_kernel<25, false>": (94, 0, 0),
    "flash_fwd_narrow_kernel<25, true>": (95, 0, 0),
    "flash_fwd_narrow_kernel<30, false>": (122, 0, 0),
    "flash_fwd_narrow_kernel<30, true>": (128, 0, 0),
    "flash_fwd_tall_kernel<192, false>": (227, 0, 0),
    "flash_fwd_tall_kernel<192, true>": (227, 0, 0),
    "flash_fwd_tall_kernel<256, false>": (240, 0, 0),
    "flash_fwd_tall_kernel<256, true>": (240, 0, 0),
    "flash_fwd_wide_kernel<128, false>": (157, 0, 0),
    "flash_fwd_wide_kernel<128, true>": (158, 0, 0),
    "flash_fwd_wide_kernel<50, false>": (157, 0, 0),
    "flash_fwd_wide_kernel<50, true>": (158, 0, 0),
    "flash_fwd_wide_kernel<60, false>": (157, 0, 0),
    "flash_fwd_wide_kernel<60, true>": (158, 0, 0),
    "flash_generic_delta_kernel<float>": (29, 0, 0),
    "flash_generic_dkdv_kernel<float, 128, false>": (128, 0, 0),
    "flash_generic_dkdv_kernel<float, 128, true>": (128, 0, 0),
    "flash_generic_dkdv_kernel<float, 256, false>": (210, 0, 0),
    "flash_generic_dkdv_kernel<float, 256, true>": (211, 0, 0),
    "flash_generic_dkdv_kernel<float, 32, false>": (127, 0, 0),
    "flash_generic_dkdv_kernel<float, 32, true>": (155, 0, 0),
    "flash_generic_dkdv_kernel<float, 64, false>": (166, 0, 0),
    "flash_generic_dkdv_kernel<float, 64, true>": (165, 0, 0),
    "flash_generic_dq_kernel<float, 128, false>": (167, 0, 0),
    "flash_generic_dq_kernel<float, 128, true>": (167, 0, 0),
    "flash_generic_dq_kernel<float, 256, false>": (245, 0, 0),
    "flash_generic_dq_kernel<float, 256, true>": (249, 0, 0),
    "flash_generic_dq_kernel<float, 32, false>": (126, 0, 0),
    "flash_generic_dq_kernel<float, 32, true>": (128, 0, 0),
    "flash_generic_dq_kernel<float, 64, false>": (168, 0, 0),
    "flash_generic_dq_kernel<float, 64, true>": (168, 0, 0),
    "flash_generic_fwd_kernel<float, 128, false>": (128, 0, 0),
    "flash_generic_fwd_kernel<float, 128, true>": (128, 0, 0),
    "flash_generic_fwd_kernel<float, 256, false>": (243, 0, 0),
    "flash_generic_fwd_kernel<float, 256, true>": (240, 0, 0),
    "flash_generic_fwd_kernel<float, 32, false>": (96, 0, 0),
    "flash_generic_fwd_kernel<float, 32, true>": (128, 0, 0),
    "flash_generic_fwd_kernel<float, 64, false>": (127, 0, 0),
    "flash_generic_fwd_kernel<float, 64, true>": (127, 0, 0),
}


def check_ptxas_record(table: dict) -> None:
    """The kernels of ``PTXAS_RECORD`` compile to the registers and spills
    recorded: a failure under the toolkit release of the record (another
    release may allocate otherwise, and is reported)."""
    release, record = PTXAS_RELEASE, PTXAS_RECORD
    from bpx_torch.ops import _cuda
    out = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                         text=True).stdout
    m = re.search(r"release (\S+),", out)
    here = m.group(1) if m else "?"
    missing = sorted(k for k in record if k not in table)
    moved = {k: (v, table[k]) for k, v in record.items()
             if k in table and table[k] != v}
    print(f"[build] ptxas against the record (nvcc {release}; this "
          f"build nvcc {here}): {len(record) - len(missing) - len(moved)} of "
          f"{len(record)} kernels keep their registers and spills; moved "
          f"{moved or 'none'}; missing {missing or 'none'}")
    if here == release:
        check(not missing and not moved,
              "a recorded kernel's registers or spills moved, or it is gone")


def kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<96>`` from a mangled kernel symbol: the length-
    prefixed identifier that ends in ``_kernel``, and its template
    arguments.  Of the prefixes that end at the same place (an anonymous
    namespace's hash may end in digits that read as a longer one), the
    shortest identifier."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            ident = mangled[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                end = m.end() + n
                # a shorter length-prefixed identifier ending here
                for d in re.finditer(r"\d+(?=[A-Za-z_])", ident):
                    if any(int(d.group()[j:]) == len(ident) - d.end()
                           for j in range(len(d.group()))):
                        ident = ident[d.end():]
                        break
                args = re.match(r"I(.*?)E+v", mangled[end:])
                if args is None:
                    return ident
                # type, int and bool template arguments: f,
                # 13__nv_bfloat16, Li64E, Lb0E
                targs = re.sub(r"^(f|13__nv_bfloat16)",
                               lambda t: ("float" if t[1] == "f"
                                          else t[1][2:]) + ", ",
                               args.group(1))
                targs = re.sub(r"Li(-?[0-9]+)E?", r"\1, ", targs)
                targs = re.sub(r"Lb([01])E?",
                               lambda b: ("false", "true")[int(b[1])] + ", ",
                               targs)
                return f"{ident}<{targs.rstrip(', ')}>"
    return mangled


def attention_inputs(torch, gen, B, H, Tq, Tk, D, padded, dtype=None,
                     empty_row=False):
    """q/k/v as the model hands them over: strided (B, H, T, D) views of
    (B, T, S, H, D) projection outputs in ``dtype`` (bf16), q pre-scaled;
    per-sample key lengths in [64, Tk] (one full row) when ``padded``, and
    with ``empty_row`` the last row's 0 (no visible key)."""
    bf = dtype or torch.bfloat16
    qbuf = torch.randn(B, Tq, 1, H, D, generator=gen, device="cuda")
    kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda")
    q = (qbuf[:, :, 0] * D ** -0.5).to(bf).transpose(1, 2)
    kv = kvbuf.to(bf)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    kv_lens = None
    if padded:
        lens = torch.randint(64, Tk + 1, (B,), generator=gen, device="cuda")
        lens[0] = Tk
        if empty_row:
            lens[-1] = 0
        kv_lens = lens.to(torch.int32)
    return q, k, v, kv_lens


def dtype_limits(torch, dtype):
    """(element bytes, peak flop rate, forward tolerance, gradient
    tolerance) of the flash rows at ``dtype`` (None: bf16)."""
    if dtype == torch.float32:
        return 4, PEAK_FP32_FLOPS, FLASH_TOL_FP32, FLASH_GRAD_TOL_FP32
    return 2, PEAK_BF16_FLOPS, FLASH_TOL, FLASH_GRAD_TOL


def by_rows(torch, fn, B, H, rows=None):
    """A plain version ``fn(b0, b1, place)`` over the whole batch: one
    call (place None), or with ``rows`` one call per ``rows`` batch rows,
    each placed at its rows ((b0, 0, H): its dropout blocks are the global
    call's), the outputs concatenated on the batch dim.  For classes whose
    plain version does not fit the card in one call (its fp32 scores and
    int64 mask indices take ~57 bytes a score)."""
    if rows is None or rows >= B:
        return fn(0, B, None)
    parts = [fn(b0, min(b0 + rows, B), (b0, 0, H))
             for b0 in range(0, B, rows)]
    return tuple(torch.cat(p) for p in zip(*parts))


def row_slice(t, b0, b1):
    """Rows b0..b1 of a batch-first tensor (None stays None)."""
    return None if t is None else t[b0:b1]


def attention_work(torch, B, H, Tq, Tk, masked, kv_lens):
    """(visible score entries, unpadded keys, the visible mask or None)
    of this run's data: the work the kernels cannot skip."""
    from bpx_torch.ops.flash_attention import effective_band
    from bpx_torch.ops.masks import band_allowed
    eff_masked, _ = effective_band(Tq, Tk, masked)
    ok = torch.ones(B, 1, Tq, Tk, dtype=torch.bool, device="cuda")
    if eff_masked:
        ok = ok & band_allowed(Tq, Tk, "cuda")
    if kv_lens is not None:
        col = torch.arange(Tk, device="cuda")
        ok = ok & (col[None, :] < kv_lens[:, None])[:, None, None, :]
    visible = ok.sum().item() * H
    keys = (kv_lens.sum().item() if kv_lens is not None else B * Tk) * H
    return visible, keys, (None if ok.all() else ok)


#: the plain versions' timing in the kernel rows: 3 groups of 2 calls
#: (they take 0.1-50 ms a call and are a yardstick of the arithmetic, not
#: of speed; on an H100 5 groups of 2 read within 0.3% of 20 groups of
#: 10)
PLAIN_TIMING = dict(reps=3, inner=2, warmup=1)


def phase_flash(torch, timer, classes, gen, label="flash",
                plain_rows=None, plain_timing=None, dtype=None,
                empty_row=False):
    """The forward kernel against its plain version at each class (with
    the class's dropout rate and seed groups, one fixed seed a group).
    ``plain_rows``: the plain version in placed chunks of that many batch
    rows (``by_rows``), timed with ``plain_timing``'s Timer arguments
    (default ``PLAIN_TIMING``).  ``dtype``: the inputs' (bf16), with its
    tolerance and bound (``dtype_limits``); ``empty_row``: a class with
    ``kv_lens`` gives its last row none."""
    import torch.nn.functional as F
    from bpx_torch.ops.flash_attention import (effective_band,
                                               flash_attention,
                                               flash_attention_reference)
    rows = []
    seed = 0x9E3779B9
    elem, peak, tol, _ = dtype_limits(torch, dtype)
    for (B, H, Tq, Tk, D, masked, padded, groups, rate), count in sorted(
            classes.items()):
        q, k, v, kv_lens = attention_inputs(torch, gen, B, H, Tq, Tk, D,
                                            padded, dtype, empty_row)
        drop = (rate, group_seeds(seed, groups) if rate else None)
        out, lse = flash_attention(q, k, v, masked, kv_lens, *drop,
                                   return_lse=True)
        check(plain_rows is None or groups == 1,
              "the plain version in row chunks takes one seed group")
        plain = lambda: by_rows(
            torch, lambda b0, b1, place: flash_attention_reference(
                q[b0:b1], k[b0:b1], v[b0:b1], masked,
                row_slice(kv_lens, b0, b1), *drop, place), B, H, plain_rows)
        ref, ref_lse = plain()
        again = flash_attention(q, k, v, masked, kv_lens, *drop)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"flash forward reruns differ at {(B, H, Tq, Tk, D, rate)}")
        err_o, err_l = max_err(out, ref), max_err(lse, ref_lse)
        check(torch.allclose(out.float(), ref.float(), **tol),
              f"flash O differs at {(B, H, Tq, Tk, D, rate)}: max err "
              f"{err_o}")
        check(torch.allclose(lse, ref_lse, **LSE_TOL),
              f"flash lse differs at {(B, H, Tq, Tk, D)}: max err {err_l}")

        visible, keys, ok = attention_work(torch, B, H, Tq, Tk, masked,
                                           kv_lens)
        # the function's own work: S and P V, 2 D flops each a visible score
        flops = 4.0 * D * visible
        redo = recompute_factor(D, q.dtype, 2, 2)
        nbytes = elem * (2 * B * H * Tq * D + 2 * keys * D) + 4 * B * H * Tq
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        t_k = timer(lambda: flash_attention(q, k, v, masked, kv_lens, *drop))
        t_p = timer(plain, **(plain_timing or PLAIN_TIMING))
        mask_args = sdpa_mask(torch, ok)
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate, scale=1.0, **mask_args)
        t_l = timer(sdpa)
        backend, first = sdpa_backend(torch, sdpa)
        kernel = fwd_kernel(D, groups, q.dtype)
        takes_kernel(torch, lambda: flash_attention(q, k, v, masked, kv_lens,
                                                    *drop),
                     kernel, (B, H, Tq, Tk, D, rate))
        eff_masked = effective_band(Tq, Tk, masked)[0]
        rows.append(dict(shape=[B * H, Tq, Tk, D], masked=eff_masked,
                         kv_lens=padded, rate=rate, seed_groups=groups,
                         dtype=str(q.dtype).split(".")[-1],
                         empty_row=bool(padded and empty_row),
                         per_forward=count, max_abs_err=err_o, lse_max_abs_err=err_l, ms=t_k,
                         plain_ms=t_p, library_ms=t_l,
                         library_backend=backend, library_kernel=first,
                         library_mask=mask_text(mask_args), kernel=kernel,
                         bound_ms=b_ms, bound_by=b_by, recompute=redo))
        print(f"[{label}] BH={B * H} {Tq}x{Tk} D={D} band={eff_masked} "
              f"kv_lens={padded} rate={rate} seed groups {groups} "
              f"{q.dtype} x{count}: {kernel} (work x{redo:.2f} the "
              f"function's); err O "
              f"{err_o:.3g} (tol {tol}) lse {err_l:.3g} (tol "
              f"{LSE_TOL}); "
              + timing_text(t_k, t_p, t_l, b_ms, b_by, f"sdpa ({backend})")
              + f"; sdpa {mask_text(mask_args)}, kernel {first}")
    return rows


def group_seeds(seed, groups):
    """A class's dropout seeds: ``seed`` for one group, else one a group."""
    return seed if groups == 1 else [seed + g for g in range(groups)]


def build_args(D, groups) -> str:
    """A flash kernel's template arguments as the profiler names them: the
    head dim, and whether it is the build for several seed groups."""
    return f"<{D}, {'true' if groups > 1 else 'false'}>"


def generic_args(D, groups, dtype) -> str:
    """A generic kernel's template arguments as the profiler names them:
    the element type, the build's width and whether it is the build for
    several seed groups."""
    import torch
    from bpx_torch.ops.flash_attention import generic_width
    name = "float" if dtype == torch.float32 else "__nv_bfloat16"
    return (f"<{name}, {generic_width(D)}, "
            f"{'true' if groups > 1 else 'false'}>")


#: a panel build's template head dim: these plus its width
#: (``kPanelChunks``, ``kPanelWords`` in ``csrc/flash_common.cuh``)
PANEL_CHUNKS = 1000
PANEL_WORDS = 2000


def panel_args(D, words=None) -> str:
    """A panel build's template arguments as the profiler names them: the
    build (``PANEL_CHUNKS`` plus D's panel width for 16-byte chunks,
    ``PANEL_WORDS`` plus it for words; ``attention_inputs``' views and the
    models' fused projections load in chunks exactly where D is a multiple
    of 8, unless ``words`` says otherwise) and ``true``: every panel build
    is the one for seed groups."""
    from bpx_torch.ops.flash_attention import panel_width
    if words is None:
        words = D % 8 != 0
    return f"<{(PANEL_WORDS if words else PANEL_CHUNKS) + panel_width(D)}, true>"


def route_of(D, dtype) -> str:
    """The kernels a call at head_dim D and ``dtype`` (None: bf16) takes:
    ``kernel_route``'s "tabled", "panel", "generic" or "chunked" (every D
    above 256)."""
    import torch
    from bpx_torch.ops.flash_attention import kernel_route
    return kernel_route(dtype or torch.bfloat16, D)


def chunked_args(groups, dtype) -> str:
    """A chunked kernel's template arguments as the profiler names them:
    the element type and whether it is the build for several seed
    groups."""
    import torch
    name = "float" if dtype == torch.float32 else "__nv_bfloat16"
    return f"<{name}, {'true' if groups > 1 else 'false'}>"


def recompute_factor(D, dtype, scores, rest) -> float:
    """The flops the kernels at head_dim D and ``dtype`` do over the
    function's own: 1, but on the chunked route, whose blocks rebuild the
    score products (``scores`` flops a visible score a head-dim column: S's
    2, and dP's 2 more in the backward) once for each column chunk
    (``column_chunks``) and do the ``rest`` once.  Printed beside the
    bound, which counts the function's work alone."""
    from bpx_torch.ops.flash_attention import column_chunks
    n = column_chunks(D) if route_of(D, dtype) == "chunked" else 1
    return (scores * n + rest) / (scores + rest)


def fwd_kernel(D, groups=1, dtype=None) -> str:
    """The forward's kernel at head_dim D for ``groups`` seed groups and
    ``dtype`` (None: bf16), by the name the profiler reports."""
    route = route_of(D, dtype)
    if route == "chunked":
        return "flash_chunked_fwd_kernel" + chunked_args(groups, dtype)
    if route == "generic":
        return "flash_generic_fwd_kernel" + generic_args(D, groups, dtype)
    if route == "panel":
        from bpx_torch.ops.flash_attention import panel_width
        w = panel_width(D)
        name = ("flash_fwd_narrow_kernel" if w == 32 else
                "flash_fwd_wide_kernel" if w <= 128 else
                "flash_fwd_tall_kernel")
        return name + panel_args(D)
    if D < 32:
        name = "flash_fwd_narrow_kernel"
    elif D in (50, 60, 128):
        name = "flash_fwd_wide_kernel"
    elif D in (192, 256):
        name = "flash_fwd_tall_kernel"
    else:
        name = "flash_fwd_kernel"
    return name + build_args(D, groups)


def sdpa_mask(torch, ok) -> dict:
    """SDPA's mask arguments for the visible mask ``ok`` ((B, 1, Tq, Tk)
    bool, None where every key is visible): ``is_causal`` where it is
    exactly the causal triangle, since SDPA's flash backend takes no
    ``attn_mask``; else the mask itself."""
    if ok is not None and ok.shape[-1] == ok.shape[-2]:
        tri = torch.ones(ok.shape[-2:], dtype=torch.bool,
                         device=ok.device).tril()
        if torch.equal(ok, tri.expand_as(ok)):
            return dict(is_causal=True)
    return dict(attn_mask=ok)


def mask_text(mask_args) -> str:
    """How ``sdpa_mask``'s arguments hand SDPA the mask, for the log."""
    if mask_args.get("is_causal"):
        return "is_causal"
    return "no mask" if mask_args["attn_mask"] is None else "attn_mask"


def sdpa_backend(torch, fn):
    """(backend, kernel) of SDPA's call ``fn``: which backend ran it, from
    the device kernels the profiler names (cuDNN first, since a cuDNN
    attention kernel's name may hold "flash"; then flash, memory-efficient
    (cutlass fmha), else the math path), and the first kernel name that
    told it (the first of all for the math path)."""
    seen = list(device_kernels(torch, fn, n=2))
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("mem_eff", "efficient")):
        hits = [k for k in seen if key in k.lower()]
        if hits:
            return backend, hits[0]
    return "math", seen[0] if seen else "-"


def phase_layer_norm(torch, timer, classes, gen, scalar_path=True):
    import torch.nn.functional as F
    from bpx_torch.ops.norm import layer_norm, layer_norm_reference
    rows = []
    for (n, e, eps, dt, out_dt), count in sorted(classes.items(), key=str):
        x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(dt)
        w = torch.rand(e, generator=gen, device="cuda") + 0.5
        b = torch.randn(e, generator=gen, device="cuda")
        y, mu, rstd = layer_norm(x, w, b, eps, out_dt, return_stats=True)
        ry, rmu, rrstd = layer_norm_reference(x, w, b, eps, out_dt)
        torch.cuda.synchronize()
        err = max_err(y, ry)
        check(torch.allclose(y.float(), ry.float(), **LN_TOL),
              f"layer_norm differs at {(n, e, eps)}: max err {err}")
        check(torch.allclose(mu, rmu, **LN_STAT_TOL)
              and torch.allclose(rstd, rrstd, **LN_STAT_TOL),
              f"layer_norm statistics differ at {(n, e, eps)}")
        nbytes = n * e * (x.element_size() + y.element_size()) \
            + 2 * e * 4 + 2 * n * 4
        b_ms, b_by = bound_ms(nbytes, 8.0 * n * e)
        t_k = timer(lambda: layer_norm(x, w, b, eps, out_dt))
        t_p = timer(lambda: layer_norm_reference(x, w, b, eps, out_dt))
        t_l = timer(lambda: F.layer_norm(x, (e,), w.to(dt), b.to(dt), eps))
        split = one_kernel_per_call(
            torch, lambda: layer_norm(x, w, b, eps, out_dt), "layer_norm",
            (n, e))
        rows.append(dict(shape=[n, e], eps=eps, dtype=str(dt),
                         out_dtype=str(out_dt), per_forward=count,
                         max_abs_err=err, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b_ms, bound_by=b_by,
                         kernel_split_ms=split))
        print(f"[layer_norm] ({n}, {e}) eps={eps:g} {dt} -> {out_dt} "
              f"x{count}/fwd: err {err:.3g} (tol {LN_TOL}); "
              + timing_text(t_k, t_p, t_l, b_ms, b_by, "F.layer_norm")
              + "; profiler: " + split_text(split))
    if not scalar_path:
        return rows
    # the scalar path once, too: a view 2 elements into its buffer is not
    # 16-byte aligned, and the profiler must name the scalar kernel
    x = misaligned_view(torch, gen, 133, 768)
    w = torch.rand(768, generator=gen, device="cuda") + 0.5
    b = torch.randn(768, generator=gen, device="cuda")
    y, mu, rstd = layer_norm(x, w, b, 1e-6, torch.float32, return_stats=True)
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-6, torch.float32)
    check(torch.allclose(y, ry, atol=1e-4, rtol=1e-4)
          and torch.allclose(mu, rmu, **LN_STAT_TOL)
          and torch.allclose(rstd, rrstd, **LN_STAT_TOL),
          f"layer_norm scalar path differs: {max_err(y, ry)}")
    takes_kernel(torch, lambda: layer_norm(x, w, b, 1e-6, torch.float32),
                 "layer_norm_scalar_kernel")
    return rows


def misaligned_view(torch, gen, n, e):
    """A bf16 (n, e) view 2 elements into its buffer: not 16-byte aligned,
    so the LayerNorm kernels take their scalar paths."""
    buf = torch.randn(n * e + 2, generator=gen, device="cuda")
    return (buf * 3 + 1).to(torch.bfloat16)[2:].view(n, e)


def takes_kernel(torch, fn, kernel, where="a misaligned view"):
    """Fails unless one call of ``fn`` runs one device kernel, ``kernel``."""
    split = one_kernel_per_call(torch, fn, kernel, where)
    check(all(kernel in k for k in split),
          f"expected {kernel}, the profiler saw {sorted(split)}")


def timing_text(t_k, t_p, t_l, b_ms, b_by, library) -> str:
    """A kernel row's times, its share of the bound and its ratio to the
    library call."""
    return (f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, {library} {t_l:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}); {b_ms / t_k:.1%} of the "
            f"bound, {t_k / t_l:.2f}x {library}")


def grad_err(got, want) -> float:
    """max |got - want| over the largest |want|: the gradients' error
    relative to their scale."""
    return max_err(got, want) / max(want.float().abs().max().item(), 1e-30)


def flash_bwd_work(torch, B, H, Tq, Tk, D, masked, kv_lens, elem=2):
    """(bytes, flops, SDPA's mask) of the whole backward: q, k, v, dO, O and
    lse read and dq, dk, dv written once (``elem`` bytes an element);
    delta's 2 D and the five products' 10 D flops per visible score
    entry."""
    visible, keys, ok = attention_work(torch, B, H, Tq, Tk, masked, kv_lens)
    flops = 10.0 * D * visible + 2.0 * D * B * H * Tq
    nbytes = (elem * D * (4 * B * H * Tq + 2 * keys + 2 * B * H * Tk)
              + 4 * B * H * Tq)
    return nbytes, flops, ok


def sdpa_backward(torch, q, k, v, mask_args, rate, dout):
    """SDPA's backward alone (its forward runs once) on the same inputs,
    with the mask arguments ``sdpa_mask`` gives: the library yardstick."""
    import torch.nn.functional as F
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, dropout_p=rate,
                                         scale=1.0, **mask_args)
    return lambda: torch.autograd.grad(out, (ql, kl, vl), dout,
                                       retain_graph=True)


def bwd_kernels(D, groups=1, dtype=None):
    """The backward's kernels at head_dim D for ``groups`` seed groups and
    ``dtype`` (None: bf16), by the names the profiler reports, as (dQ,
    dK/dV, delta or None): on the panel, generic and chunked routes and at
    every tabled head dim but 64 and 96 the dQ kernel computes delta
    itself, so the backward is two launches (the narrow kernels at 25 and
    30, the wide ones at 50, 60 and 128, the key- and row-split ones at 192
    and 256; the panel builds of the same at panel widths 32, 64 and 128,
    192 and 256); at 64 and 96 the delta kernel, then dK/dV and dQ."""
    route = route_of(D, dtype)
    if route == "chunked":
        args = chunked_args(groups, dtype)
        return ("flash_chunked_dq_kernel" + args,
                "flash_chunked_dkdv_kernel" + args, None)
    if route == "generic":
        args = generic_args(D, groups, dtype)
        return ("flash_generic_dq_kernel" + args,
                "flash_generic_dkdv_kernel" + args, None)
    if route == "panel":
        from bpx_torch.ops.flash_attention import panel_width
        w, args = panel_width(D), panel_args(D)
        kind = ("narrow", "narrow") if w == 32 else \
            ("wide", "wide") if w <= 128 else ("keysplit", "rowsplit")
        return (f"flash_bwd_{kind[0]}_dq_kernel" + args,
                f"flash_bwd_{kind[1]}_dkdv_kernel" + args, None)
    args = build_args(D, groups)
    if D < 32:
        return ("flash_bwd_narrow_dq_kernel" + args,
                "flash_bwd_narrow_dkdv_kernel" + args, None)
    if D in (50, 60, 128):
        return ("flash_bwd_wide_dq_kernel" + args,
                "flash_bwd_wide_dkdv_kernel" + args, None)
    if D in (192, 256):
        return ("flash_bwd_keysplit_dq_kernel" + args,
                "flash_bwd_rowsplit_dkdv_kernel" + args, None)
    return ("flash_bwd_dq_kernel" + args, "flash_bwd_dkdv_kernel" + args,
            "flash_delta_kernel")


def kernel_names(kernels) -> list:
    """The names of ``bwd_kernels``' entries, None (no delta kernel) left
    out."""
    return [k for k in kernels if k]


def backward_split(torch, fn, D, groups=1, dtype=None):
    """{kernel: device ms per call} of one backward call ``fn`` at head
    dim D, ``groups`` seed groups and ``dtype``, its kernels by their
    profiler names (``bwd_kernels``)."""
    return kernel_ms(torch, fn, kernel_names(bwd_kernels(D, groups, dtype)))


def phase_flash_bwd(torch, timer, classes, gen, label="flash_bwd",
                    plain_rows=None, plain_timing=None, dtype=None,
                    empty_row=False):
    """The backward kernels (``bwd_kernels``: at head_dim 64 and 96 delta,
    dK/dV, dQ; at the others the dQ kernel with delta, then dK/dV) against
    the plain backward at each class of the recorded micro-step (its
    dropout rate and seed groups, one fixed seed a group), from the kernel
    forward's lse; the delta kernel on its own against its plain version.
    The profiler must see each of the class's kernels, of the build for
    its seed groups.  ``plain_rows``, ``plain_timing``, ``dtype``,
    ``empty_row``: as :func:`phase_flash`'s."""
    from bpx_torch.ops import flash_attention as fa
    rows = []
    seed = 0x7F4A7C15
    elem, peak, _, grad_tol = dtype_limits(torch, dtype)
    for (B, H, Tq, Tk, D, masked, padded, groups, rate), count in sorted(
            classes.items()):
        q, k, v, kv_lens = attention_inputs(torch, gen, B, H, Tq, Tk, D,
                                            padded, dtype, empty_row)
        drop = (rate, group_seeds(seed, groups) if rate else None)
        out, lse = fa.flash_attention(q, k, v, masked, kv_lens, *drop,
                                      return_lse=True)
        # dO as the model hands it over: a (B, H, T, D) view of (B, T, H, D)
        dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
            q.dtype).transpose(1, 2)
        delta = fa.attention_delta(dout, out)
        want_delta = fa.attention_delta_reference(dout, out)
        got = fa._launch_bwd(q, k, v, dout, lse, out, masked, kv_lens, *drop)
        check(plain_rows is None or groups == 1,
              "the plain version in row chunks takes one seed group")
        plain = lambda: by_rows(
            torch, lambda b0, b1, place: fa.flash_attention_backward_reference(
                q[b0:b1], k[b0:b1], v[b0:b1], dout[b0:b1], lse[b0:b1],
                fa.attention_delta_reference(dout[b0:b1], out[b0:b1]),
                masked, row_slice(kv_lens, b0, b1), *drop, place),
            B, H, plain_rows)
        want = plain()
        torch.cuda.synchronize()
        err_d = max_err(delta, want_delta)
        check(torch.allclose(delta, want_delta, **DELTA_TOL),
              f"flash delta differs at {(B, H, Tq, D)}: max err {err_d}")
        errs = [grad_err(g, w) for g, w in zip(got, want)]
        check(max(errs) <= grad_tol,
              f"flash backward differs at {(B, H, Tq, Tk, D, rate)}: "
              f"dq/dk/dv relative errors {errs}")

        nbytes, flops, ok = flash_bwd_work(torch, B, H, Tq, Tk, D, masked,
                                           kv_lens, elem)
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        t_k = timer(lambda: fa._launch_bwd(q, k, v, dout, lse, out, masked,
                                           kv_lens, *drop))
        t_p = timer(plain, **(plain_timing or PLAIN_TIMING))
        mask_args = sdpa_mask(torch, ok)
        sdpa = sdpa_backward(torch, q, k, v, mask_args, rate, dout)
        t_l = timer(sdpa)
        backend, first = sdpa_backend(torch, sdpa)
        split = backward_split(torch, lambda: fa._launch_bwd(
            q, k, v, dout, lse, out, masked, kv_lens, *drop), D, groups,
            q.dtype)
        check(all(split.values()),
              f"flash backward at {(B, H, Tq, Tk, D, rate)}, {groups} seed "
              f"groups: the profiler did not see each of {sorted(split)}")
        dq_b, dkdv_b = split_bounds(torch, B, H, Tq, Tk, D, masked, kv_lens,
                                    q.dtype)
        again = fa._launch_bwd(q, k, v, dout, lse, out, masked, kv_lens,
                               *drop)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"flash backward reruns differ at {(B, H, Tq, Tk, D, rate)}")
        eff_masked = fa.effective_band(Tq, Tk, masked)[0]
        launches = ("dQ (with delta) + dK/dV"
                    if bwd_kernels(D, 1, q.dtype)[2] is None
                    else "delta + dK/dV + dQ")
        rows.append(dict(shape=[B * H, Tq, Tk, D], masked=eff_masked,
                         kv_lens=padded, rate=rate, seed_groups=groups,
                         dtype=str(q.dtype).split(".")[-1],
                         empty_row=bool(padded and empty_row),
                         per_forward=count,
                         max_abs_err=max(max_err(g, w)
                                         for g, w in zip(got, want)),
                         rel_err=max(errs), delta_max_abs_err=err_d,
                         ms=t_k, plain_ms=t_p, library_ms=t_l,
                         library_backend=backend, library_kernel=first,
                         library_mask=mask_text(mask_args),
                         bound_ms=b_ms, bound_by=b_by, kernel_split_ms=split,
                         dq_bound_ms=dq_b[0], dkdv_bound_ms=dkdv_b[0],
                         dq_bound_by=dq_b[1], dkdv_bound_by=dkdv_b[1],
                         recompute=recompute_factor(D, q.dtype, 4, 6),
                         dq_recompute=recompute_factor(D, q.dtype, 4, 2),
                         dkdv_recompute=recompute_factor(D, q.dtype, 4, 4)))
        print(f"[{label}] BH={B * H} {Tq}x{Tk} D={D} band={eff_masked} "
              f"kv_lens={padded} rate={rate} seed groups {groups} "
              f"{q.dtype} x{count}/micro-step: "
              f"dq/dk/dv rel err {max(errs):.3g} (tol {grad_tol}), "
              f"delta err {err_d:.3g} (tol {DELTA_TOL}), reruns bitwise "
              f"equal; {launches} (work x{rows[-1]['recompute']:.2f} the "
              f"function's) "
              + timing_text(t_k, t_p, t_l, b_ms, b_by,
                            f"sdpa bwd ({backend})")
              + f"; sdpa {mask_text(mask_args)}, kernel {first}; "
              f"profiler: " + ", ".join(f"{n} {t:.4f} ms"
                                           for n, t in split.items())
              + f" (dQ bound {dq_b[0]:.4f} ms, dK/dV bound {dkdv_b[0]:.4f} "
              f"ms)")
    return rows


def phase_layer_norm_bwd(torch, timer, classes, gen, scalar_path=True):
    import torch.nn.functional as F
    from bpx_torch.ops import norm
    rows = []
    for (n, e, dt, dy_dt), count in sorted(classes.items(), key=str):
        x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(dt)
        w = torch.rand(e, generator=gen, device="cuda") + 0.5
        b = torch.randn(e, generator=gen, device="cuda")
        _, mu, rstd = norm.layer_norm(x, w, b, 1e-6, return_stats=True)
        dy = torch.randn(n, e, generator=gen, device="cuda").to(dy_dt)
        got = norm._launch_bwd(x, w, mu, rstd, dy)
        want = norm.layer_norm_backward_reference(x, w, mu, rstd, dy)
        torch.cuda.synchronize()
        err = max_err(got[0], want[0])
        perr = max(grad_err(g, r) for g, r in zip(got[1:], want[1:]))
        check(torch.allclose(got[0].float(), want[0].float(), **LN_TOL),
              f"layer_norm dx differs at {(n, e)}: max err {err}")
        check(perr <= LN_PARAM_GRAD_TOL,
              f"layer_norm dw/db differ at {(n, e)}: rel err {perr}")
        nbytes = (n * e * (2 * x.element_size() + dy.element_size())
                  + 3 * e * 4 + 2 * n * 4)
        b_ms, b_by = bound_ms(nbytes, 12.0 * n * e)
        again = norm._launch_bwd(x, w, mu, rstd, dy)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"layer_norm backward reruns differ at {(n, e)}")
        t_k = timer(lambda: norm._launch_bwd(x, w, mu, rstd, dy))
        t_p = timer(lambda: norm.layer_norm_backward_reference(
            x, w, mu, rstd, dy))
        xl, wl, bl = (t.detach().requires_grad_(True)
                      for t in (x, w.to(dt), b.to(dt)))
        y = F.layer_norm(xl, (e,), wl, bl, 1e-6)
        t_l = timer(lambda: torch.autograd.grad(y, (xl, wl, bl),
                                                dy.to(y.dtype),
                                                retain_graph=True))
        split = one_kernel_per_call(
            torch, lambda: norm._launch_bwd(x, w, mu, rstd, dy),
            "layer_norm backward", (n, e))
        kernel = ln_bwd_kernel(e)
        check(all(re.fullmatch(kernel, k) for k in split),
              f"layer_norm backward at {(n, e)}: expected {kernel}, the "
              f"profiler saw {sorted(split)}")
        rows.append(dict(shape=[n, e], dtype=str(dt), dy_dtype=str(dy_dt),
                         per_forward=count, max_abs_err=err,
                         param_rel_err=perr, kernel=kernel,
                         ms=t_k, plain_ms=t_p, library_ms=t_l,
                         bound_ms=b_ms, bound_by=b_by, kernel_split_ms=split))
        print(f"[layer_norm_bwd] ({n}, {e}) {dt}, dy {dy_dt} x{count}/"
              f"micro-step: dx err {err:.3g} (tol {LN_TOL}), dw/db rel err "
              f"{perr:.3g} (tol {LN_PARAM_GRAD_TOL}), reruns bitwise equal; "
              + timing_text(t_k, t_p, t_l, b_ms, b_by, "F.layer_norm bwd")
              + "; profiler: " + split_text(split))
    if scalar_path:
        ln_bwd_scalar_view(torch, gen, 133, 768)
    return rows


def ln_bwd_kernel(e) -> str:
    """A pattern of the name the profiler reports for the LayerNorm
    backward's kernel on an aligned row of width e (``bwd_plan`` in
    ``csrc/layer_norm_common.cuh``): the vector kernel with a warp a row
    (its last template argument 1) up to 1024, with two warps a row up to
    1536, else the scalar kernel."""
    if e % 4 == 0 and e <= 1536:
        return rf"ln_bwd_vec_kernel<.*, {1 if e <= 1024 else 2}>"
    return r"ln_bwd_scalar_kernel<.*>"


def ln_bwd_scalar_view(torch, gen, n, e):
    """The LayerNorm backward on misaligned (n, e) views against its plain
    version: the profiler must name the scalar kernel."""
    from bpx_torch.ops import norm
    x, dy = (misaligned_view(torch, gen, n, e) for _ in range(2))
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    _, mu, rstd = norm.layer_norm(x, w, torch.zeros_like(w), 1e-6,
                                  return_stats=True)
    got = norm._launch_bwd(x, w, mu, rstd, dy)
    want = norm.layer_norm_backward_reference(x, w, mu, rstd, dy)
    perr = max(grad_err(g, r) for g, r in zip(got[1:], want[1:]))
    check(torch.allclose(got[0].float(), want[0].float(), **LN_TOL)
          and perr <= LN_PARAM_GRAD_TOL,
          f"layer_norm backward scalar path differs at {(n, e)}: dx "
          f"{max_err(got[0], want[0])}, dw/db {perr}")
    takes_kernel(torch, lambda: norm._launch_bwd(x, w, mu, rstd, dy),
                 "ln_bwd_scalar_kernel", f"a misaligned {(n, e)} view")


#: device kernels per LayerNorm call, forward or backward (the backward's
#: rows, grid barrier and dw/db reduction are one cooperative launch)
LN_KERNELS_PER_CALL = 1


def one_kernel_per_call(torch, fn, what, shape):
    """The profiler's device activities per call of ``fn``; fails unless
    there is exactly LN_KERNELS_PER_CALL of them and none is a memset or a
    fill."""
    split = device_kernels(torch, fn)
    calls = sum(c for c, _ in split.values())
    check(calls == LN_KERNELS_PER_CALL
          and not any("memset" in k.lower() or "fill" in k.lower()
                      for k in split),
          f"{what} at {shape} ran {calls} device kernels per call "
          f"({sorted(split)}), expected {LN_KERNELS_PER_CALL} and no memset")
    return {k: ms for k, (_, ms) in split.items()}


def split_text(split) -> str:
    return (f"{len(split)} device kernel(s) per call: "
            + ", ".join(f"{k} {ms:.4f} ms" for k, ms in split.items()))


def phase_dropout_hash(torch, timer, classes, gen):
    """The plain hash dropout (no kernel: XLA computes it outside Pallas in
    the JAX package) timed at the recorded micro-step's classes, forward
    and the mask regeneration of the backward; a candidate for a kernel."""
    from bpx_torch.ops.dropout import _HashDropout
    total = 0.0
    for (shape, dt, rate), count in sorted(classes.items(), key=str):
        x = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        g = torch.randn(*shape, generator=gen, device="cuda").to(dt)
        seeds = (12345,)
        ctx = type("Ctx", (), dict(saved_tensors=(None,), rate=rate,
                                   seeds=seeds, place=None))()
        t_f = timer(lambda: _HashDropout.forward(x, None, rate, seeds, None),
                    reps=5, inner=4)
        t_b = timer(lambda: _HashDropout.backward(ctx, g), reps=5, inner=4)
        total += count * (t_f + t_b)
        print(f"[dropout] {tuple(shape)} {dt} rate={rate} x{count}/"
              f"micro-step: forward {t_f:.4f} ms, backward {t_b:.4f} ms")
    print(f"[dropout] plain hash dropout per micro-step: {total:.2f} ms")
    return total


def kernel_mask(torch, q, k, rate, seed, place=None):
    """The keep bits (B, H, T, T) the forward and the backward kernels
    apply with ``seed`` (a uint32, or one per group of the batch) and the
    block placement ``place`` (b_off, h_off, H_g; None unplaced), read
    with q = 0 and one-hot V = dO as ``phase_mask_check`` says, and
    whether every O equalled the plain version's."""
    from bpx_torch.ops import flash_attention as fa
    B, H, T, D = q.shape
    bf = q.dtype
    fwd = torch.zeros(B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    same = True
    for r in range((T + D - 1) // D):
        c = j - D * r
        sel = (c >= 0) & (c < D)
        onehot = torch.zeros(T, D, device="cuda", dtype=bf)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(B, H, T, D)
        out, lse = fa.flash_attention(q, k, e, False, None, rate, seed,
                                      return_lse=True, place=place)
        ref, _ = fa.flash_attention_reference(q, k, e, False, None, rate,
                                              seed, place)
        _, _, dv = fa._launch_bwd(q, k, e, e, lse, out, False, None, rate,
                                  seed, place)
        same = same and torch.equal(out, ref)
        fwd[..., sel] = out[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    return fwd, bwd, same


def phase_mask_check(torch, gen, B, H, T, D, dtype=None, place=None):
    """Exact mask check: q = 0 makes every probability 1/T, so with V_r[j,
    c] = [j == D r + c] column c of O is the keep bit of key D r + c times
    bf16(inv_keep)/T, and with dO = V_r row j of dV holds the bits of query
    D r + c at key j; ceil(T / D) rounds (one, V = I, when D = T) cover
    every (query, key), every key visible.  Compared with the plain
    version's mask for equality (a tolerance on O would not see a few wrong
    bits), and O with the plain version's O.  ``dtype``: the inputs'
    (bf16); ``place``: the call's block placement, its bits then the
    global call's at its blocks."""
    from bpx_torch.ops import flash_attention as fa
    rate, seed = 0.1, 0xDEADBEEF
    bf = dtype or torch.bfloat16
    q = torch.zeros(B, H, T, D, device="cuda", dtype=bf)
    k = torch.randn(B, H, T, D, generator=gen, device="cuda").to(bf)
    fwd, bwd, same = kernel_mask(torch, q, k, rate, seed, place)
    keep = fa.keep_mask(seed, B, H, T, T, rate, "cuda", place)
    torch.cuda.synchronize()
    bad_f = int((fwd != keep).sum())
    bad_b = int((bwd != keep).sum())
    print(f"[mask] D={D} {bf} at ({B}, {H}, {T}, {T}), placed {place}, "
          f"{(T + D - 1) // D} "
          f"round(s): forward mask bits differing from the plain version's: "
          f"{bad_f} of {keep.numel()}; backward (dV): {bad_b}; kept "
          f"{keep.float().mean().item():.4f} (1 - rate = {1 - rate})")
    check(bad_f == 0 and bad_b == 0 and same,
          f"the kernels' dropout mask at head_dim {D} differs from the "
          f"plain version's")


def phase_seed_masks(torch, gen, S, B, H, T, D):
    """The multi-seed step's folded launches' masks, exactly: one launch
    over S groups of B batch rows with one seed each, read as
    ``phase_mask_check`` reads them, must give each group the bits of a
    launch over that group alone with its seed, forward and backward,
    and the plain version's bits for the seed list."""
    from bpx_torch.ops import flash_attention as fa
    rate = 0.1
    seeds = [0xDEADBEEF + 7919 * s for s in range(S)]
    bf = torch.bfloat16
    q = torch.zeros(S * B, H, T, D, device="cuda", dtype=bf)
    k = torch.randn(S * B, H, T, D, generator=gen, device="cuda").to(bf)
    fwd, bwd, same = kernel_mask(torch, q, k, rate, seeds)
    bad = collections.Counter()
    for s, seed in enumerate(seeds):
        rows = slice(s * B, (s + 1) * B)
        f1, b1, same1 = kernel_mask(torch, q[rows], k[rows], rate, seed)
        same = same and same1
        bad["forward"] += int((fwd[rows] != f1).sum())
        bad["backward"] += int((bwd[rows] != b1).sum())
    keep = fa.keep_mask(seeds, S * B, H, T, T, rate, "cuda")
    bad["plain"] = int((fwd != keep).sum()) + int((bwd != keep).sum())
    # the folded mask differs from one seed's for the whole fold
    bad_one = int((fa.keep_mask(seeds[0], S * B, H, T, T, rate, "cuda")
                   != keep).sum())
    torch.cuda.synchronize()
    print(f"[seed masks] D={D}, {S} groups of ({B}, {H}, {T}, {T}): bits "
          f"differing from each group's own launch: forward "
          f"{bad['forward']}, backward (dV) {bad['backward']}; from the "
          f"plain version's {bad['plain']} of {2 * keep.numel()}; one seed "
          f"over the fold would differ in {bad_one}")
    check(not any(bad.values()) and same and bad_one > 0,
          f"the folded launch's masks at head_dim {D} are not each "
          f"group's own")
    return dict(bits=keep.numel(), **bad)


def device_kernels(torch, fn, n: int = 20):
    """{kernel: (activities per call, device ms per call)} of ``fn``, from
    the profiler's device events (kernels, memsets, copies) over ``n``
    calls; a kernel is named as ``short_name`` gives it.  The profiler now
    and then drops events, or a whole profile: a profile whose counts are
    not whole multiples of ``n`` is taken again (up to 5 times, keeping the
    fullest), counts are rounded to whole activities per call (at least one
    for a kernel seen at all), and times taken over the events seen."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    best_total, got = -1, {}
    for _ in range(5):
        SPENT["profiles"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = collections.defaultdict(lambda: [0, 0.0])
        for e in prof.events():
            if e.device_type.name == "CUDA":
                entry = seen[short_name(e.name)]
                entry[0] += 1
                entry[1] += e.device_time / 1e3
        total = sum(c for c, _ in seen.values())
        if total > best_total:
            best_total, got = total, seen
        if seen and all(c % n == 0 for c, _ in seen.values()):
            got = seen
            break
    SPENT["profiler_s"] += time.perf_counter() - t0
    per_call = {k: max(1, round(c / n)) for k, (c, _) in got.items()}
    return {k: (per_call[k], t / c * per_call[k])
            for k, (c, t) in got.items()}


def short_name(name: str) -> str:
    """``ln_bwd_vec_kernel<__nv_bfloat16, __nv_bfloat16, 6>`` from the
    profiler's demangled ``void (anonymous namespace)::...(args)``."""
    m = re.search(r"(\w+_kernel)(<[^()]*>)?\(", name)
    return m.group(1) + (m.group(2) or "") if m else name


def kernel_ms(torch, fn, names, n: int = 20):
    """Device ms per call of ``fn`` spent in each kernel whose name holds
    one of ``names``, from the profiler's kernel events over ``n`` calls."""
    for _ in range(3):   # retry a profile that misses one of the kernels
        split = device_kernels(torch, fn, n)
        got = {name: sum(t for k, (_, t) in split.items() if name in k)
               for name in names}
        if all(got.values()):
            break
    return got


def split_bounds(torch, B, H, Tq, Tk, D, masked, kv_lens, dtype=None):
    """Bounds of the dQ and the dK/dV kernel alone, each against the work
    it does: both read q, k, v, dO, lse and delta and compute S and dP (4 D
    flops per visible score entry); dQ then writes dq (2 D more), dK/dV
    writes dk and dv (4 D more).  Where the dQ kernel computes delta
    (every head dim but 64 and 96) it reads O and writes delta instead of
    reading it (2 D flops a row more)."""
    visible, keys, _ = attention_work(torch, B, H, Tq, Tk, masked, kv_lens)
    elem, peak, _, _ = dtype_limits(torch, dtype)
    bh = B * H
    io = elem * D * (2 * bh * Tq + 2 * keys) + 8 * bh * Tq
    dq_io = io + elem * D * bh * Tq
    dq_flops = 6.0 * D * visible
    if bwd_kernels(D, 1, dtype)[2] is None:
        dq_io += elem * D * bh * Tq
        dq_flops += 2.0 * D * bh * Tq
    return (bound_ms(dq_io, dq_flops, peak),
            bound_ms(io + 2 * elem * D * bh * Tk, 8.0 * D * visible, peak))


def phase_long_shape(torch, timer, gen, D=64):
    """One long multi-tile shape (the JAX package's online forward and
    split backward): B*H = 2, Tq = 640, Tk = 1280, band and dropout,
    kernels against plain versions; then the forward (row 1b) and the dQ
    and dK/dV kernels (rows 3 and 4, the profiler's device times of one
    backward) timed beside their bounds and SDPA."""
    import torch.nn.functional as F
    from bpx_torch.ops import flash_attention as fa
    B, H, Tq, Tk, rate, seed = 1, 2, 640, 1280, 0.1, 4242
    q, k, v, _ = attention_inputs(torch, gen, B, H, Tq, Tk, D, False)
    out, lse = fa.flash_attention(q, k, v, True, None, rate, seed,
                                  return_lse=True)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, True, None, rate,
                                                seed)
    dout = torch.randn(B, H, Tq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    delta = fa.attention_delta_reference(dout, out)
    got = fa._launch_bwd(q, k, v, dout, lse, out, True, None, rate, seed)
    want = fa.flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                 True, None, rate, seed)
    torch.cuda.synchronize()
    errs = [grad_err(g, w) for g, w in zip(got, want)]
    print(f"[long] BH=2 640x1280 D={D} band, rate 0.1: err O "
          f"{max_err(out, ref):.3g}, lse {max_err(lse, ref_lse):.3g}, "
          f"dq/dk/dv rel err {max(errs):.3g}")
    check(torch.allclose(out.float(), ref.float(), **FLASH_TOL)
          and torch.allclose(lse, ref_lse, **LSE_TOL)
          and max(errs) <= FLASH_GRAD_TOL,
          "flash kernels differ from the plain versions at the long shape")
    takes_kernel(torch, lambda: fa.flash_attention(q, k, v, True, None, rate,
                                                   seed),
                 fwd_kernel(D), "the long shape")

    visible, keys, ok = attention_work(torch, B, H, Tq, Tk, True, None)
    mask_args = sdpa_mask(torch, ok)
    bh = B * H
    rows = {}
    # row 1b: the forward
    f_ms = bound_ms(2 * D * (2 * bh * Tq + 2 * keys) + 4 * bh * Tq,
                    4.0 * D * visible)
    rows["1b forward"] = (
        timer(lambda: fa.flash_attention(q, k, v, True, None, rate, seed)),
        timer(lambda: fa.flash_attention_reference(q, k, v, True, None, rate,
                                                   seed)),
        timer(lambda: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate, scale=1.0, **mask_args)), *f_ms)
    # rows 3 and 4: the dQ and dK/dV kernels, each against the work it does
    # (S and dP, then dQ; S^T and dP^T, then dV and dK); SDPA has no call of
    # its own for either, so its whole backward stands beside the pair
    dq_name, dkdv_name, delta_name = bwd_kernels(D)
    split = backward_split(torch, lambda: fa._launch_bwd(
        q, k, v, dout, lse, out, True, None, rate, seed), D)
    t_l = timer(sdpa_backward(torch, q, k, v, mask_args, rate, dout))
    dq_b, dkdv_b = split_bounds(torch, B, H, Tq, Tk, D, True, None)
    rows["3 dQ kernel"] = (split[dq_name], None, t_l, *dq_b)
    rows["4 dK/dV kernel"] = (split[dkdv_name], None, t_l, *dkdv_b)
    nbytes, flops, _ = flash_bwd_work(torch, B, H, Tq, Tk, D, True, None)
    rows["2-4 whole backward"] = (
        timer(lambda: fa._launch_bwd(q, k, v, dout, lse, out, True, None,
                                     rate, seed)),
        timer(lambda: fa.flash_attention_backward_reference(
            q, k, v, dout, lse, delta, True, None, rate, seed)),
        t_l, *bound_ms(nbytes, flops))
    for name, (t_k, t_p, t_lib, b_ms, b_by) in rows.items():
        print(f"[long] D={D} {name}: kernel {t_k:.4f} ms, plain "
              + (f"{t_p:.4f} ms" if t_p is not None else "-")
              + f", sdpa {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"{b_ms / t_k:.1%} of the bound, {t_k / t_lib:.2f}x sdpa")
    if delta_name:
        print(f"[long] D={D} delta kernel {split[delta_name]:.4f} ms of the "
              f"backward")
    else:
        print(f"[long] D={D} no delta kernel: the dQ kernel computes delta")
    return {name: dict(ms=r[0], plain_ms=r[1], library_ms=r[2],
                       bound_ms=r[3], bound_by=r[4])
            for name, r in rows.items()}


def experiment(path: ModelPath, remat: bool = False):
    """The path's preset with its fusion.  The serving and training phases
    run it without recompute, as every phase did before recompute was
    ported, so their launch counts and medians compare across runs; the
    remat phase runs the preset's own recompute settings (``remat``)."""
    from bpx_torch.config import get_preset
    exp = get_preset(path.preset)
    m = exp.model.replace(fusion=path.fusion, **dict(path.options))
    return exp.replace(model=m if remat else m.replace(remat=False))


def synthetic_batch(exp, n: int, seed: int):
    """numpy-seeded request shaped like the preset's: text with per-sample
    contiguous-suffix padding, video frames, audio frames (mel-like for
    the conv encoder, raw features otherwise) and, for mmtrvapt, a poster
    vector."""
    import numpy as np
    rng = np.random.RandomState(seed)
    m, d = exp.model, exp.data
    T = m.num_vectors_l
    lens = rng.randint(min(64, T), T + 1, size=n)
    lens[0] = T
    mask = np.arange(T)[None, :] < lens[:, None]
    txt = rng.randint(1, m.bert.vocab_size, size=(n, T)) * mask
    batch = {
        "txt": txt.astype(np.int32),
        "mask": mask.astype(np.int32),
        "segment": np.zeros((n, T), np.int32),
        "video": rng.rand(n, d.video_len, m.orig_d_v).astype(np.float32),
        "audio": rng.rand(n, d.audio_raw_len, m.orig_d_a).astype(np.float32),
    }
    if m.model == "mmtrvapt":
        batch["poster"] = rng.rand(n, m.orig_d_p).astype(np.float32)
    return batch


def phase_predictor(torch, path: ModelPath, requests: int = REQUESTS):
    from bpx_torch.serve import Predictor
    exp = experiment(path)
    t0 = time.time()
    pred = Predictor(exp, batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pred.model.parameters())
    m = exp.model
    print(f"[serve {path.name}] {m.model} fusion={m.fusion}, "
          f"{n_params / 1e6:.1f} M params, {m.compute_dtype}, built in "
          f"{time.time() - t0:.1f} s")
    reqs = [synthetic_batch(exp, BATCH, seed=100 + i)
            for i in range(requests)]
    return pred, reqs


#: the notebook-era models' gates, in units of hidden_sz: 3-ary GMUs, the
#: bimodal one's [z, 1 - z], none for the text-only baseline
LEGACY_GATES = {"mmtrvpa": 3, "tmmtrvpa": 3, "gmu": 3, "gmu_hier": 3,
                "gmu_softmax": 3, "gmu_bi": 2, "bertclf": 0, "bert": 0}


def gates_dim(m) -> int:
    """Width of the final fusion's gates: the N-ary GMU's N * E (one more
    input with ``hybrid``), MAG's alpha 1, a notebook-era model's
    ``LEGACY_GATES``."""
    if m.fusion == "mag":
        return 1
    if m.model in LEGACY_GATES:
        return LEGACY_GATES[m.model] * m.hidden_sz
    return ((4 if m.model == "mmtrvapt" else 3) + m.hybrid) * m.hidden_sz


def record_forward(path: ModelPath, pred, batch, head_dim=None, dims=None):
    """Serve ``batch`` once (the warm-up request: cuBLAS/cuDNN set-up),
    recording every launch; the counts must be the structure's, the
    encoders' attentions at ``head_dim`` (BERT's 12 at 64), or the flash
    launches by head dim ``dims``, and the flash wrappers must have copied
    nothing."""
    flash_cls, ln_cls, copies = launch_classes(pred, batch)
    n_flash, n_ln = sum(flash_cls.values()), sum(ln_cls.values())
    by_dim = collections.Counter()
    for cls, c in flash_cls.items():
        by_dim[cls[4]] += c
    print(f"[serve {path.name}] recorded forward: {n_flash} flash "
          f"launches in {len(flash_cls)} shape classes (by head_dim "
          f"{dict(by_dim)}), {n_ln} layer_norm launches in {len(ln_cls)} "
          f"(structure: {path.flash}, {path.ln}); tensors the flash "
          f"wrappers copied, by head_dim: {dict(copies)}")
    check(n_flash == path.flash and n_ln == path.ln,
          f"the recorded {path.name} forward's launches differ from the "
          f"structure's")
    if head_dim is not None:
        dims = {head_dim: path.flash - 12, 64: 12}
    if dims is not None:
        check(by_dim == dims,
              f"{path.name}: flash launches by head_dim {dict(by_dim)}")
    check(not sum(copies.values()),
          f"{path.name}: the flash wrappers copied tensors, by head_dim "
          f"{dict(copies)}")
    return flash_cls, ln_cls


def phase_serve(torch, np, pred, reqs, profile: bool,
                path: ModelPath = MOVIESCOPE, faults: bool = True):
    """The served path: requests with the launch counters checked, outputs
    against the plain versions on the card, and (``faults``) the planted
    faults, which must move that comparison past its limits."""
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.dispatch import plain_versions
    from bpx_torch.ops.flash_attention import flash_attention
    from bpx_torch.ops.norm import layer_norm

    tag = f"[serve {path.name}]"
    n_cls = pred.exp.model.n_classes
    n_gates = gates_dim(pred.exp.model)
    n_req = len(reqs)
    reqs = list(reqs)
    full = reqs[1] if n_req > 1 else None
    if full is not None:
        reqs[1] = {k: v[:5] for k, v in full.items()}   # a ragged request
    torch.cuda.synchronize()

    flash_attention.launches = 0
    flash_attention.generic_launches = 0
    flash_attention.chunked_launches = 0
    flash_attention.panel_launches = 0
    layer_norm.launches = 0
    outs, lat = [], []
    for batch in reqs:
        t = time.perf_counter()
        probs, gates = pred(batch, return_gates=True)
        lat.append((time.perf_counter() - t) * 1e3)
        outs.append((probs, gates))
    n_flash, n_ln = flash_attention.launches, layer_norm.launches
    n_generic = flash_attention.generic_launches
    n_chunked = flash_attention.chunked_launches
    n_panel = flash_attention.panel_launches

    print(f"{tag} {n_req} requests: flash launches {n_flash} "
          f"({n_flash / n_req:g}/forward; {n_panel / n_req:g} of them on "
          f"the panel builds, {n_generic / n_req:g} on the generic kernels, "
          f"{n_chunked / n_req:g} on the chunked ones, "
          f"{(n_flash - n_generic - n_chunked - n_panel) / n_req:g} on the "
          f"tabled ones), layer_norm launches {n_ln} "
          f"({n_ln / n_req:g}/forward)")
    check(n_flash == path.flash * n_req,
          f"flash kernel launched {n_flash} times, expected "
          f"{path.flash * n_req}")
    check(n_generic == path.generic * n_req,
          f"the generic flash kernels launched {n_generic} times, expected "
          f"{path.generic * n_req}")
    check(n_chunked == path.chunked * n_req,
          f"the chunked flash kernels launched {n_chunked} times, expected "
          f"{path.chunked * n_req}")
    check(n_panel == path.panel * n_req,
          f"the panel flash builds launched {n_panel} times, expected "
          f"{path.panel * n_req}")
    check(n_ln == path.ln * n_req,
          f"layer_norm kernel launched {n_ln} times, expected "
          f"{path.ln * n_req}")

    for batch, (probs, gates) in zip(reqs, outs):
        n = batch["txt"].shape[0]
        check(probs.shape == (n, n_cls), f"probs shape {probs.shape}")
        check(gates.shape == (n, n_gates), f"gates shape {gates.shape}")
        check(bool(np.isfinite(probs).all() and np.isfinite(gates).all()),
              "non-finite output")
        check(bool(((probs >= 0) & (probs <= 1)).all()),
              "probs outside [0, 1]")

    # kernels vs plain versions on the card, same weights, same requests
    with plain_versions():
        plain = [pred(batch, return_gates=True) for batch in reqs]
    check(flash_attention.launches == n_flash
          and layer_norm.launches == n_ln,
          "plain versions moved the launch counters")

    def errors(served):
        # initial=0: bertclf's gates are (n, 0)
        return (max(float(np.abs(a[0] - b[0]).max(initial=0.0))
                    for a, b in zip(served, plain)),
                max(float(np.abs(a[1] - b[1]).max(initial=0.0))
                    for a, b in zip(served, plain)))

    perr, gerr = errors(outs)
    print(f"{tag} kernels vs plain versions: probs max err {perr:.3g} "
          f"(tol {path.probs_tol}), gates max err {gerr:.3g} (tol "
          f"{path.gates_tol})")
    check(perr <= path.probs_tol,
          f"{path.name}: probs differ from the plain path by {perr}")
    check(gerr <= path.gates_tol,
          f"{path.name}: gates differ from the plain path by {gerr}")

    # the same comparison must catch a kernel launched with a wrong mask
    planted = {}
    for fault, wrap in (PLANTED_FAULTS.items() if faults else ()):
        with wrapped_launch(fa, wrap):
            f_perr, f_gerr = errors([pred(batch, return_gates=True)
                                     for batch in reqs])
        planted[fault] = dict(probs_err=f_perr, gates_err=f_gerr)
        print(f"{tag} planted fault, {fault}: probs max err {f_perr:.3g}, "
              f"gates max err {f_gerr:.3g}")
    for fault, e in planted.items():
        check(e["probs_err"] > path.probs_tol
              or e["gates_err"] > path.gates_tol,
              f"{path.name}: the comparison with the plain path misses a "
              f"planted fault ({fault})")

    if full is not None:
        # a ragged request's rows equal the same rows served in a full batch
        fp = pred(full)
        rerr = float(np.abs(fp[:5] - outs[1][0]).max())
        print(f"{tag} ragged request vs the same rows in a full batch: "
              f"max err {rerr:.3g}")
        check(rerr <= path.probs_tol, f"ragged request differs by {rerr}")

    # the full requests' latency; the ragged request 2's apart
    med = statistics.median([x for i, x in enumerate(lat)
                             if i != 1 or full is None])
    print(f"{tag} per-request latency (host clock, numpy in -> numpy "
          f"out): median {med:.2f} ms over the {n_req - (full is not None)} "
          f"full request(s) (the ragged request 2 apart): "
          + ", ".join(f"{x:.2f}" for x in lat))
    if profile:
        profile_forward(torch, pred, reqs[0])
    return dict(latency_ms=lat, median_ms=med, flash_launches=n_flash,
                generic_launches=n_generic, chunked_launches=n_chunked,
                panel_launches=n_panel, ln_launches=n_ln,
                probs_err=perr, gates_err=gerr, planted_faults=planted)


def profile_forward(torch, pred, batch):
    """Device time by kernel over one served forward."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred(batch)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in events) / 1e3
    print(f"[profile] one forward: summed device kernel time {busy:.2f} ms "
          f"over {len(events)} kernels")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_batch(torch, np, exp, seed: int, label_p, accum: int = TRAIN_A):
    """A numpy-seeded (A, micro, ...) super-batch on the card, with
    multilabel targets drawn at the synthetic label frequencies, or (no
    ``label_p``: cmu-mosi) one real-valued target per sample."""
    b = synthetic_batch(exp, accum * BATCH, seed)
    rng = np.random.RandomState(seed + 1)
    if label_p is None:
        b["target"] = rng.uniform(-3, 3, accum * BATCH).astype(np.float32)
    else:
        b["target"] = (rng.rand(accum * BATCH, len(label_p))
                       < label_p).astype(np.float32)
    return {k: torch.from_numpy(v.reshape(accum, BATCH, *v.shape[1:]))
            .to("cuda") for k, v in b.items()}


def phase_trainer(torch, np, path: ModelPath = MOVIESCOPE,
                  steps: int = TRAIN_STEPS, remat: bool = False,
                  optimizer: str = "adam", accum: int = TRAIN_A,
                  accum_dtype=None):
    """The path's model at full width and depth in training mode, the
    ``optimizer`` (Adam) at LR, BCE with pos_weight from synthetic label
    frequencies (cmu-mosi: its L1 loss on real-valued targets), and the
    accumulation step at A = ``accum`` (TRAIN_A) accumulating in
    ``accum_dtype``; with the preset's recompute if ``remat``."""
    from bpx_torch.models import get_model
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    exp = experiment(path, remat)
    m = exp.model
    regression = exp.data.task == "cmu-mosi"
    check(regression or exp.data.task_type == "multilabel",
          f"{path.name} is neither multilabel nor cmu-mosi")
    t0 = time.time()
    model = get_model(m, device="cuda", seed=0).train()
    rng = np.random.RandomState(7)
    n_train = 1000
    freqs = rng.randint(30, 400, size=m.n_classes)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), n_train, device="cuda")
    opt = make_optimizer(model.parameters(), LR, optimizer)
    step = make_train_step(model, m.model, loss_fn, opt,
                           grad_accum=accum,
                           generator=torch.Generator().manual_seed(0),
                           accum_dtype=accum_dtype)
    batches = [train_batch(torch, np, exp, 300 + i,
                           None if regression else freqs / n_train, accum)
               for i in range(steps)]
    torch.cuda.synchronize()
    print(f"[train {path.name}] {m.model}, {type(opt).__name__} lr {LR}, "
          f"{'L1' if regression else 'BCE with pos_weight'}, micro-batch "
          f"{BATCH} x A={accum} (accumulated in {accum_dtype or 'float32'}),"
          f" {m.compute_dtype}, attention_impl {m.attention_impl}, remat "
          f"{m.remat}; built in {time.time() - t0:.1f} s")
    return model, loss_fn, step, batches


def group_of(name: str) -> str:
    """A parameter's group in the gradient comparisons: BERT's embeddings,
    BERT's layers, or its top-level module."""
    top = name.split(".")[0]
    if top == "bert":
        return ("bert.layers" if name.startswith("bert.layers.")
                else "bert.embeddings")
    return top


def grad_groups(model):
    """The model's parameters by ``group_of``."""
    groups = collections.defaultdict(list)
    for n, p in model.named_parameters():
        groups[group_of(n)].append(p)
    return dict(groups)


def micro_step(model, loss_fn, micro, seed):
    """Forward and backward of one micro-batch with dropout seed ``seed``;
    returns the loss (the gradients stay in ``.grad``)."""
    from bpx_torch.inputs import model_inputs
    model.zero_grad(set_to_none=True)
    logits = model(*model_inputs(model.config.model, micro),
                   dropout_seed=seed)
    loss = loss_fn(logits, micro["target"])
    loss.backward()
    return loss.item()


def flat_grads(torch, groups):
    """Each group's gradients as one fp32 vector."""
    return {g: torch.cat([p.grad.float().flatten() for p in ps])
            for g, ps in groups.items()}


def group_errors(torch, groups, ref):
    """Relative L2 error of each group's gradient against ``ref``; a
    non-finite one reads as infinite."""
    return relative_errors(torch, flat_grads(torch, groups), ref)


def relative_errors(torch, got, ref):
    """Relative L2 error of each group's vector in ``got`` against
    ``ref``; a non-finite one reads as infinite."""
    errs = {}
    for g, v in got.items():
        e = ((v - ref[g]).norm() / ref[g].norm()).item()
        errs[g] = e if math.isfinite(e) else float("inf")
    return errs


# the backward launched without part of its contract, to show that the
# micro-step comparison with the plain path catches a wrong kernel
TRAIN_FAULTS = {
    "flash backward ignores its dropout mask":
        lambda launch, q, k, v, do, lse, out, masked, kv_lens, rate, seed,
        place=None: launch(q, k, v, do, lse, out, masked, kv_lens, 0.0,
                           None, place),
    "flash backward ignores the band":
        lambda launch, q, k, v, do, lse, out, masked, kv_lens, rate, seed,
        place=None: launch(q, k, v, do, lse, out, False, kv_lens, rate, seed,
                           place),
}


def phase_micro_step(torch, model, loss_fn, batches,
                     path: ModelPath = MOVIESCOPE, must_catch=None):
    """One micro-step with the kernels (recording every launch's class)
    against the same step under plain_versions(): same weights, batch and
    dropout seed.  Then the planted faults, each of ``must_catch`` (all of
    them when None) past the path's limit, the rest read and printed; and
    the wrappers' copies at a narrow head dim, which must be none."""
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.dispatch import plain_versions
    micro = {k: v[0] for k, v in batches[0].items()}
    seed = 0x5EED
    groups = grad_groups(model)
    # the scale of bf16 rounding: the same step in fp32 compute (plain
    # versions, same weights and dropout masks) as a yardstick for both
    from bpx_torch.models import get_model
    model32 = get_model(model.config.replace(compute_dtype="float32"),
                        device="cuda").train()
    model32.load_state_dict(model.state_dict())
    with plain_versions():
        micro_step(model32, loss_fn, micro, seed)
    ref32 = flat_grads(torch, grad_groups(model32))
    del model32
    with plain_versions():
        loss_p = micro_step(model, loss_fn, micro, seed)
    ref = flat_grads(torch, groups)
    e32_plain = group_errors(torch, groups, ref32)
    with recording() as seen:
        loss_k = micro_step(model, loss_fn, micro, seed)
    e32_kern = group_errors(torch, groups, ref32)
    del ref32
    errs = group_errors(torch, groups, ref)
    worst = max(errs, key=errs.get)
    tag = f"[micro-step {path.name}]"
    print(f"{tag} against the fp32 step: plain bf16 versions worst "
          f"group {max(e32_plain.values()):.3g}, kernels worst group "
          f"{max(e32_kern.values()):.3g}; per group (plain / kernels): "
          + ", ".join(f"{g} {e32_plain[g]:.3g}/{e32_kern[g]:.3g}"
                      for g in sorted(groups)))
    lerr = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{tag} kernels vs plain versions: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (rel err {lerr:.3g}, tol {path.loss_tol}); worst "
          f"gradient group {worst}: rel err {errs[worst]:.3g} (tol "
          f"{path.grad_tol}); " + ", ".join(f"{g} {e:.3g}"
                                       for g, e in sorted(errs.items())))
    check(lerr <= path.loss_tol, f"micro-step loss differs by {lerr}")
    off = [g for g in groups
           if e32_kern[g] > FP32_FACTOR * e32_plain[g] + FP32_SLACK]
    check(not off, f"the kernels' gradients are further from the fp32 step "
                   f"than the plain versions' in {off}")
    check(errs[worst] <= path.grad_tol,
          f"micro-step gradients of {worst} differ by {errs[worst]}")
    planted = {}
    for fault, wrap in TRAIN_FAULTS.items():
        with wrapped_launch(fa, wrap, "_launch_bwd"):
            micro_step(model, loss_fn, micro, seed)
        ferrs = group_errors(torch, groups, ref)
        fworst = max(ferrs, key=ferrs.get)
        planted[fault] = dict(group=fworst, grad_err=ferrs[fworst])
        print(f"{tag} planted fault, {fault}: worst group {fworst} "
              f"rel err {ferrs[fworst]:.3g}; " + ", ".join(
                  f"{g} {e:.3g}" for g, e in sorted(ferrs.items())))
        check(ferrs[fworst] > path.grad_tol
              or (must_catch is not None and fault not in must_catch),
              f"the comparison with the plain path misses a planted fault "
              f"({fault})")
    model.zero_grad(set_to_none=True)
    n = {k: sum(c.values()) for k, c in seen.items()}
    print(f"{tag} recorded launches: flash {n['flash']} "
          f"({sum(c for k, c in seen['flash'].items() if k[-1] > 0)} with "
          f"dropout), flash backward {n['flash_bwd']}, layer_norm {n['ln']}, "
          f"layer_norm backward {n['ln_bwd']}, hash dropout {n['dropout']}; "
          f"tensors the flash wrappers copied, by head_dim: "
          f"{dict(seen['copies'])}")
    check(not sum(seen["copies"].values()),
          "the flash wrappers copied tensors before a launch")
    check(n["flash"] == path.flash and n["flash_bwd"] == path.flash
          and n["ln"] == path.ln_train and n["ln_bwd"] == path.ln_train,
          "the recorded micro-step's launches differ from the structure's")
    routes = {f"{kind} {route}": seen["routes"][(kind, route)]
              for kind in ("flash", "flash_bwd")
              for route in ("tabled",) + COUNTED_ROUTES}
    print(f"{tag} flash launches by route: {routes}")
    check(routes["flash generic"] == path.generic
          and routes["flash_bwd generic"] == path.generic,
          f"the recorded micro-step's generic flash launches differ from "
          f"the structure's {path.generic}")
    check(routes["flash chunked"] == path.chunked
          and routes["flash_bwd chunked"] == path.chunked,
          f"the recorded micro-step's chunked flash launches differ from "
          f"the structure's {path.chunked}")
    check(routes["flash panel"] == path.panel
          and routes["flash_bwd panel"] == path.panel,
          f"the recorded micro-step's panel flash launches differ from "
          f"the structure's {path.panel}")
    return seen, dict(loss_err=lerr, grad_err=errs[worst], worst=worst,
                      planted_faults=planted)


def warm_steps(times):
    """(ms, words) for timed steps on the host clock: the median of the
    steps after the first, which sets up the optimizer's state (and
    FSDP2's lazy one), or that first step alone where only one ran."""
    if len(times) > 1:
        which = (f"median over steps 2-{len(times)}" if len(times) > 2
                 else "step 2")
        return (statistics.median(times[1:]),
                f"{which} (step 1, which sets up the optimizer's state, "
                f"apart)")
    return times[0], "the first step alone (it sets up the optimizer's state)"


def phase_train(torch, model, step, batches, profile: bool,
                path: ModelPath = MOVIESCOPE, accum: int = TRAIN_A):
    """One accumulation step (A = ``accum``) per batch with the launch
    counters checked per step; step time on the host clock around a
    synchronised step."""
    tag = f"[train {path.name}]"
    want = dict(flash=path.flash * accum, dropout=path.dropout * accum,
                flash_bwd=path.flash * accum,
                ln=path.ln_train * accum, ln_bwd=path.ln_train * accum)
    totals = collections.Counter()
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(batch)["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        got = read_launches()
        routes = read_routes()
        totals.update(got)
        totals.update(routes)
        losses.append(loss)
        print(f"{tag} step {i + 1}: loss {loss:.6f}, {times[-1]:.1f} ms; "
              f"launches {got}, by route {routes}")
        check(got == want, f"step {i + 1} launches {got}, expected {want}")
        want_routes = {f"{r}{kind}": getattr(path, r) * accum
                       for r in COUNTED_ROUTES
                       for kind in ("", "_bwd")}
        check(routes == want_routes,
              f"step {i + 1} flash launches by route {routes}, expected "
              f"{want_routes}")
        check(math.isfinite(loss), f"step {i + 1} loss is {loss}")
        if i == 0:
            check_grads(torch, model)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med, which = warm_steps(times)
    print(f"{tag} step time (host clock, synchronised) {med:.1f} ms, "
          f"{which}; steps " + ", ".join(f"{x:.1f}" for x in times)
          + f"; {accum * BATCH / med * 1e3:.2f} samples/s; peak memory "
          f"{peak:.2f} GiB (max_memory_allocated)")
    if profile:
        profile_train_step(torch, step, batches[0])
    return dict(step_ms=times, median_ms=med, losses=losses,
                peak_gib=peak, totals=totals)


def check_grads(torch, model):
    """After step 1: every parameter has a finite gradient, and BERT's
    embedding, LayerNorm and q/k/v weights have non-zero ones (an autograd
    graph cut at a kernel would leave them None or zero)."""
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    check(not missing, f"parameters without a gradient: {missing[:5]}")
    bad = [n for n, p in model.named_parameters()
           if not torch.isfinite(p.grad).all()]
    check(not bad, f"non-finite gradients: {bad[:5]}")
    names = ["bert.word_embeddings.weight", "bert.embeddings_norm.weight",
             "bert.embeddings_norm.bias"]
    for i in (0, len(model.bert.layers) - 1):
        names += [f"bert.layers.{i}.attention.{m}.weight"
                  for m in ("query", "key", "value")]
        names += [f"bert.layers.{i}.attention_norm.weight",
                  f"bert.layers.{i}.output_norm.weight"]
    params = dict(model.named_parameters())
    zero = [n for n in names if not params[n].grad.abs().sum().item() > 0]
    check(not zero, f"zero gradients: {zero}")
    print(f"[train] after step 1: all {len(params)} parameters have finite "
          f"gradients; BERT embedding, LayerNorm and q/k/v gradients are "
          f"non-zero ({len(names)} checked)")


def profile_train_step(torch, step, batch):
    """Device time by kernel over one train step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(batch)["loss"].item()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time for e in events) / 1e3
    print(f"[profile] one train step: summed device kernel time {busy:.1f} "
          f"ms over {len(events)} kernels, {wall:.1f} ms wall under the "
          f"profiler")
    by = collections.Counter()
    for e in events:
        by[kernel_category(e.name)] += e.device_time / 1e3
    print("[profile] device ms by kind: " + ", ".join(
        f"{k} {v:.1f}" for k, v in by.most_common()))
    # the plain hash dropout's kernels, under its autograd function's range
    for avg in prof.key_averages():
        if avg.key in ("_HashDropout", "_HashDropoutBackward",
                       "bpx_torch::flash_fwd", "bpx_torch::flash_bwd",
                       "bpx_torch::layer_norm", "bpx_torch::layer_norm_bwd"):
            print(f"[profile] {avg.key}: {avg.count} calls, device "
                  f"{avg.device_time_total / 1e3:.1f} ms, host "
                  f"{avg.cpu_time_total / 1e3:.1f} ms")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))


def kernel_category(name: str) -> str:
    """A device kernel's kind, from its name."""
    for key, kind in (("flash_fwd", "flash forward"),
                      ("flash_bwd", "flash backward"),
                      ("flash_delta", "flash backward"),
                      ("ln_bwd", "LayerNorm backward"),
                      ("layer_norm", "LayerNorm forward"),
                      ("Memcpy", "copies"), ("Memset", "copies"),
                      ("nvjet", "GEMM"), ("gemm", "GEMM"), ("xmma", "GEMM"),
                      ("cutlass", "GEMM"), ("cublas", "GEMM"),
                      ("multi_tensor_apply", "optimizer"),
                      ("reduce_kernel", "reductions")):
        if key in name:
            return kind
    return "elementwise and other"


# ---------------------------------------------------------------------------
# the training loop: the README's command through the CLI
# ---------------------------------------------------------------------------

LOOP_GENRES = ["Action", "Adventure", "Animation", "Biography", "Comedy",
               "Crime", "Drama", "Family", "Fantasy", "History", "Horror",
               "Romance", "Thriller"]
LOOP_SPLITS = {"train": 32, "dev": 16, "test": 16}
#: epochs of the first run (one, for the script's time limit); the resume
#: runs one more
LOOP_EPOCHS = 1
LOOP_STEPS = LOOP_SPLITS["train"] // (BATCH * TRAIN_A)     # per epoch
LOOP_EVALS = LOOP_SPLITS["dev"] // BATCH                  # per epoch
LOOP_TESTS = LOOP_SPLITS["test"] // BATCH
LOOP_ARGV = ["--model", "mmtrvapt", "--task", "moviescope", "--hidden_sz",
             "768", "--num_heads", "8", "--layers", "4", "--orig_d_v", "4096",
             "--orig_d_a", "96", "--batch_sz", str(BATCH),
             "--gradient_accumulation_steps", str(TRAIN_A),
             "--attention_impl", "pallas", "--from_seed", "1", "--to_seed",
             "1"]
# launches per train step (A micro-batches) and per evaluation forward
LOOP_STEP_LAUNCHES = dict(flash=FLASH_PER_FORWARD * TRAIN_A,
                          dropout=FLASH_DROPOUT_PER_FORWARD * TRAIN_A,
                          flash_bwd=FLASH_PER_FORWARD * TRAIN_A,
                          ln=LN_PER_TRAIN_FORWARD * TRAIN_A,
                          ln_bwd=LN_PER_TRAIN_FORWARD * TRAIN_A)
LOOP_EVAL_LAUNCHES = dict(flash=FLASH_PER_FORWARD, dropout=0, flash_bwd=0,
                          ln=LN_PER_FORWARD, ln_bwd=0)
LOOP_PROBS_TOL = 1e-6      # from_checkpoint against test's preds_raw.npy


def write_moviescope(np, root: Path, seed: int = 0):
    """A moviescope dataset at full width in the reference's layout:
    ``{split}.jsonl`` records with a synopsis and genre lists over the 13
    genres, and per record a pickled (1, 200, 4096) VGG16 array, a
    (96, 928) mel-spectrogram and a (1, 4096) poster, from a seed.  Train
    and test labels are random (every genre present in train); dev records
    carry no genre, so the tuning metric (micro AP) is exactly 0 at every
    epoch and every epoch checkpoints (an improvement is ``>=``), whatever
    random weights learn: the resume then starts at epoch 2.  (All 13 genres
    on every dev record would give an AP of 1 up to rounding, which moves
    with the scores' ties.)"""
    import pickle
    rng = np.random.RandomState(seed)
    d = root / "moviescope"
    for sub in ("200F_VGG16", "Melspectrogram", "PosterFeatures"):
        (d / sub).mkdir(parents=True)
    words = [f"w{i}" for i in range(2000)]
    for split, n in LOOP_SPLITS.items():
        lines = []
        for i in range(n):
            sid = f"{split}{i}"
            if split == "dev":
                genres = []
            else:
                genres = [LOOP_GENRES[j] for j in rng.choice(
                    13, rng.randint(1, 4), replace=False)]
                if split == "train" and i < 13:
                    genres = sorted(set(genres) | {LOOP_GENRES[i]})
            synopsis = " ".join(rng.choice(words, rng.randint(80, 600)))
            lines.append(json.dumps({"id": sid, "synopsis": synopsis,
                                     "label": genres}))
            for sub, arr in (
                    ("200F_VGG16", rng.randn(1, 200, 4096)),
                    ("Melspectrogram", rng.rand(96, 928)),
                    ("PosterFeatures", rng.randn(1, 4096))):
                with open(d / sub / f"{sid}.p", "wb") as f:
                    pickle.dump(arr.astype(np.float32), f)
        (d / f"{split}.jsonl").write_text("\n".join(lines) + "\n")


@contextlib.contextmanager
def counted_loop(calls):
    """Inside the context, every train step and evaluation forward that
    ``bpx_torch.train.loop`` builds appends ``(kind, launches)`` to
    ``calls``: the launch counters' moves over that one call."""
    from bpx_torch.train import loop

    def counted(factory, kind):
        def make(*args, **kw):
            fn = factory(*args, **kw)

            def run(batch):
                before = read_launches()
                out = fn(batch)
                after = read_launches()
                calls.append((kind, {k: after[k] - before[k]
                                     for k in after}))
                return out
            return run
        return make

    made = loop.make_train_step, loop.make_eval_step
    loop.make_train_step = counted(made[0], "step")
    loop.make_eval_step = counted(made[1], "eval")
    try:
        yield read_launches
    finally:
        loop.make_train_step, loop.make_eval_step = made


@contextlib.contextmanager
def timed_cache_builds(builds):
    """Record (split, seconds, built) for every precollated store the
    loaders open inside the context."""
    from bpx_torch.data import cache
    build = cache.PrecollatedStore.build_or_load

    def timed(dataset, jsonl_path, *args, **kw):
        fresh = not any(Path(jsonl_path).parent.glob(
            f".bpx_cache/{Path(jsonl_path).stem}_*/meta.json"))
        t = time.perf_counter()
        store = build(dataset, jsonl_path, *args, **kw)
        builds.append((Path(jsonl_path).stem, time.perf_counter() - t,
                       fresh, store is not None))
        return store

    cache.PrecollatedStore.build_or_load = staticmethod(timed)
    try:
        yield
    finally:
        cache.PrecollatedStore.build_or_load = staticmethod(build)


def epoch_stats(run: Path):
    """The training loop's per-epoch numbers (its ``epoch stats`` log
    lines)."""
    stats = []
    for line in (run / "logfile.log").read_text().splitlines():
        if " - epoch stats " in line:
            stats.append(json.loads(line.split(" - epoch stats ", 1)[1]))
    return stats


def check_loop_calls(calls, n_steps, n_evals, tag):
    steps = [c for kind, c in calls if kind == "step"]
    evals = [c for kind, c in calls if kind == "eval"]
    print(f"{tag} {len(steps)} train steps, {len(evals)} evaluation "
          f"forwards; launches per step {steps[0] if steps else None}, per "
          f"evaluation forward {evals[0] if evals else None}")
    check(len(steps) == n_steps and len(evals) == n_evals,
          f"{tag} ran {len(steps)} steps and {len(evals)} evaluation "
          f"forwards, expected {n_steps} and {n_evals}")
    bad = [c for c in steps if c != LOOP_STEP_LAUNCHES] + \
        [c for c in evals if c != LOOP_EVAL_LAUNCHES]
    check(not bad, f"{tag} launches {bad[:2]}, expected "
                   f"{LOOP_STEP_LAUNCHES} per step and {LOOP_EVAL_LAUNCHES} "
                   f"per evaluation forward")


def phase_loop(torch, np, card: str, checked, side):
    """The README's moviescope command through ``bpx_torch.cli.train.
    cli_main`` in this process: the memmap cache, LOOP_EPOCHS epochs,
    checkpoints, ``test``; a resume to one epoch more with the restored
    state checked bit for bit against the saved one; ``Predictor.from_checkpoint`` against
    ``test``'s ``preds_raw.npy``.  ``checked``: the launch classes the
    earlier phases held against the plain versions, per kernel.  The
    export CLI's check runs on ``side`` (its processes beside the later
    phases), which removes the run directory after it; the result's
    ``export_cli`` is its future."""
    from bpx_torch.cli.train import cli_main
    from bpx_torch.config import config_from_dict
    from bpx_torch.data.loaders import get_data_loaders
    from bpx_torch.serve import Predictor
    from bpx_torch.utils.checkpoint import CheckpointManager
    tag = "[loop]"
    tmp = Path(tempfile.mkdtemp(prefix="bpx_loop_"))
    handed = False      # the run directory handed to the export's check
    try:
        t0 = time.time()
        write_moviescope(np, tmp / "data")
        print(f"{tag} wrote the moviescope fixture ({LOOP_SPLITS}) in "
              f"{time.time() - t0:.1f} s")
        argv = LOOP_ARGV + ["--data_path", str(tmp / "data"), "--savedir",
                            str(tmp / "runs"), "--name", "loop"]
        epochs = lambda n: argv + ["--max_epochs", str(n)]
        run = tmp / "runs" / "loop_Seed1_run"
        calls, builds = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with counted_loop(calls) as read, timed_cache_builds(builds), \
                recording() as seen:
            zero_launches()
            results = cli_main(epochs(LOOP_EPOCHS))
            totals = read()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_loop_calls(calls, LOOP_EPOCHS * LOOP_STEPS,
                         LOOP_EPOCHS * LOOP_EVALS + LOOP_TESTS, tag)
        summed = collections.Counter()
        for _, c in calls:
            summed.update(c)
        check(dict(summed) == totals,
              f"{tag} launches outside the steps and evaluations: {totals} "
              f"against {dict(summed)}")
        check(not sum(seen["copies"].values()),
              f"{tag} the flash wrappers copied tensors before a launch")
        new = {k: set(seen[k]) - checked[k] for k in checked}
        check(not any(new.values()),
              f"{tag} launch classes no earlier phase checked: {new}")
        print(f"{tag} launches {totals} in {wall:.1f} s; every class among "
              f"those the earlier phases held against the plain versions; "
              f"no tensor copied before a flash launch")
        m = results[1]
        check(all(math.isfinite(v) for v in m.values()),
              f"{tag} non-finite test metrics {m}")
        for f in ("latest", "best", "host_state.json", "config.json",
                  "test_labels_pred.txt", "test_labels_gold.txt",
                  "test_labels.txt", "preds_raw.npy"):
            check((run / f).exists(), f"{tag} the run wrote no {f}")
        check(sorted(s for s, _, fresh, ok in builds if fresh and ok)
              == ["dev", "test", "train"] and all(ok for *_, ok in builds),
              f"{tag} the memmap cache was not built for every split: "
              f"{builds}")
        host = json.loads((run / "host_state.json").read_text())
        check(host["epoch"] == LOOP_EPOCHS,
              f"{tag} host_state.json epoch {host['epoch']}, expected "
              f"{LOOP_EPOCHS}")

        # resume for one epoch more, restored bitwise
        saved = CheckpointManager(str(run)).load("latest")
        restored = {}
        restore = CheckpointManager.restore

        def compare(self, model, optimizer=None, tag="latest"):
            got = restore(self, model, optimizer, tag)
            if optimizer is None:
                return got
            restored["host"] = got
            sd, osd = model.state_dict(), optimizer.state_dict()["state"]
            restored["weights"] = all(
                torch.equal(sd[k].cpu(), v) for k, v in saved["model"].items())
            restored["moments"] = all(
                torch.equal(osd[i][n].cpu(), s[n])
                for i, s in saved["optimizer"]["state"].items()
                for n in ("exp_avg", "exp_avg_sq", "step"))
            return got

        calls2 = []
        CheckpointManager.restore = compare
        try:
            with counted_loop(calls2):
                t1 = time.time()
                cli_main(epochs(LOOP_EPOCHS + 1))
                wall2 = time.time() - t1
        finally:
            CheckpointManager.restore = restore
        del saved
        check(restored.get("host", (None, {}))[1].get("epoch")
              == LOOP_EPOCHS,
              f"{tag} the resume did not start at epoch {LOOP_EPOCHS}: "
              f"{restored}")
        check(restored["weights"] and restored["moments"],
              f"{tag} the restored weights or Adam moments differ from the "
              f"saved ones")
        check_loop_calls(calls2, LOOP_STEPS, LOOP_EVALS + LOOP_TESTS,
                         f"{tag} resume")
        print(f"{tag} resumed at epoch {LOOP_EPOCHS} (step "
              f"{restored['host'][0]}) and "
              f"ran one epoch in {wall2:.1f} s: weights and Adam moments "
              f"equal the saved ones bitwise")

        # serving from the checkpoint reproduces test's probabilities
        exp = config_from_dict(json.loads((run / "config.json").read_text()))
        t1 = time.time()
        pred = Predictor.from_checkpoint(exp, str(run), batch_size=BATCH,
                                         tag="best")
        load_s = time.time() - t1
        _, _, test_loader, _ = get_data_loaders(exp.data, exp.model,
                                                seed=exp.train.seed)
        test_batches = list(test_loader)
        outs, lat = [], []
        for b in test_batches:
            t1 = time.perf_counter()
            outs.append(pred(b))
            lat.append((time.perf_counter() - t1) * 1e3)
        probs = np.concatenate(outs)
        ragged = {k: v[:5] for k, v in test_batches[-1].items()}
        ragged_probs = pred(ragged)
        want = np.load(run / "preds_raw.npy")
        err = float(np.abs(probs - want).max())
        print(f"{tag} Predictor.from_checkpoint (best, restored in "
              f"{load_s:.1f} s) on the {len(want)} test records against "
              f"test's preds_raw.npy: max abs err {err:.3g} (tol "
              f"{LOOP_PROBS_TOL})")
        check(probs.shape == want.shape and err <= LOOP_PROBS_TOL,
              f"{tag} from_checkpoint differs from preds_raw.npy by {err}")
        del pred
        torch.cuda.empty_cache()

        stats = epoch_stats(run)
        for s in stats:
            print(f"{tag} epoch {s['epoch']}: {s['train_s']:.2f} s for "
                  f"{s['steps']} steps ({s['samples'] / s['train_s']:.2f} "
                  f"samples/s), step p50 {s['step_p50_s'] * 1e3:.1f} ms "
                  f"(StepTimer, synchronised), host data "
                  f"{s['data_s_per_batch'] * 1e3:.1f} ms per batch, "
                  f"evaluation {s['eval_s']:.2f} s, checkpoint "
                  f"{s['checkpoint_s']:.2f} s; card: {card}")
        for split, secs, fresh, _ in builds:
            if fresh:
                print(f"{tag} memmap cache build, {split}: {secs:.2f} s; "
                      f"card: {card}")
        print(f"{tag} {LOOP_EPOCHS} epoch(s), checkpoints and test in "
              f"{wall:.1f} s, the resume in {wall2:.1f} s; peak memory "
              f"{peak:.2f} GiB (max_memory_allocated); card: {card}")
        check(len(stats) == LOOP_EPOCHS + 1,
              f"{tag} {len(stats)} epochs logged")
        per_epoch = collections.Counter()
        for _, c in calls[:LOOP_STEPS + LOOP_EVALS]:    # epoch 0
            per_epoch.update(c)
        cli = side.submit(export_then_remove, np, run, tmp,
                          test_batches + [ragged],
                          np.concatenate([probs, ragged_probs]), tag,
                          statistics.median(lat))
        handed = True
        return dict(wall_s=wall, resume_s=wall2, peak_gib=peak, epochs=stats,
                    cache=builds, from_checkpoint_err=err, export_cli=cli,
                    launches=totals, launches_per_epoch=dict(per_epoch))
    finally:
        if not handed:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the kernels as custom ops: dispatch cost, export, recompute
# ---------------------------------------------------------------------------

def host_us_per_call(torch, fn, n: int = 2000) -> float:
    """Host time of one call (microseconds) over ``n`` calls at a shape
    whose kernel takes a few microseconds, so the host bounds the loop."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def phase_dispatch(torch):
    """What binding the kernels as custom ops costs the host: one call of
    the public wrapper (checks, the dispatcher, the op's impl, the launch)
    against a call of the impl alone (the launch path as it was before the
    ops), in turns, under inference_mode at (1, 1, 64, 64, 64) and 64 x
    768; and the wrapper with grad enabled (the op's autograd node)."""
    from bpx_torch.ops import flash_attention as fa, norm
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(1, 1, 64, 64, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    x = torch.randn(64, 768, device="cuda", generator=gen).bfloat16()
    w, b = (torch.randn(768, device="cuda", generator=gen) for _ in range(2))
    calls = dict(
        flash_impl=lambda: fa._forward(q, k, v, True, None, 0.0, None),
        flash_op=lambda: fa.flash_attention(q, k, v, True),
        ln_impl=lambda: norm._forward(x, w, b, 1e-6, torch.bfloat16),
        ln_op=lambda: norm.layer_norm(x, w, b, 1e-6, torch.bfloat16))
    got = collections.defaultdict(list)
    with torch.inference_mode():
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                got[name].append(host_us_per_call(torch, calls[name]))
    qg, kg, vg, xg, wg, bg = (t.clone().requires_grad_()
                              for t in (q, k, v, x, w, b))
    for _ in range(2):
        got["flash_op_grad"].append(host_us_per_call(
            torch, lambda: fa.flash_attention(qg, kg, vg, True)))
        got["ln_op_grad"].append(host_us_per_call(
            torch, lambda: norm.layer_norm(xg, wg, bg, 1e-6,
                                           torch.bfloat16)))
    us = {k: statistics.median(v) for k, v in got.items()}
    extra = {kind: us[f"{kind}_op"] - us[f"{kind}_impl"]
             for kind in ("flash", "ln")}
    per_request = (FLASH_PER_FORWARD * extra["flash"]
                   + LN_PER_FORWARD * extra["ln"]) / 1e3
    # a moviescope step: forward and backward ops, A micro-batches
    per_step = 2 * TRAIN_A * (FLASH_PER_FORWARD * extra["flash"]
                              + LN_PER_TRAIN_FORWARD * extra["ln"]) / 1e3
    print("[dispatch] host us per call (median of 2, host clock, "
          "synchronised after 2000 calls): " + ", ".join(
              f"{k} {v:.2f}" for k, v in us.items()))
    print(f"[dispatch] the custom op adds {extra['flash']:.2f} us a flash "
          f"call and {extra['ln']:.2f} us a LayerNorm call to the host: "
          f"{per_request:.2f} ms per moviescope request ({FLASH_PER_FORWARD} "
          f"+ {LN_PER_FORWARD} calls), {per_step:.2f} ms per step (forward "
          f"and backward ops, A = {TRAIN_A})")
    return dict(us=us, extra_us=extra, per_request_ms=per_request,
                per_step_ms=per_step)


# serves an exported archive in a process of its own: the requests from an
# npz, one warm-up request, the launch counters over the rest; prints one
# JSON line
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.norm import layer_norm
from bpx_torch.serve import ExportedPredictor
t = time.time()
server = ExportedPredictor.load(sys.argv[1])
load_s = time.time() - t
data = np.load(sys.argv[2])
reqs = [{k.split(":", 1)[1]: data[k] for k in data.files
         if k.startswith(f"{i}:")} for i in range(int(data["n"]))]
server(reqs[0])
flash_attention.launches = layer_norm.launches = 0
outs, lat = {}, []
for i, r in enumerate(reqs):
    t = time.perf_counter()
    outs[f"p{i}"], outs[f"g{i}"] = server(r, return_gates=True)
    lat.append((time.perf_counter() - t) * 1e3)
np.savez(sys.argv[3], **outs)
print(json.dumps(dict(
    load_s=load_s, latency_ms=lat, batch_size=server.batch_size,
    flash=flash_attention.launches, ln=layer_norm.launches,
    model_code=sorted(m for m in sys.modules
                      if m.startswith(("bpx_torch.models",
                                       "bpx_torch.config"))))))
"""


def run_child(np, archive: Path, reqs, tmp: Path):
    """Serve ``reqs`` from ``archive`` in a new process (EXPORT_CHILD);
    returns its JSON line and its outputs."""
    np.savez(tmp / "reqs.npz", n=len(reqs),
             **{f"{i}:{k}": v for i, r in enumerate(reqs)
                for k, v in r.items()})
    res = subprocess.run(
        [sys.executable, "-c", EXPORT_CHILD, str(archive),
         str(tmp / "reqs.npz"), str(tmp / "out.npz")], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"the exported archive's process failed:\n"
                               f"{res.stderr[-4000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    out = np.load(tmp / "out.npz")
    return got, [(out[f"p{i}"], out[f"g{i}"]) for i in range(len(reqs))]


def output_errors(np, got, want):
    """(probs max err, gates max err, bitwise equal) over paired
    (probs, gates) outputs."""
    perr = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(got, want))
    gerr = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(got, want))
    same = all(np.array_equal(a[i], b[i]) for a, b in zip(got, want)
               for i in (0, 1))
    return perr, gerr, same


def phase_export(torch, np, pred, reqs, card: str, path: ModelPath):
    """``Predictor.export`` of the served model of ``path`` at batch 8
    into a temporary directory, the archive served in a process that may
    not import the model code: its launches per forward (the path's), its
    outputs against the eager ``Predictor`` on the same requests (one
    ragged), and both served medians."""
    from bpx_torch.data.synthetic import example_batch
    tag = f"[export {path.name}]"
    reqs = list(reqs)
    reqs[1] = {k: v[:5] for k, v in reqs[1].items()}    # a ragged request
    tmp = Path(tempfile.mkdtemp(prefix="bpx_export_"))
    try:
        archive = tmp / "model.pt2"
        t0 = time.time()
        blob = pred.export(example_batch(pred.exp, BATCH), str(archive))
        export_s, size = time.time() - t0, len(blob)
        del blob
        pred(reqs[0])
        eager, lat = [], []
        for r in reqs:
            t = time.perf_counter()
            eager.append(pred(r, return_gates=True))
            lat.append((time.perf_counter() - t) * 1e3)
        got, outs = run_child(np, archive, reqs, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n = len(reqs)
    print(f"{tag} Predictor.export of {path.name} at batch {BATCH}: traced "
          f"and saved in {export_s:.1f} s, {size / 2 ** 20:.1f} MiB (the "
          f"fp32 weights inside); loaded in a new process in "
          f"{got['load_s']:.1f} s, batch size {got['batch_size']} from its "
          f"input spec; model code imported there: {got['model_code']}")
    check(not got["model_code"], f"{tag} the serving process imported "
                                 f"{got['model_code']}")
    check(got["batch_size"] == BATCH, f"{tag} batch size {got}")
    print(f"{tag} exported program: flash launches {got['flash']} "
          f"({got['flash'] / n:g}/forward), layer_norm launches {got['ln']} "
          f"({got['ln'] / n:g}/forward)")
    check(got["flash"] == path.flash * n and got["ln"] == path.ln * n,
          f"{tag} launches {got['flash']} / {got['ln']} over {n} forwards, "
          f"expected {path.flash} / {path.ln} each")
    perr, gerr, same = output_errors(np, outs, eager)
    print(f"{tag} exported vs eager Predictor on {n} requests (one "
          f"ragged): probs max err {perr:.3g}, gates max err {gerr:.3g}; "
          f"bitwise equal: {same}")
    check(same, f"{tag} the exported program's outputs differ from the "
                f"eager Predictor's (probs {perr}, gates {gerr})")
    med_e, med_x = statistics.median(lat), statistics.median(
        got["latency_ms"])
    print(f"{tag} served median request (host clock, numpy in -> numpy "
          f"out, {n} requests): eager {med_e:.2f} ms, exported {med_x:.2f} "
          f"ms; card: {card}")
    return dict(export_s=export_s, mib=size / 2 ** 20, eager_ms=med_e,
                exported_ms=med_x, launches=(got["flash"], got["ln"]))


def export_then_remove(np, run: Path, tmp: Path, *args):
    """``check_export_cli``, then the loop's directory ``tmp`` removed."""
    try:
        return check_export_cli(np, run, tmp, *args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_export_cli(np, run: Path, tmp: Path, batches, want, tag,
                     eager_ms: float):
    """``python -m bpx_torch.cli.export`` on a run directory of the
    trainer (``Predictor.export`` of the restored model), served in a new
    process that may not import the model code, on ``batches`` (the last
    one ragged) against ``want`` (``Predictor.from_checkpoint``'s probs):
    bitwise, the launches per forward (84 flash, 181 LayerNorm), and the
    served median beside the eager one (``eager_ms``)."""
    archive = tmp / "cli.pt2"
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "bpx_torch.cli.export", str(run), "--out",
         str(archive), "--batch_size", str(BATCH), "--tag", "best"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"{tag} the export CLI failed:\n"
                               f"{res.stderr[-4000:]}")
    cli_s = time.time() - t0
    mib = archive.stat().st_size / 2 ** 20
    got, outs = run_child(np, archive, batches, tmp)
    probs = np.concatenate([p for p, _ in outs])
    err = float(np.abs(probs - want).max())
    same = bool(np.array_equal(probs, want))
    n = len(batches)
    exported_ms = statistics.median(got["latency_ms"])
    line = (f"{tag} python -m bpx_torch.cli.export (best) in {cli_s:.1f} "
            f"s, {mib:.1f} MiB (the fp32 weights inside); loaded in a new "
            f"process in {got['load_s']:.1f} s, batch size "
            f"{got['batch_size']} from its input spec; served on {n - 1} "
            f"test batches and a ragged request ({len(want)} rows) against "
            f"Predictor.from_checkpoint: max abs err {err:.3g}, bitwise "
            f"equal: {same}; launches {got['flash']} / {got['ln']} over {n} "
            f"forwards; model code imported: {got['model_code']}; served "
            f"median eager {eager_ms:.2f} ms, exported {exported_ms:.2f} ms")
    check(same and not got["model_code"] and got["batch_size"] == BATCH,
          f"{tag} the CLI's archive differs from from_checkpoint: {line}")
    check(got["flash"] == FLASH_PER_FORWARD * n
          and got["ln"] == LN_PER_FORWARD * n,
          f"{tag} the exported program's launches {got['flash']} / "
          f"{got['ln']} over {n} forwards, expected {FLASH_PER_FORWARD} / "
          f"{LN_PER_FORWARD} each")
    return dict(cli_s=cli_s, err=err, mib=mib, eager_ms=eager_ms,
                exported_ms=exported_ms, log=line)


# recompute against keeping the activations, one micro-step on the same
# weights, batch and dropout seeds: every parameter group's gradient is
# bitwise equal, but for BERT's word, position and token-type embeddings,
# whose backward adds rows with atomics on the card, so that two runs
# without recompute already differ in the last bits.  On an H100 (700 W)
# that group reads 2.9e-7 (relative L2) at iemocap and mmimdb, a replay
# that draws fresh dropout seeds 0.48 in its worst group
REMAT_EMBED_TOL = 1e-4


def set_remat(model, on: bool):
    """Switch recompute on or off in every encoder and in BERT (the
    policies stay the config's)."""
    for mod in model.modules():
        if hasattr(mod, "remat_policy"):
            mod.remat = on


def remat_launches(path: ModelPath, m, bert_layers: int = 12) -> dict:
    """Launches of one training micro-step of ``path``'s model with the
    recompute settings of config ``m``: a recomputed layer runs its
    LayerNorms again (BERT's 2, an encoder layer's 4 in training, V
    embedded apart from K), and its flash forwards (with their dropout)
    unless its policy is ``save_attn``; the backward is as without
    recompute."""
    remat_bert = m.remat if m.remat_bert is None else m.remat_bert
    bert_full = remat_bert and m.remat_policy_bert is None
    enc_full = m.remat and m.remat_policy is None
    nb = bert_layers
    return dict(
        flash=path.flash + nb * bert_full + (path.flash - nb) * enc_full,
        dropout=path.dropout + nb * bert_full
        + (path.dropout - nb) * enc_full,
        flash_bwd=path.flash,
        ln=path.ln_train + 2 * nb * remat_bert + 4 * 12 * m.layers * m.remat,
        ln_bwd=path.ln_train)


def measured_micro_step(torch, model, loss_fn, micro, seed):
    """One micro-step from counters at 0 and the peak memory reset: (loss,
    launches, peak GiB, ms on the host clock)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    loss = micro_step(model, loss_fn, micro, seed)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return (loss, read_launches(), torch.cuda.max_memory_allocated() / 2 ** 30,
            ms)


def phase_remat(torch, np, path: ModelPath, card: str):
    """The preset's own recompute (``remat``, its policies) at full width:
    one micro-step (batch 8, every dropout) with and without recompute on
    the same weights, batch and seeds; the recomputed one must give the
    same loss and gradients bit for bit, launch exactly what the
    structure says, and use less memory; a replay that draws fresh dropout
    seeds must change the gradients.  Then one train step at the preset's
    ``batch_sz`` (A = 1) with recompute."""
    from bpx_torch.ops.dropout import SeedStream
    from bpx_torch.train.steps import make_train_step
    from bpx_torch.train.optim import make_optimizer
    tag = f"[remat {path.name}]"
    exp = experiment(path, remat=True)
    m = exp.model
    model, loss_fn, _, batches = phase_trainer(torch, np, path, steps=1,
                                               remat=True)
    micro = {k: v[0] for k, v in batches[0].items()}
    seed = 0x5EED
    groups = grad_groups(model)
    runs = []
    for on in (False, False, True):     # the first one warms up
        set_remat(model, on)
        loss, got, peak, ms = measured_micro_step(torch, model, loss_fn,
                                                  micro, seed)
        runs.append((on, loss, got, peak, ms, flat_grads(torch, groups)))
    want = {False: dict(flash=path.flash, dropout=path.dropout,
                        flash_bwd=path.flash, ln=path.ln_train,
                        ln_bwd=path.ln_train),
            True: remat_launches(path, m)}
    for on, loss, got, peak, ms, _ in runs[1:]:
        print(f"{tag} micro-step (batch {BATCH}) {'with' if on else 'without'}"
              f" recompute (remat_policy {m.remat_policy}, BERT "
              f"{m.remat if m.remat_bert is None else m.remat_bert} / "
              f"{m.remat_policy_bert}): loss {loss:.6f}, {ms:.1f} ms (host "
              f"clock), peak memory {peak:.2f} GiB; launches {got}")
        check(got == want[on], f"{tag} launches {got}, expected {want[on]}")

    def differ(a, b):
        """The groups of ``a`` not equal to ``b``: bitwise, BERT's
        embeddings within REMAT_EMBED_TOL."""
        errs = {g: ((a[g] - b[g]).norm() / b[g].norm()).item()
                for g in groups}
        return {g: e for g, e in errs.items()
                if (e > REMAT_EMBED_TOL if g == "bert.embeddings"
                    else not torch.equal(a[g], b[g]))}, errs

    kept, again, redone = runs
    bad, errs = differ(again[5], kept[5])
    print(f"{tag} a rerun without recompute against the first: loss equal "
          f"{again[1] == kept[1]}, groups not bitwise equal: "
          f"{ {g: f'{e:.3g}' for g, e in errs.items() if e} }")
    check(again[1] == kept[1] and not bad,
          f"{tag} two runs of the micro-step differ: {bad}")
    bad, errs = differ(redone[5], again[5])
    print(f"{tag} with vs without recompute: loss equal "
          f"{redone[1] == again[1]}; groups not bitwise equal (relative "
          f"L2 error; BERT's embeddings limit {REMAT_EMBED_TOL}): "
          f"{ {g: f'{e:.3g}' for g, e in errs.items() if e} }")
    check(redone[1] == again[1] and not bad,
          f"{tag} recompute changed the loss or the gradients: {bad}")
    check(redone[3] < again[3],
          f"{tag} recompute did not lower the peak memory")
    at = SeedStream.at
    SeedStream.at = lambda self, count: self     # the replay draws on
    try:
        micro_step(model, loss_fn, micro, seed)
    finally:
        SeedStream.at = at
    bad, errs = differ(flat_grads(torch, groups), again[5])
    worst = max(errs, key=errs.get)
    print(f"{tag} planted fault, the replay draws fresh dropout seeds: "
          f"{len(bad)} groups differ, worst {worst} rel err "
          f"{errs[worst]:.3g}")
    check(errs[worst] > REMAT_EMBED_TOL and bad,
          f"{tag} the comparison misses a replay with fresh seeds")
    peaks = {False: again[3], True: redone[3]}
    del runs, kept, again, redone
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # one train step at the preset's batch size, with recompute
    bs = exp.data.batch_sz
    b = synthetic_batch(exp, bs, 500)
    rng = np.random.RandomState(501)
    b["target"] = (rng.rand(bs, m.n_classes) < 0.1).astype(np.float32)
    batch = {k: torch.from_numpy(v[None]).to("cuda") for k, v in b.items()}
    step = make_train_step(model, m.model, loss_fn,
                           make_optimizer(model.parameters(), LR),
                           grad_accum=1,
                           generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    loss = step(batch)["loss"].item()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = read_launches()
    print(f"{tag} one train step at the preset's batch_sz {bs} (A = 1) "
          f"with recompute: loss {loss:.6f}, {ms:.1f} ms (host clock, the "
          f"first step), peak memory {peak:.2f} GiB; launches {got}; card: "
          f"{card}")
    check(math.isfinite(loss), f"{tag} the batch-{bs} step's loss is {loss}")
    check(got == want[True], f"{tag} batch-{bs} step launches {got}")
    del model, step, batch
    torch.cuda.empty_cache()
    return dict(peak_gib=peaks, batch=bs, step_ms=ms, step_peak_gib=peak,
                planted_err=errs[worst])


# ---------------------------------------------------------------------------
# phase 16: hybrid early fusion, grouped encoder pairs, RAdam and bf16
# gradient accumulation
# ---------------------------------------------------------------------------

class _Recorder:
    """An optimizer that only keeps a copy of the gradients it is
    handed."""

    def __init__(self, params):
        self.params = list(params)
        self.seen = None

    def zero_grad(self, set_to_none=True):
        for p in self.params:
            p.grad = None

    def step(self):
        self.seen = [p.grad.clone() for p in self.params]


def phase_bf16_accum(torch, model, loss_fn, batch, path: ModelPath):
    """One A = 2 step's gradients with bf16 and with fp32 accumulation from
    the same weights, batch and dropout seeds, and each micro-batch's fp32
    gradient alone: the bf16 ones must differ from the fp32 ones (the
    option is on) and stay within BF16_ACCUM_ERR (|g1| + |g2|) of them
    elementwise (plus BF16_ACCUM_SLACK)."""
    from bpx_torch.ops.dropout import draw_base_seed
    from bpx_torch.train.steps import make_train_step
    params = list(model.parameters())

    def handed(accum_dtype):
        rec = _Recorder(params)
        make_train_step(model, model.config.model, loss_fn, rec,
                        grad_accum=TRAIN_A,
                        generator=torch.Generator().manual_seed(11),
                        accum_dtype=accum_dtype)(batch)
        return rec.seen

    got, exact = handed("bfloat16"), handed(None)
    gen = torch.Generator().manual_seed(11)
    seeds = [draw_base_seed(gen) for _ in range(TRAIN_A)]
    micro = []
    for i in range(TRAIN_A):
        micro_step(model, loss_fn, {k: v[i] for k, v in batch.items()},
                   seeds[i])
        micro.append([p.grad for p in params])
    model.zero_grad(set_to_none=True)
    differ = sum(not torch.equal(a, b) for a, b in zip(got, exact))
    worst, outside, rel = 0.0, 0, collections.defaultdict(float)
    names = [n for n, _ in model.named_parameters()]
    for n, a, b, g1, g2 in zip(names, got, exact, *micro):
        bound = (BF16_ACCUM_ERR * (g1.abs() + g2.abs()) * (1 + 2 ** -9)
                 + BF16_ACCUM_SLACK * b.abs().max())
        diff = (a - b).abs()
        outside += int((diff > bound).sum())
        worst = max(worst, (diff / bound.clamp_min(1e-30)).max().item())
        top = n.split(".")[0]
        rel[top] = max(rel[top], ((a - b).norm()
                                  / b.norm().clamp_min(1e-30)).item())
    print(f"[bf16 accum {path.name}] A={TRAIN_A}: {differ} of {len(params)}"
          f" gradients differ from fp32 accumulation; worst |bf16 - fp32| / "
          f"(BF16_ACCUM_ERR (|g1| + |g2|) + slack) {worst:.3g} (limit 1); "
          f"relative L2 difference by module, largest "
          f"{max(rel.values()):.3g}: " + ", ".join(
              f"{g} {e:.2g}" for g, e in sorted(rel.items())))
    check(differ > 0, "bf16 accumulation gave the fp32 gradients: the "
                      "option is not on")
    check(outside == 0, f"{outside} bf16-accumulated gradient entries "
                        f"outside the bf16 bound ({worst:.3g} of it)")
    return dict(differ=differ, of=len(params), bound_share=worst,
                max_rel_l2=max(rel.values()))


def recorded_steps():
    """A context recording (step, adaptive) of every RAdam parameter
    group's step (``radam.step_coefficients``), and the list it fills."""
    from bpx_torch.train import radam
    seen = []

    def spy(coefficients, step, b1, b2):
        out = coefficients(step, b1, b2)
        seen.append((step, out[3]))
        return out
    return wrapped_launch(radam, spy, "step_coefficients"), seen


def new_classes(counter, checked):
    """The classes of ``counter`` that no earlier phase held against the
    plain versions."""
    return {k: c for k, c in counter.items() if k not in checked}


def check_new_classes(torch, timer, gen, seen, checked, label):
    """Hold every class of a recording (``seen``: Counters by kind) that no
    earlier phase held against the plain versions, and add them to
    ``checked``; returns the rows by kind."""
    rows = {}
    for kind in ("flash", "flash_bwd", "ln", "ln_bwd"):
        new = new_classes(seen.get(kind, {}), checked[kind])
        if kind == "flash":
            rows[kind] = phase_flash(torch, timer, new, gen,
                                     label=f"flash {label}")
        elif kind == "flash_bwd":
            rows[kind] = phase_flash_bwd(torch, timer, new, gen,
                                         label=f"flash_bwd {label}")
        elif kind == "ln":
            rows[kind] = phase_layer_norm(torch, timer, new, gen,
                                          scalar_path=False)
        else:
            rows[kind] = phase_layer_norm_bwd(torch, timer, new, gen,
                                              scalar_path=False)
        checked[kind] |= set(new)
    return rows


def phase_options(torch, np, timer, gen, checked):
    """Phase 16: every flash kernel at 32 x 32, moviescope with ``hybrid``
    (RAdam) and with ``group_encoders`` (bf16 accumulation), iemocap with
    ``hybrid``.  ``checked``: the classes the earlier phases held against
    the plain versions, by kind; each recorded forward and micro-step holds
    its new classes against the plain versions and adds them."""
    out = {}
    # (d) every flash kernel at 32 x 32 (batch 8, causal), rate 0 and 0.1,
    # forward and backward, and the exact dropout masks there
    sweep = {(BATCH, H, 32, 32, D, True, False, 1, rate): 1
             for D, H in HEAD_DIMS for rate in (0.0, 0.1)}
    out["s_rows"] = phase_flash(torch, timer, sweep, gen,
                                label="flash 32x32")
    out["s_bwd_rows"] = phase_flash_bwd(torch, timer, sweep, gen,
                                        label="flash_bwd 32x32")
    for D, H in HEAD_DIMS:
        phase_mask_check(torch, gen, BATCH, H, 32, D)
    before = set(checked["flash"])
    checked["flash"] |= set(sweep)
    checked["flash_bwd"] |= set(sweep)
    # the rows of the classes first held here, by path ("h": hybrid, "g":
    # grouped) and kind
    new = {f"{tag}_{kind}": [] for tag in "hg"
           for kind in ("flash", "flash_bwd", "ln", "ln_bwd")}

    def hold(tag, seen, label):
        rows = check_new_classes(torch, timer, gen, seen, checked, label)
        for kind, r in rows.items():
            new[f"{tag}_{kind}"] += r

    # (a) moviescope, hybrid: its new classes (32 x 32, and the early
    # encoders' LayerNorms) against the plain versions, the served path,
    # one micro-step, 6 RAdam steps at A = 1
    path = MOVIESCOPE_HYBRID
    pred, reqs = phase_predictor(torch, path)
    flash_cls, ln_cls = record_forward(path, pred, reqs[0])
    new_f = new_classes(flash_cls, before)
    check(new_f and all(k[2:4] == (32, 32) for k in new_f),
          f"hybrid's new flash classes {sorted(new_f)}")
    hold("h", dict(flash=flash_cls, ln=ln_cls), "hybrid")
    out["h_served"] = phase_serve(torch, np, pred, reqs, False, path)
    del pred
    torch.cuda.empty_cache()
    model, loss_fn, step, batches = phase_trainer(
        torch, np, path, steps=RADAM_STEPS, optimizer="radam", accum=1)
    seen, out["h_micro"] = phase_micro_step(torch, model, loss_fn, batches,
                                            path)
    hold("h", seen, "hybrid")
    spy, radam_steps = recorded_steps()
    with spy, recording() as seen:
        out["h_trained"] = phase_train(torch, model, step, batches, False,
                                       path, accum=1)
    out["h_train_seen"] = seen
    adaptive = sorted(set(radam_steps))
    print(f"[train {path.name}] RAdam (step, adaptive) taken: {adaptive}; "
          f"losses {out['h_trained']['losses']}")
    check(adaptive == [(t, t >= 5) for t in range(1, RADAM_STEPS + 1)],
          f"RAdam's steps {adaptive}: the adaptive step must start at 5")
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()

    # (b) moviescope, group_encoders: the 2B classes against the plain
    # versions (each head dim's own kernel by the profiler), the served path,
    # one micro-step, bf16 against fp32 accumulation, 2 steps at A = 2 in bf16
    path = MOVIESCOPE_GROUPED
    pred, reqs = phase_predictor(torch, path)
    flash_cls, ln_cls = record_forward(path, pred, reqs[0])
    new_f = new_classes(flash_cls, checked["flash"])
    check(new_f and all(k[0] == 2 * BATCH for k in new_f),
          f"group_encoders' new flash classes {sorted(new_f)}")
    hold("g", dict(flash=flash_cls, ln=ln_cls), "grouped")
    out["g_served"] = phase_serve(torch, np, pred, reqs, False, path)
    del pred
    torch.cuda.empty_cache()
    model, loss_fn, step, batches = phase_trainer(torch, np, path,
                                                  accum_dtype="bfloat16")
    seen, out["g_micro"] = phase_micro_step(torch, model, loss_fn, batches,
                                            path)
    hold("g", seen, "grouped")
    out["g_accum"] = phase_bf16_accum(torch, model, loss_fn, batches[0],
                                      path)
    with recording() as seen:
        out["g_trained"] = phase_train(torch, model, step, batches, False,
                                       path)
    out["g_train_seen"] = seen
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()

    # (c) iemocap, hybrid: the 4-ary GMU, early encoders at head_dim 25 and
    # LayerNorms of 300; one request, one micro-step against the plain
    # path, one step at A = 2
    path = IEMOCAP_HYBRID
    pred, reqs = phase_predictor(torch, path, requests=1)
    flash_cls, ln_cls = record_forward(path, pred, reqs[0], 25)
    hold("h", dict(flash=flash_cls, ln=ln_cls), "iemocap hybrid")
    out["ih_served"] = phase_serve(torch, np, pred, reqs, False, path,
                                   faults=False)
    del pred
    model, loss_fn, step, batches = phase_trainer(torch, np, path, steps=1)
    seen, out["ih_micro"] = phase_micro_step(torch, model, loss_fn, batches,
                                             path)
    hold("h", seen, "iemocap hybrid")
    with recording() as seen:
        out["ih_trained"] = phase_train(torch, model, step, batches, False,
                                        path)
    out["ih_train_seen"] = seen
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    # the rows each summary takes: hybrid's at 32 x 32 and at its early
    # encoders' B x 32 rows, grouped's flash only (its LayerNorms run per
    # member, at moviescope's classes)
    shapes = {k: sorted(str(r["shape"]) for r in rows)
              for k, rows in new.items() if rows}
    print(f"[options] classes first held in phase 16 beside the sweep, by "
          f"path and kernel: {shapes}")
    check(new["h_ln"] and new["h_ln_bwd"]
          and all(r["shape"][0] == BATCH * 32
                  for r in new["h_ln"] + new["h_ln_bwd"])
          and all(r["shape"][1:3] == [32, 32]
                  for r in new["h_flash"] + new["h_flash_bwd"])
          and not (new["g_ln"] or new["g_ln_bwd"]),
          f"phase 16's new classes are not the expected ones: {shapes}")
    out.update(new)
    return out


# ---------------------------------------------------------------------------
# phase 17: the vmapped multi-seed step; phase 18: the task farm
# ---------------------------------------------------------------------------

#: iemocap's seeds in one vmapped step (the reference reports the mean of 5)
MULTISEED = (1, 2, 3, 4, 5)
MULTISEED_STEPS = 2
#: the seeds (by index) held against their own single-seed steps
MULTISEED_HELD = (0, 4)
#: the folded launch's planted faults, each a build of its own
SEED_FAULTS = {"every group hashes with group 0's seed":
               "-DBPX_PLANT_SEED_FAULT=1",
               "bh is not reduced to its group": "-DBPX_PLANT_SEED_FAULT=2"}
# a seed of the vmapped step against its own single-seed A = 1 step (same
# weights, batch and base seed): the loss (relative) and each module's
# gradient (relative L2).  The masks are the same bits; what differs is
# the rounding of batched GEMMs over the seeds against one seed's GEMMs.
# On an H100 (700 W) the sound step reads loss 2.7e-4 / 6.5e-4 and worst
# groups 0.0305 (seed 1, proj1) / 0.0136 (seed 5); the planted faults read
# 0.343 (group 0's seed everywhere) and 0.319 (bh not reduced) at seed 5
# and leave seed 1 as it was: the gradient limit sits at about the
# geometric mean of the sound and the nearer faulty reading (3.3x over,
# 3.2x under)
MULTISEED_LOSS_TOL = 1e-2
MULTISEED_GRAD_TOL = 0.1


def seed_grads(torch, state, names_by_group, index):
    """Seed ``index``'s gradient in the stacked state, one fp32 vector
    per group."""
    return {g: torch.cat([state.params[n].grad[index].float().flatten()
                          for n in names])
            for g, names in names_by_group.items()}


def single_seed_reference(torch, exp, loss_fn, state_dict, seed, batch,
                          steps: int = 1):
    """The port's single-seed A = 1 step (Adam) on ``state_dict`` with its
    base seed drawn from a generator seeded with ``seed``: the first step's
    loss, gradients by group and launches, and each step's host time."""
    from bpx_torch.models import get_model
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    model = get_model(exp.model, device="cuda").train()
    model.load_state_dict(state_dict)
    step = make_train_step(model, exp.model.model, loss_fn,
                           make_optimizer(model.parameters(), LR),
                           generator=torch.Generator().manual_seed(seed))
    micro = {k: v[None] for k, v in batch.items()}
    times = []
    for i in range(steps):
        zero_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(micro)["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            launches, first = read_launches(), loss
            refs = flat_grads(torch, grad_groups(model))
    return dict(loss=first, grads=refs, launches=launches, step_ms=times)


def probe(torch, state, loss_fn, batch):
    """One vmapped step that leaves the weights as they were (SGD at lr 0):
    its (S,) losses; the gradients stay in the stacked ``.grad``."""
    from bpx_torch.train.multiseed import make_multi_seed_train_step
    state.optimizer = torch.optim.SGD(list(state.params.values()), lr=0.0)
    step = make_multi_seed_train_step(state, loss_fn)
    return step(batch)["loss"].tolist()


def folded_timing(torch, timer, gen, S, B, H, T, D, padded, rate):
    """One folded launch over S groups against S launches, one a group,
    forward and backward (CUDA events)."""
    from bpx_torch.ops import flash_attention as fa
    q, k, v, kv_lens = attention_inputs(torch, gen, S * B, H, T, T, D,
                                        padded)
    masked = not padded
    seeds = [0x5EED + s for s in range(S)]
    part = lambda t, s: None if t is None else t[s * B:(s + 1) * B]
    out, lse = fa.flash_attention(q, k, v, masked, kv_lens, rate, seeds,
                                  return_lse=True)
    dout = torch.randn_like(out)
    fwd = lambda: fa.flash_attention(q, k, v, masked, kv_lens, rate, seeds)
    fwd_s = lambda: [fa.flash_attention(part(q, s), part(k, s), part(v, s),
                                        masked, part(kv_lens, s), rate,
                                        seeds[s]) for s in range(S)]
    bwd = lambda: fa._launch_bwd(q, k, v, dout, lse, out, masked, kv_lens,
                                 rate, seeds)
    bwd_s = lambda: [fa._launch_bwd(
        part(q, s), part(k, s), part(v, s), part(dout, s), part(lse, s),
        part(out, s), masked, part(kv_lens, s), rate, seeds[s])
        for s in range(S)]
    t = {name: timer(fn) for name, fn in (("fwd", fwd), ("fwd_s", fwd_s),
                                          ("bwd", bwd), ("bwd_s", bwd_s))}
    print(f"[multiseed] folded launch BH={S * B * H} {T}x{T} D={D} "
          f"kv_lens={padded} rate={rate}: forward {t['fwd']:.4f} ms against "
          f"{S} launches {t['fwd_s']:.4f} ms ({t['fwd'] / t['fwd_s']:.2f}x); "
          f"backward {t['bwd']:.4f} ms against {t['bwd_s']:.4f} ms "
          f"({t['bwd'] / t['bwd_s']:.2f}x)")
    return dict(shape=[S * B * H, T, T, D], kv_lens=padded, rate=rate, **t)


def replay_fault(torch, state, loss_fn, batch, names, refs):
    """A planted fault in the recompute under the seed vmap: each layer's
    replay draws seeds past its first pass's (the streams' ``at`` moved
    on the second time a layer asks for them), so the backward's dropout
    masks are not the forward's.  The held seeds' gradients must then
    differ from their own single-seed steps by more than the limit."""
    from bpx_torch.ops.dropout import SeedStreams
    at, asked = SeedStreams.at, collections.Counter()

    def drawn_on(self, count, axis=None):
        asked[id(self), count] += 1
        return at(self, count + 7 * (asked[id(self), count] > 1), axis)

    SeedStreams.at = drawn_on
    try:
        probe(torch, state, loss_fn, batch)
    finally:
        SeedStreams.at = at
    worst = {}
    for i in MULTISEED_HELD:
        e = relative_errors(torch, seed_grads(torch, state, names, i),
                            refs[i]["grads"])
        worst[MULTISEED[i]] = max(e.values())
    print(f"[multiseed] planted fault, the replay draws fresh dropout "
          f"seeds ({sum(v > 1 for v in asked.values())} layers replayed): "
          f"worst group by seed {worst}")
    check(max(worst.values()) > MULTISEED_GRAD_TOL,
          "the comparison with the single-seed steps misses a replay with "
          "fresh seeds")
    return worst


def phase_multiseed(torch, np, timer, gen, card):
    """Phase 17: iemocap's mmtrvat at full width and at its preset's own
    config (full recompute), S = 5 seeds in one vmapped step (micro-batch
    8 per seed, A = 1, bf16, every dropout, Adam)."""
    from bpx_torch.ops import _cuda
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.dispatch import plain_versions
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.multiseed import (init_multi_seed,
                                           make_multi_seed_train_step,
                                           unstack_seed)
    from bpx_torch.train.optim import make_optimizer
    tag = "[multiseed]"
    S = len(MULTISEED)
    exp = experiment(IEMOCAP, remat=True)
    t0 = time.time()
    state = init_multi_seed(exp.model, MULTISEED,
                            lambda ps: make_optimizer(ps, LR), device="cuda")
    rng = np.random.RandomState(7)
    freqs = rng.randint(30, 400, size=exp.model.n_classes)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), 1000, device="cuda")
    batches = [{k: v[0] for k, v in train_batch(
        torch, np, exp, 400 + i, freqs / 1000, accum=1).items()}
        for i in range(MULTISEED_STEPS)]
    names = collections.defaultdict(list)
    for n in state.params:
        names[group_of(n)].append(n)
    n_params = sum(p[0].numel() for p in state.params.values())
    print(f"{tag} {exp.model.model} ({IEMOCAP.preset}), {S} seeds "
          f"{MULTISEED} stacked: {n_params / 1e6:.1f} M parameters a seed, "
          f"{S * n_params / 1e6:.1f} M in all; micro-batch {BATCH} a seed, "
          f"A = 1, {exp.model.compute_dtype}, attention_impl "
          f"{exp.model.attention_impl}, remat {exp.model.remat}; built in "
          f"{time.time() - t0:.1f} s")

    # the planted faults' kernels, each a build of its own, built in the
    # background (each its nvcc processes side by side) while the work that
    # the host clock does not time runs
    t_build = time.time()
    pool = concurrent.futures.ThreadPoolExecutor(len(SEED_FAULTS))
    builds = [pool.submit(_cuda.build, [flag])
              for flag in SEED_FAULTS.values()]
    try:
        # the vmapped step with the kernels (weights kept), recorded
        fa.flash_attention.fold_copies = 0
        zero_launches()
        with recording() as seen:
            losses = probe(torch, state, loss_fn, batches[0])
        got = read_launches()
        kernel_grads = [seed_grads(torch, state, names, i) for i in range(S)]

        # against the same vmapped step on the plain versions
        with plain_versions():
            plain_losses = probe(torch, state, loss_fn, batches[0])
        plain = []
        for i in range(S):
            e = relative_errors(torch, kernel_grads[i],
                                seed_grads(torch, state, names, i))
            plain.append(max(e.values()))
        plain_loss = max(abs(a - b) / abs(b)
                         for a, b in zip(losses, plain_losses))
        print(f"{tag} kernels against plain versions, the same vmapped step: "
              f"loss rel err {plain_loss:.3g} (tol {IEMOCAP.loss_tol}), worst "
              f"group by seed " + ", ".join(f"{e:.3g}" for e in plain)
              + f" (tol {IEMOCAP.grad_tol})")
        check(plain_loss <= IEMOCAP.loss_tol
              and max(plain) <= IEMOCAP.grad_tol,
              "the vmapped step with the kernels differs from the plain one")
        state.optimizer.zero_grad(set_to_none=True)

        # the folded launches' masks, exactly
        masks = {D: phase_seed_masks(torch, gen, S, BATCH, 12, 512, D)
                 for D in (25, 64)}
    finally:
        pool.shutdown(wait=True)
    for build in builds:
        check(build.result().exists(), f"{tag} a planted-fault build is "
                                       f"missing")
    print(f"{tag} planted-fault builds, in the background, ready "
          f"{time.time() - t_build:.1f} s after they started")

    # seeds 0 and 4 on their own single-seed steps, from the same weights
    refs = {}
    for i in MULTISEED_HELD:
        refs[i] = single_seed_reference(
            torch, exp, loss_fn, unstack_seed(state, i)[0], MULTISEED[i],
            batches[0], steps=MULTISEED_STEPS if i == 0 else 1)
        torch.cuda.empty_cache()
    single = refs[0]["launches"]
    t_single, which = warm_steps(refs[0]["step_ms"])
    print(f"{tag} single-seed A = 1 step (seed {MULTISEED[0]}): "
          f"{t_single:.1f} ms, {which}; steps " + ", ".join(
              f"{x:.1f}" for x in refs[0]["step_ms"])
          + f"; launches {single}")
    structure = remat_launches(IEMOCAP, exp.model)
    check(single == structure, f"{tag} the single-seed step's launches "
                               f"{single}, expected {structure}")
    want = dict(flash=single["flash"], dropout=single["dropout"],
                flash_bwd=single["flash_bwd"], ln=S * single["ln"],
                ln_bwd=S * single["ln_bwd"])
    print(f"{tag} one vmapped step: launches {got}, expected {want} (flash "
          f"as one seed's micro-step, LayerNorm {S} x); tensors copied to "
          f"fold the seeds: {fa.flash_attention.fold_copies}, by the "
          f"wrappers: {dict(seen['copies'])}")
    check(got == want, f"the vmapped step's launches {got}, expected {want}")
    check(fa.flash_attention.fold_copies == 0
          and not sum(seen["copies"].values()),
          "the vmapped step copied tensors before a launch")
    errs = {}
    for i in MULTISEED_HELD:
        lerr = abs(losses[i] - refs[i]["loss"]) / abs(refs[i]["loss"])
        gerr = relative_errors(torch, kernel_grads[i], refs[i]["grads"])
        worst = max(gerr, key=gerr.get)
        errs[i] = dict(loss_err=lerr, grad_err=gerr[worst], worst=worst)
        print(f"{tag} seed {MULTISEED[i]} against its own single-seed step: "
              f"loss {losses[i]:.6f} vs {refs[i]['loss']:.6f} (rel err "
              f"{lerr:.3g}, tol {MULTISEED_LOSS_TOL}); worst group {worst} "
              f"rel err {gerr[worst]:.3g} (tol {MULTISEED_GRAD_TOL}); "
              + ", ".join(f"{g} {e:.3g}" for g, e in sorted(gerr.items())))
        check(lerr <= MULTISEED_LOSS_TOL and gerr[worst] <= MULTISEED_GRAD_TOL,
              f"seed {MULTISEED[i]} of the vmapped step differs from its own "
              f"step")
    del kernel_grads

    # the planted faults
    faults = {}
    lib = _cuda.library()
    t_wait = time.perf_counter()
    variants = {name: _cuda.load([flag]) for name, flag in SEED_FAULTS.items()}
    SPENT["fault_build_wait_s"] += time.perf_counter() - t_wait
    for name, variant in variants.items():
        _cuda._lib = variant
        try:
            probe(torch, state, loss_fn, batches[0])
        finally:
            _cuda._lib = lib
        worst = {}
        for i in MULTISEED_HELD:
            e = relative_errors(torch, seed_grads(torch, state, names, i),
                                refs[i]["grads"])
            worst[MULTISEED[i]] = max(e.values())
        faults[name] = worst
        print(f"{tag} planted fault, {name}: worst group by seed {worst}")
        check(max(worst.values()) > MULTISEED_GRAD_TOL,
              f"the comparison with the single-seed steps misses a planted "
              f"fault ({name})")
    faults["the replay draws fresh dropout seeds"] = replay_fault(
        torch, state, loss_fn, batches[0], names, refs)
    del refs
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # MULTISEED_STEPS Adam steps, counters from 0 before each
    state.optimizer = make_optimizer(list(state.params.values()), LR)
    step = make_multi_seed_train_step(state, loss_fn,
                                      with_grad_norm=True)
    totals = collections.Counter()
    times, all_losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording() as train_seen:
        for i, batch in enumerate(batches):
            zero_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(batch)
            step_losses = out["loss"].tolist()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            got = read_launches()
            totals.update(got)
            all_losses.append(step_losses)
            norms = out["grad_norm"].tolist()
            print(f"{tag} step {i + 1}: losses "
                  + ", ".join(f"{x:.5f}" for x in step_losses)
                  + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms)
                  + f"; {times[-1]:.1f} ms; launches {got}")
            check(got == want, f"step {i + 1} launches {got}, expected {want}")
            check(all(math.isfinite(x) for x in step_losses),
                  f"step {i + 1} losses {step_losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t_vmapped, which = warm_steps(times)
    speedup = S * t_single / t_vmapped
    print(f"{tag} vmapped step {t_vmapped:.1f} ms, {which}, {S} x the "
          f"single-seed A = 1 step "
          f"{S * t_single:.1f} ms: S * t_single / t_vmapped = {speedup:.3f}; "
          f"{S * BATCH / t_vmapped * 1e3:.2f} samples/s; peak "
          f"{peak:.2f} GiB (max_memory_allocated); card: {card}")

    # one folded launch against S launches at the two classes
    timing = [folded_timing(torch, timer, gen, S, BATCH, 12, 512, 25, False,
                            0.1),
              folded_timing(torch, timer, gen, S, BATCH, 12, 512, 64, True,
                            0.1)]
    del state, step
    torch.cuda.empty_cache()
    return dict(seen=seen, train_seen=train_seen, totals=totals,
                step_ms=times, median_ms=t_vmapped, single_ms=t_single,
                speedup=speedup, peak_gib=peak, losses=all_losses,
                seed_errors=errs, plain_grad_err=plain,
                plain_loss_err=plain_loss, planted_faults=faults,
                masks=masks, folded=timing)


#: phase 17's two-seed paths: mmimdb at its preset's own recompute
#: (save_attn in the encoders at head_dim 128, BERT in full) and mmtrvpa
#: at moviescope's widths (head_dim 192 in its memory encoders, no
#: recompute); their seeds
MULTISEED_PAIR = (1, 2)


def phase_multiseed_path(torch, np, timer, gen, path: ModelPath, card,
                         held):
    """Two seeds of ``path`` at its preset's own config in one vmapped
    step (micro-batch 8 a seed, every dropout, weights kept): launches
    exact against the structure (flash as one seed's micro-step, the
    replayed forwards included; LayerNorm S times), the encoders' flash
    forward once a call under ``save_attn``, the first seed against its
    own single-seed step within the path's limits, and every flash class
    (each direction) no earlier phase held against its plain version.
    ``held``: the classes held so far, by kind, which this extends (a copy
    of the script's: later phases hold their own).  Returns the recording,
    the rows and the errors."""
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.multiseed import init_multi_seed, unstack_seed
    tag = f"[multiseed {path.name}]"
    S = len(MULTISEED_PAIR)
    exp = experiment(path, remat=True)
    m = exp.model
    t0 = time.time()
    state = init_multi_seed(m, MULTISEED_PAIR,
                            lambda ps: torch.optim.SGD(ps, lr=0.0),
                            device="cuda")
    rng = np.random.RandomState(7)
    freqs = rng.randint(30, 400, size=m.n_classes)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), 1000, device="cuda")
    batch = {k: v[0] for k, v in train_batch(torch, np, exp, 450,
                                             freqs / 1000, accum=1).items()}
    names = collections.defaultdict(list)
    for n in state.params:
        names[group_of(n)].append(n)
    print(f"{tag} {m.model}, {S} seeds {MULTISEED_PAIR} stacked, micro-batch "
          f"{BATCH} a seed, {m.compute_dtype}, remat {m.remat} (policy "
          f"{m.remat_policy}, BERT {m.remat_policy_bert}); built in "
          f"{time.time() - t0:.1f} s")
    # seed 1 on its own single-seed step, from the same weights
    refs = [single_seed_reference(torch, exp, loss_fn,
                                  unstack_seed(state, 0)[0],
                                  MULTISEED_PAIR[0], batch)]
    structure = remat_launches(path, m)
    single = refs[0]["launches"]
    check(single == structure, f"{tag} the single-seed step's launches "
                               f"{single}, expected {structure}")
    want = dict(single, ln=S * single["ln"], ln_bwd=S * single["ln_bwd"])
    zero_launches()
    with recording() as seen:
        losses = probe(torch, state, loss_fn, batch)
    got = read_launches()
    per_dim = {D: dim_launches(seen, "flash", D)
               for D in sorted({c[4] for c in seen["flash"]})}
    print(f"{tag} one vmapped step: launches {got}, expected {want}; flash "
          f"forwards by head dim {per_dim}")
    check(got == want, f"{tag} launches {got}, expected {want}")
    if m.remat_policy == "save_attn":
        # BERT's 12 layers recompute in full, the encoders keep their flash
        # forwards: one launch a call
        enc = path.flash - 12
        check(got["flash"] - 2 * 12 == enc
              and sum(c for D, c in per_dim.items() if D != 64) == enc,
              f"{tag} the encoders' flash forwards ran {per_dim}, not once "
              f"a call ({enc})")
    errs = {}
    for i, seed in enumerate(MULTISEED_PAIR[:len(refs)]):
        lerr = abs(losses[i] - refs[i]["loss"]) / abs(refs[i]["loss"])
        gerr = relative_errors(torch, seed_grads(torch, state, names, i),
                               refs[i]["grads"])
        worst = max(gerr, key=gerr.get)
        errs[seed] = dict(loss_err=lerr, grad_err=gerr[worst], worst=worst)
        print(f"{tag} seed {seed} against its own single-seed step: loss "
              f"rel err {lerr:.3g} (tol {path.loss_tol}); worst group "
              f"{worst} {gerr[worst]:.3g} (tol {path.grad_tol})")
        check(lerr <= path.loss_tol and gerr[worst] <= path.grad_tol,
              f"{tag} seed {seed} differs from its own step")
    del state, refs
    torch.cuda.empty_cache()
    rows = check_new_classes(
        torch, timer, gen, {k: seen[k] for k in ("flash", "flash_bwd")},
        held, f"multiseed {path.name}")
    return dict(seen=seen, rows=rows, errors=errs)


#: the S = 20 vmapped flash call: more seeds than one launch takes
CHUNK_SEEDS, CHUNK_B, CHUNK_H, CHUNK_T, CHUNK_D = 20, 2, 12, 512, 25


def phase_seed_chunks(torch, timer, gen):
    """Phase 17's vmapped flash call over CHUNK_SEEDS seeds with dropout
    (rate 0.1, iemocap's narrow head): the vmap rule launches one folded
    call per chunk of at most 16 seed groups each way (counted); O, lse
    and the gradients against the plain version on the folded batch and
    bitwise against each seed's own launch; the keep bits of both
    directions (q = 0, one-hot V and dO, as ``phase_mask_check`` reads
    them) equal to each seed's plain bits; each chunk's class held and
    timed as every class is."""
    from torch.func import vmap
    from bpx_torch.ops import flash_attention as fa
    tag = "[seed chunks]"
    S, B, H, T, D, rate = (CHUNK_SEEDS, CHUNK_B, CHUNK_H, CHUNK_T, CHUNK_D,
                           0.1)
    seeds = [0xC0FFEE + 7919 * s for s in range(S)]
    bf = torch.bfloat16
    q, k, v, lens = attention_inputs(torch, gen, S * B, H, T, T, D, True)
    leaves = [t.unflatten(0, (S, B)).detach().requires_grad_()
              for t in (q, k, v)]
    lens = lens[:B]
    call = lambda a, b, c: fa.flash_attention(a, b, c, False, lens, rate,
                                              seeds, return_lse=True)
    zero_launches()
    with recording() as seen:
        out, lse = vmap(call)(*leaves)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(bf)
        grads = torch.autograd.grad(out, leaves, dout)
    got = read_launches()
    chunks = -(-S // fa.MAX_SEED_GROUPS)
    print(f"{tag} {S} seeds at (B {B}, H {H}, {T} x {T}, D {D}) under vmap: "
          f"launches {got}; classes {sorted(seen['flash'])}")
    check(got["flash"] == chunks and got["flash_bwd"] == chunks
          and all(c[7] <= fa.MAX_SEED_GROUPS for c in seen["flash"]),
          f"{tag} launches {got}, expected {chunks} chunks each way")
    flat = lambda t: t.detach().flatten(0, 1)
    ref, ref_lse = fa.flash_attention_reference(
        *(flat(t) for t in leaves), False, lens.repeat(S), rate, seeds)
    ref_grads = fa.flash_attention_backward_reference(
        *(flat(t) for t in leaves), flat(dout), ref_lse,
        fa.attention_delta_reference(flat(dout), ref), False,
        lens.repeat(S), rate, seeds)
    err_o, err_l = max_err(flat(out), ref), max_err(flat(lse), ref_lse)
    err_g = max(grad_err(flat(g), w) for g, w in zip(grads, ref_grads))
    differ = 0
    for s, seed in enumerate(seeds):
        one = [t[s].detach() for t in leaves]
        o1, l1 = fa.flash_attention(*one, False, lens, rate, seed,
                                    return_lse=True)
        g1 = fa.flash_attention_backward(*one, o1, l1, dout[s], False, lens,
                                         rate, seed)
        differ += int(not (torch.equal(out[s], o1) and torch.equal(lse[s], l1)
                           and all(torch.equal(g[s], w)
                                   for g, w in zip(grads, g1))))
    # the keep bits, both directions, every (query, key)
    zero = torch.zeros(S, B, H, T, D, device="cuda", dtype=bf)
    kk = leaves[1].detach()
    fwd = torch.zeros(S, B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    for r in range(-(-T // D)):
        c = j - D * r
        sel = (c >= 0) & (c < D)
        onehot = torch.zeros(T, D, device="cuda", dtype=bf)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(S, B, H, T, D).clone().requires_grad_()
        o = vmap(lambda a, b, c_: fa.flash_attention(
            a, b, c_, False, None, rate, seeds))(zero, kk, e)
        (dv,) = torch.autograd.grad(o, e, e.detach())
        fwd[..., sel] = o[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    bits = sum(int((fwd[s] != fa.keep_mask(seed, B, H, T, T, rate, "cuda"))
                   .sum()) + int((bwd[s] != fa.keep_mask(
                       seed, B, H, T, T, rate, "cuda")).sum())
               for s, seed in enumerate(seeds))
    torch.cuda.synchronize()
    print(f"{tag} against the plain version on the folded batch: O "
          f"{err_o:.3g} (tol {FLASH_TOL}), lse {err_l:.3g} (tol {LSE_TOL}), "
          f"gradients {err_g:.3g} (tol {FLASH_GRAD_TOL}); seeds differing "
          f"from their own launches (O, lse, dQ, dK, dV bitwise): {differ} "
          f"of {S}; keep bits differing from each seed's plain bits: {bits} "
          f"of {2 * fwd.numel()}")
    check(torch.allclose(flat(out).float(), ref.float(), **FLASH_TOL)
          and torch.allclose(flat(lse), ref_lse, **LSE_TOL)
          and err_g <= FLASH_GRAD_TOL and differ == 0 and bits == 0,
          f"{tag} the chunked call differs")
    del leaves, out, lse, grads, fwd, bwd
    rows = dict(flash=phase_flash(torch, timer, seen["flash"], gen,
                                  label="flash seed chunks"),
                flash_bwd=phase_flash_bwd(torch, timer, seen["flash_bwd"],
                                          gen, label="flash_bwd seed chunks"))
    return dict(seen=seen, rows=rows, launches=got, differ=differ,
                bits=bits)


#: phase 18's training jobs: the synthetic command of the README at one
#: epoch, the smallest the CLI trains
FARM_TRAIN_ARGV = [
    "--task", "synthetic", "--model", "mmtrvapt", "--batch_sz", "8",
    "--gradient_accumulation_steps", "2", "--max_epochs", "1",
    "--num_vectors_l", "32", "--num_vectors_a", "16", "--num_vectors_v",
    "16", "--orig_d_l", "64", "--orig_d_v", "48", "--orig_d_a", "96",
    "--orig_d_p", "40", "--hidden_sz", "64", "--num_heads", "4", "--layers",
    "2", "--max_seq_len", "32", "--audio_raw_len", "576", "--video_len",
    "16", "--compute_dtype", "float32", "--use_audio_encoder", "1", "--lr",
    "1e-3", "--patience", "5"]
FARM_LINE = re.compile(r"^(OK|FAIL\((-?\d+)\)) \[(\d+)s x(\d+)\] (.*)$")


def phase_farm(card: str):
    """Phase 18: ``python -m bpx_torch.cluster.scheduler`` over a jobs file
    of two training runs on the card and one line that exits 3, two
    workers, both on card 0, one retry."""
    import os
    import shlex
    tag = "[farm]"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train = [sys.executable, "-m", "bpx_torch.cli.train",
                 *FARM_TRAIN_ARGV, "--savedir", str(tmp / "runs")]
        fail_cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
        lines = [shlex.join(train + ["--name", f"farm{i}", "--from_seed",
                                     str(i + 1), "--to_seed", str(i + 1)])
                 for i in range(2)] + [shlex.join(fail_cmd)]
        jobs = tmp / "jobs.txt"
        # a job's log is named by its line in the file: 1, 2, 3
        jobs.write_text("# phase 18: two training runs and a failing line\n"
                        + "\n".join(lines) + "\n\n")
        logs = tmp / "logs"
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "bpx_torch.cluster.scheduler", str(jobs),
             "--workers", "2", "--log_dir", str(logs), "--max_retries", "1"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
        wall = time.time() - t0
        print(f"{tag} scheduler exit {proc.returncode} in {wall:.1f} s:\n"
              + proc.stdout.rstrip())
        results = {}
        for line in proc.stdout.splitlines():
            m = FARM_LINE.match(line)
            if m:
                results[m.group(5)] = dict(rc=int(m.group(2) or 0),
                                           seconds=int(m.group(3)),
                                           attempts=int(m.group(4)))
        check(proc.returncode == 1, f"the farm exited {proc.returncode}, "
                                    f"expected 1 (one job fails): "
                                    f"{proc.stderr[-2000:]}")
        check(set(results) == set(lines), f"the farm reported {results}")
        check(results[lines[2]] == dict(results[lines[2]], rc=3, attempts=2),
              f"the failing line: {results[lines[2]]}")
        log_files = sorted(p.name for p in logs.iterdir())
        check(log_files == [f"job{i:04d}.log" for i in (1, 2, 3)],
              f"job logs {log_files}")
        devices = []
        for i in range(2):
            check(results[lines[i]]["rc"] == 0
                  and results[lines[i]]["attempts"] == 1,
                  f"training job {i}: {results[lines[i]]}")
            text = (logs / f"job{i + 1:04d}.log").read_text()
            m = re.search(r"params on (\S+)", text)
            check(m is not None and m.group(1).startswith("cuda"),
                  f"training job {i}'s log does not name the card: "
                  f"{text[-1500:]}")
            devices.append(m.group(1))
        print(f"{tag} both training jobs rc 0 on {devices}, the failing line "
              f"rc 3 after 2 attempts, {len(log_files)} logs; card: {card}")
        return dict(wall_s=wall, results=list(results.values()),
                    devices=devices)


# ---------------------------------------------------------------------------
# phase 19: the notebook-era models at moviescope's full width
# ---------------------------------------------------------------------------

def legacy_path(model: str, flash: int, ln: int, ln_train: int,
                dropout: int) -> ModelPath:
    """moviescope's preset as ``model``, with the launches its structure
    gives per forward, held to moviescope's limits."""
    return dataclasses.replace(MOVIESCOPE, flash=flash, ln=ln,
                               ln_train=ln_train, dropout=dropout,
                               options=(("model", model),))


# launches per forward (counted from the structure, as
# tests/test_torch_legacy_train.py counts them on the CPU): BERT's 12
# attentions at head_dim 64 with dropout, 25 LayerNorms; mmtrvpa's six
# 4-layer crossmodal encoders (D 96; 3 LayerNorms a layer and a final one,
# one more a layer in training) and three 4-layer 1536-wide memory encoders
# (D 192, causal 512 x 512 and 200 x 200; 2 LayerNorms a layer and a final
# one; attention dropout 0.1); tmmtrvpa's twelve plain crossmodal encoders;
# dropout in the encoders keyed by l (attn_dropout 0.1: 2 of each round)
MMTRVPA = legacy_path("mmtrvpa", 12 + 24 + 12, 25 + 6 * 13 + 3 * 9,
                      25 + 6 * 17 + 3 * 9, 12 + 2 * 4 + 3 * 4)
TMMTRVPA = legacy_path("tmmtrvpa", 12 + 48, 25 + 12 * 13, 25 + 12 * 17,
                       12 + 2 * 4 * 2)
#: phase 17's export of mmtrvpa: moviescope's widths (head_dim 192 in the
#: memory encoders) at one layer a crossmodal encoder, so three a memory
#: encoder (max(layers, 3)), for the script's time limit
MMTRVPA_EXPORT = dataclasses.replace(
    MMTRVPA, flash=12 + 6 + 3 * 3, ln=25 + 6 * 4 + 3 * 7,
    ln_train=25 + 6 * 5 + 3 * 7, dropout=12 + 2 + 3 * 3,
    options=(("model", "mmtrvpa"), ("layers", 1)))
LEGACY_SERVED = [MMTRVPA, TMMTRVPA] + [
    legacy_path(m, 12, 25, 25, 12)
    for m in ("gmu", "gmu_bi", "gmu_hier", "gmu_softmax", "bertclf")]
#: flash launches per served forward by head dim
LEGACY_DIMS = {"mmtrvpa": {64: 12, 96: 24, 192: 12},
               "tmmtrvpa": {64: 12, 96: 48}}
#: the models trained, and the planted backward faults each micro-step
#: must catch (both are run and read on each).  A backward without its
#: dropout mask moves mmtrvpa's gradients less than bf16 rounding moves its
#: worst group (on an H100: bert.layers 0.028 -> 0.046 relative L2 while
#: trans_l_with_v reads 0.0525 either way; its memory encoders feed the
#: head through the last token alone), so only the band fault is required
#: of the models with encoders; the GMU classifiers attend only in BERT,
#: which has no band
BAND_FAULT = ("flash backward ignores the band",)
#: the timed steps of each notebook-era model trained in phases 19 and 20
#: (two, for the script's time limit)
LEGACY_STEPS = 1
LEGACY_TRAINED = {"mmtrvpa": BAND_FAULT, "tmmtrvpa": BAND_FAULT,
                  "gmu_hier": ()}
#: bertclf and its alias bert, the same class on the same seed
ALIAS_TOL = 1e-6
LEGACY_CLI_ARGV = (["--model", "mmtrvpa"] + LOOP_ARGV[2:]
                   + ["--use_audio_encoder", "1", "--max_epochs", "1"])


def width_launches(seen, kind, E) -> int:
    """Calls of a LayerNorm kernel ("ln", "ln_bwd") at width E in a
    recording."""
    return sum(c for cls, c in seen[kind].items() if cls[1] == E)


def phase_legacy_cli(np, card: str):
    """``python -m bpx_torch.cli.train --model mmtrvpa`` on a written
    moviescope dataset (the loop phase's), one epoch on the card: rc 0, a
    log naming the card and an epoch's stats (its line under ``log``: it
    runs beside other phases)."""
    import os
    tag = "[legacy cli]"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_moviescope(np, tmp / "data", seed=1)
        argv = LEGACY_CLI_ARGV + ["--data_path", str(tmp / "data"),
                                  "--savedir", str(tmp / "runs"),
                                  "--name", "mmtrvpa"]
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "bpx_torch.cli.train", *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
        wall = time.time() - t0
        check(proc.returncode == 0, f"{tag} exit {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        run = tmp / "runs" / "mmtrvpa_Seed1_run"
        text = (run / "logfile.log").read_text()
        m = re.search(r"params on (\S+)", text)
        check(m is not None and m.group(1).startswith("cuda"),
              f"{tag} the log does not name the card: {text[-1500:]}")
        stats = epoch_stats(run)
        check(len(stats) == 1, f"{tag} {len(stats)} epochs logged")
        line = (f"{tag} python -m bpx_torch.cli.train --model mmtrvpa (one "
                f"epoch, {LOOP_SPLITS['train']} records, micro-batch {BATCH} "
                f"x A={TRAIN_A}): rc 0 in {wall:.1f} s on {m.group(1)}; "
                f"epoch stats {stats[0]}; card: {card}")
        return dict(wall_s=wall, epoch=stats[0], log=line)


def phase_legacy(torch, np, timer, gen, card, checked, cli):
    """Phase 19: the notebook-era models at moviescope's full width (bf16,
    seeded weights).  Each of the seven classes served (2 requests at
    batch 8, one ragged, against the plain path, exact counters), bert
    against bertclf; mmtrvpa, tmmtrvpa and gmu_hier trained (one micro-step
    against the plain path, one Adam step at 8 x A = 2 with exact
    counters); every class no earlier phase held (the head_dim-192 flash
    kernels, the 1536-wide LayerNorms) against its plain version, and the
    exact dropout masks at head_dim 192; ``cli``, the result of one CLI
    run of mmtrvpa (``phase_legacy_cli``), is kept with them.
    ``checked``: the classes held so far, by kind, which this extends."""
    out = {"served": {}, "micro": {}, "trained": {}, "train_seen": {},
           "rows": collections.defaultdict(list)}

    def hold(seen, label):
        rows = check_new_classes(torch, timer, gen, seen, checked, label)
        for kind, r in rows.items():
            out["rows"][kind] += r

    for path in LEGACY_SERVED:
        name = dict(path.options)["model"]
        pred, reqs = phase_predictor(torch, path)
        flash_cls, ln_cls = record_forward(
            path, pred, reqs[0], dims=LEGACY_DIMS.get(name, {64: 12}))
        hold(dict(flash=flash_cls, ln=ln_cls), name)
        if name == "mmtrvpa":
            served_d192 = [k for k in flash_cls if k[4] == 192]
        out["served"][name] = phase_serve(torch, np, pred, reqs, False, path,
                                          faults=False)
        if name == "bertclf":
            # "bert" names the same class: the same weights from the seed
            alias = dataclasses.replace(path, options=(("model", "bert"),))
            apred, _ = phase_predictor(torch, alias, requests=0)
            err = max(float(np.abs(a - b).max(initial=0.0))
                      for r in reqs for a, b in zip(
                          apred(r, return_gates=True),
                          pred(r, return_gates=True)))
            print(f"[serve {alias.name}] against bertclf on the same "
                  f"requests: max err {err:.3g} (tol {ALIAS_TOL})")
            check(err <= ALIAS_TOL, f"bert differs from bertclf by {err}")
            del apred
        del pred
        torch.cuda.empty_cache()

    for path in LEGACY_SERVED:
        name = dict(path.options)["model"]
        if name not in LEGACY_TRAINED:
            continue
        model, loss_fn, step, batches = phase_trainer(torch, np, path,
                                                      steps=LEGACY_STEPS)
        seen, out["micro"][name] = phase_micro_step(
            torch, model, loss_fn, batches, path,
            must_catch=LEGACY_TRAINED[name])
        hold(seen, f"{name} micro-step")
        with recording() as tseen:
            out["trained"][name] = phase_train(torch, model, step, batches,
                                               False, path)
        out["train_seen"][name] = tseen
        del model, loss_fn, step, batches
        torch.cuda.empty_cache()

    # the head_dim-192 backward at the served classes (rate 0) too, which
    # no train step runs (the memory encoders drop attention at 0.1): held
    # and timed beside the trained ones, of weight 0 in the launches' mix
    out["rows"]["flash_bwd"] += phase_flash_bwd(
        torch, timer, dict.fromkeys(served_d192, 0), gen,
        label="flash_bwd mmtrvpa rate 0")
    checked["flash_bwd"] |= set(served_d192)
    # the exact dropout masks of the memory encoders' head dim; the
    # 1536-wide LayerNorm backward's scalar kernel on misaligned views (the
    # aligned classes above take the vector kernel with two warps a row, by
    # the profiler)
    phase_mask_check(torch, gen, BATCH, 8, 512, 192)
    ln_bwd_scalar_view(torch, gen, 133, 1536)
    rows = out["rows"]
    check(dim_rows(rows["flash"], 192) and dim_rows(rows["flash_bwd"], 192)
          and [r for r in rows["ln"] if r["shape"][1] == 1536]
          and [r for r in rows["ln_bwd"] if r["shape"][1] == 1536],
          "phase 19 held no head_dim-192 flash class or no 1536-wide "
          "LayerNorm class against its plain version")
    out["cli"] = cli
    return out


# ---------------------------------------------------------------------------
# phase 20: mmtrvpa at the presets other than moviescope
# ---------------------------------------------------------------------------

def mmtrvpa_path(base: ModelPath, layers: int) -> ModelPath:
    """``base``'s preset as mmtrvpa (only ``model`` changed), held to the
    preset's limits, with the launches its structure gives per forward:
    BERT's 12 attentions at head_dim 64 (dropout in each) and 25
    LayerNorms; six ``layers``-layer crossmodal encoders at hidden / heads
    (3 LayerNorms a layer and a final one, one more a layer in training,
    dropout in the two l-keyed ones: attn_dropout 0.1); three 2E-wide
    memory encoders of max(layers, 3) = ``layers`` layers at 2E / heads (2
    LayerNorms a layer and a final one, dropout at attn_dropout)."""
    ln = 25 + 6 * (3 * layers + 1) + 3 * (2 * layers + 1)
    return dataclasses.replace(
        base, flash=12 + 6 * layers + 3 * layers, ln=ln,
        ln_train=ln + 6 * layers, dropout=12 + 2 * layers + 3 * layers,
        options=(("model", "mmtrvpa"),))


# iemocap and cmu-mosei: 8 layers, 84 flash launches (48 at the crossmodal
# head dim, 24 at the memory's), 226 / 274 LayerNorms, 52 with dropout;
# mmimdb: 4 layers, 48 (24, 12), 130 / 154, 32.  Each is held to its
# preset's limits, but iemocap's micro-step gradients to mmtrvpa's (the
# limit phase 19 holds it to): on an H100 (700 W) its sound kernels read
# 0.172 against the plain path (proj1) where the plain bf16 path is itself
# 0.217 from the fp32 step and the kernels 0.141; the dropout-mask fault
# reads 0.172 too (the memory encoders reach the head through the last
# token alone, as at moviescope), the band fault non-finite
VPA_IEMOCAP = dataclasses.replace(mmtrvpa_path(IEMOCAP, 8),
                                  grad_tol=GRAD_TOL)
VPA_CMU_MOSEI = mmtrvpa_path(CMU_MOSEI, 8)
VPA_MMIMDB = mmtrvpa_path(MMIMDB, 4)
#: flash launches per served forward by head dim
VPA_DIMS = {"iemocap": {64: 12, 25: 48, 50: 24},
            "cmu-mosei": {64: 12, 30: 48, 60: 24},
            "mmimdb": {64: 12, 128: 24, 256: 12}}
#: (memory head dim, heads) of each path: the new classes held both ways
#: at 512 x 512 causal, rate 0 and 0.1, and their exact masks
VPA_MEMORY = {"iemocap": (50, 12), "cmu-mosei": (60, 10), "mmimdb": (256, 6)}
#: the paths trained in full (a micro-step against the plain path with the
#: band fault planted, then TRAIN_STEPS steps); cmu-mosei one step
VPA_TRAINED = ("iemocap", "mmimdb")


def phase_mmtrvpa(torch, np, timer, gen, checked):
    """Phase 20: mmtrvpa at iemocap, cmu-mosei and mmimdb (memory head dims
    50, 60 and 256), each the preset with only ``model`` changed, at full
    width and depth (bf16, seeded weights): 2 requests at batch 8 (one
    ragged) against the plain path within the preset's limits, exact
    counters; iemocap and mmimdb trained (a micro-step against the plain
    path with the band fault planted, one Adam step at 8 x A = 2 with every
    dropout and exact counters), cmu-mosei one step; every class no earlier
    phase held (the memory encoders' flash classes both ways at rate 0 and
    0.1, the 600-wide LayerNorms) against its plain version, timed; the
    exact masks at the three memory classes.  ``checked``: the classes held
    so far, by kind, which this extends."""
    out = {"served": {}, "micro": {}, "trained": {}, "train_seen": {},
           "rows": collections.defaultdict(list)}

    def hold(seen, label):
        rows = check_new_classes(torch, timer, gen, seen, checked, label)
        for kind, r in rows.items():
            out["rows"][kind] += r

    for path in (VPA_IEMOCAP, VPA_CMU_MOSEI, VPA_MMIMDB):
        pred, reqs = phase_predictor(torch, path)
        flash_cls, ln_cls = record_forward(path, pred, reqs[0],
                                           dims=VPA_DIMS[path.preset])
        hold(dict(flash=flash_cls, ln=ln_cls), path.name)
        out["served"][path.preset] = phase_serve(torch, np, pred, reqs, False,
                                                 path, faults=False)
        del pred
        torch.cuda.empty_cache()

    for path in (VPA_IEMOCAP, VPA_CMU_MOSEI, VPA_MMIMDB):
        full = path.preset in VPA_TRAINED
        model, loss_fn, step, batches = phase_trainer(
            torch, np, path, steps=LEGACY_STEPS if full else 1)
        if full:
            seen, out["micro"][path.preset] = phase_micro_step(
                torch, model, loss_fn, batches, path, must_catch=BAND_FAULT)
            hold(seen, f"{path.name} micro-step")
        with recording() as tseen:
            out["trained"][path.preset] = phase_train(torch, model, step,
                                                      batches, False, path)
        out["train_seen"][path.preset] = tseen
        if not full:
            hold({k: {c: n // TRAIN_A for c, n in tseen[k].items()}
                  for k in ("flash", "flash_bwd", "ln", "ln_bwd")},
                 f"{path.name} step")
        del model, loss_fn, step, batches
        torch.cuda.empty_cache()

    # the memory classes both ways at rate 0 and 0.1: those no recorded run
    # brought (the backward at rate 0: the memory encoders drop attention at
    # 0.1 in training) held of weight 0 in the launches' mix
    # (also the kernels built for two seed groups, as a multi-seed step
    # launches them, and their masks)
    for preset, (D, H) in VPA_MEMORY.items():
        groups = (1, 2)
        for rate, n in [(0.0, 1), (0.1, 1)] + [(0.1, g) for g in groups[1:]]:
            cls = (BATCH, H, 512, 512, D, True, False, n, rate)
            for kind, phase in (("flash", phase_flash),
                                ("flash_bwd", phase_flash_bwd)):
                if cls not in checked[kind]:
                    out["rows"][kind] += phase(
                        torch, timer, {cls: 0}, gen,
                        label=f"{kind} mmtrvpa {preset} rate {rate}")
                    checked[kind].add(cls)
        phase_mask_check(torch, gen, BATCH, H, 512, D)
        for n in groups[1:]:
            phase_seed_masks(torch, gen, n, BATCH // n, H, 512, D)
    rows = out["rows"]
    for D, _ in VPA_MEMORY.values():
        check(dim_rows(rows["flash"], D) and dim_rows(rows["flash_bwd"], D),
              f"phase 20 held no head_dim-{D} flash class both ways")
    check([r for r in rows["ln"] if r["shape"][1] == 600]
          and [r for r in rows["ln_bwd"] if r["shape"][1] == 600],
          "phase 20 held no 600-wide LayerNorm class both ways")
    return out


# ---------------------------------------------------------------------------
# phase 21: the mesh -- the sharded trainer at world size 1 (DDP and FSDP2),
# the placed flash kernels, and the stress preset
# ---------------------------------------------------------------------------

#: the mesh phase's steps a trainer (two, for the script's time limit)
MESH_STEPS = 2
#: the world-size-1 DDP and FSDP2 steps against the one-process step,
#: beside the micro-step limits: the loss's and the worst gradient
#: group's relative error.  Sound readings are 0 and 3.2e-7 (atomics in
#: BERT's embedding backward); a dropped micro-batch or a wrong share of
#: the loss moves both by a part in a few, not in 10^5
MESH_TOL = 1e-5
#: the placed-kernel check's families at a preset's class: (family, B, H,
#: T, D): iemocap's narrow heads, moviescope's BERT, mmimdb's wide heads,
#: mmtrvpa's tall memory heads at moviescope's widths
PLACED_FAMILIES = (("narrow", 8, 12, 512, 25), ("base", 8, 12, 512, 64),
                   ("wide", 8, 6, 512, 128), ("tall", 8, 8, 512, 192))
# the stress preset (BERT-large's 24 layers, 12 encoders x 12 layers of
# hidden 1024 over 16 heads): flash 24 + 6 x 12 first-round + 6 x 12 x 2
# biprojection; LayerNorm BERT's 1 + 2 x 24 and 3 per encoder layer plus a
# final one, training one more per encoder layer; dropout in BERT's 24
# attentions and the 4 encoders keyed by l, as moviescope's
STRESS = ModelPath("stress", 24 + 6 * 12 + 6 * 12 * 2,
                   1 + 2 * 24 + 12 * (12 * 3 + 1),
                   1 + 2 * 24 + 12 * (12 * 3 + 1) + 12 * 12,
                   24 + 2 * 12 + 2 * 12 * 2, PROBS_TOL, GATES_TOL)
STRESS_BERT_LAYERS = 24
#: micro-batch x A of the stress step, tried in turn until one fits: the
#: preset's batch_sz of 64 rows each time
STRESS_LAYOUTS = ((64, 1), (32, 2), (16, 4), (8, 8))
#: the stress step's classes (64 x 16 blocks of up to 1024 x 1024 scores)
#: take the plain versions in placed chunks of 8 batch rows, timed over
#: 3 single calls
STRESS_PLAIN = dict(plain_rows=8, plain_timing=dict(reps=3, inner=1,
                                                     warmup=1))


def start_mesh(torch, tmp: Path):
    """An NCCL process group of world size 1 from a file store, and its
    (1, 1, 1) mesh."""
    import torch.distributed as dist
    from bpx_torch.config import MeshConfig
    from bpx_torch.parallel.mesh import initialize_distributed, make_mesh
    world = initialize_distributed("cuda", init_method=f"file://{tmp}/store",
                                   world=1, rank_=0)
    check(world == 1 and dist.get_backend() == "nccl",
          f"process group: world {world}, backend {dist.get_backend()}")
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=1), "cuda")
    print(f"[mesh] NCCL process group of world size {world}; mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return mesh


def whole_grads(torch, model):
    """Each ``group_of`` group's gradients as one fp32 vector, whatever the
    placement (FSDP2's shards and the tensor split's parts made whole;
    collective on a mesh)."""
    from bpx_torch.parallel.sharding import full_gradients
    groups = collections.defaultdict(list)
    for n, g in full_gradients(model).items():
        groups[group_of(n)].append(g.float().flatten())
    return {k: torch.cat(v) for k, v in groups.items()}


#: the kinds of trainer phase 21 runs a path through, the one-process
#: step first
MESH_KINDS = ("one process", "DDP", "FSDP2")


def phase_mesh_steps(torch, np, mesh, path=MOVIESCOPE, kinds=MESH_KINDS,
                     steps=MESH_STEPS):
    """The path's model (moviescope's mmtrvapt by default) at full width
    and depth (bf16, micro-batch 8 x A = 2, Adam, every dropout) through
    the trainer ``kinds`` ways from the same weights, batches and dropout
    seeds: one process, DDP and FSDP2 on the world-size-1 mesh.  Step 1 of
    each sharded run is held to the micro-step limits against the
    one-process step (loss, per-group gradients) and to ``MESH_TOL``;
    each of the ``steps`` steps' launches is exact."""
    from bpx_torch.models import get_model
    from bpx_torch.parallel import sharding
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    exp = experiment(path)
    m = exp.model
    rng = np.random.RandomState(7)
    n_train = 1000
    freqs = rng.randint(30, 400, size=m.n_classes)
    batches = [train_batch(torch, np, exp, 300 + i, freqs / n_train)
               for i in range(steps)]
    want = dict(flash=path.flash * TRAIN_A, dropout=path.dropout * TRAIN_A,
                flash_bwd=path.flash * TRAIN_A, ln=path.ln_train * TRAIN_A,
                ln_bwd=path.ln_train * TRAIN_A)
    out, ref = {}, None
    for kind in kinds:
        model = get_model(m, device="cuda", seed=0).train()
        on_mesh = kind != "one process"
        if on_mesh:
            model = sharding.shard_model(model, mesh,
                                         use_fsdp=kind == "FSDP2")
        loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                               freqs.tolist(), n_train, device="cuda",
                               groups=sharding.dp_groups(mesh)
                               if on_mesh else ())
        opt = make_optimizer(model.parameters(), LR)
        step = make_train_step(model, m.model, loss_fn, opt,
                               grad_accum=TRAIN_A,
                               generator=torch.Generator().manual_seed(0),
                               mesh=mesh if on_mesh else None)
        times, losses = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches):
            zero_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(step(batch)["loss"].item())
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            got = read_launches()
            check(got == want, f"[mesh] {kind} step {i + 1} launches {got}, "
                               f"expected {want}")
            check(math.isfinite(losses[-1]), f"[mesh] {kind} loss "
                                             f"{losses[-1]}")
            if i == 0:
                grads = whole_grads(torch, model)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med, which = warm_steps(times)
        entry = dict(median_ms=med, step_ms=times, losses=losses,
                     peak_gib=peak)
        if ref is None:
            ref = (losses[0], grads)
        else:
            lerr = abs(losses[0] - ref[0]) / abs(ref[0])
            errs = relative_errors(torch, grads, ref[1])
            worst = max(errs, key=errs.get)
            entry.update(loss_err=lerr, grad_err=errs[worst])
            print(f"[mesh] {path.name} {kind} step 1 vs the one-process "
                  f"step: loss rel err {lerr:.3g} (tol {path.loss_tol}; "
                  f"{MESH_TOL}), worst "
                  f"gradient group {worst} {errs[worst]:.3g} (tol "
                  f"{path.grad_tol}; {MESH_TOL})")
            check(lerr <= min(path.loss_tol, MESH_TOL)
                  and errs[worst] <= min(path.grad_tol, MESH_TOL),
                  f"the {path.name} {kind} step differs from the "
                  f"one-process step")
        print(f"[mesh] {path.name} {kind}: launches per step {want}; step "
              f"times (host clock, synchronised) " + ", ".join(
                  f"{x:.1f}" for x in times) + f" ms, "
              f"{entry['median_ms']:.1f} ms {which}; losses " + ", ".join(
                  f"{x:.6f}" for x in losses) + f"; peak {peak:.2f} GiB")
        out[kind] = entry
        del model, opt, step, grads
        torch.cuda.empty_cache()
    return out


def phase_placed(torch, gen):
    """The flash kernels' block placement, per family: a global forward
    and backward with dropout at (B, H, T, T, D), then the (B/2, H/2) piece
    a rank of a data=2 x tensor=2 mesh holds (rows B/2.., heads H/2..) at
    its placement.  The piece's O, lse, dQ, dK, dV and both kernels' mask
    bits must equal the global call's slice bit for bit, and match the
    plain version with the same placement; the piece unplaced must
    differ."""
    from bpx_torch.ops import flash_attention as fa
    rate, seed = 0.1, 0x2545F491
    bf = torch.bfloat16
    rows = []
    for family, B, H, T, D in PLACED_FAMILIES:
        b_off, h_off = B // 2, H // 2
        place = (b_off, h_off, H)
        sl = (slice(b_off, B), slice(h_off, H))
        q, k, v, do = (torch.randn(B, H, T, D, generator=gen,
                                   device="cuda").to(bf) for _ in range(4))
        q = q * D ** -0.5
        out, lse = fa.flash_attention(q, k, v, True, None, rate, seed,
                                      return_lse=True)
        grads = fa.flash_attention_backward(q, k, v, out, lse, do, True,
                                            None, rate, seed)
        pq, pk, pv, pdo = (t[sl] for t in (q, k, v, do))
        pout, plse = fa.flash_attention(pq, pk, pv, True, None, rate, seed,
                                        return_lse=True, place=place)
        pgrads = fa.flash_attention_backward(pq, pk, pv, pout, plse, pdo,
                                             True, None, rate, seed, place)
        differ = {n: int((got != want[sl]).sum()) for n, got, want in zip(
            ("O", "lse", "dQ", "dK", "dV"), (pout, plse, *pgrads),
            (out, lse, *grads))}
        unplaced = int((fa.flash_attention(pq, pk, pv, True, None, rate,
                                           seed) != out[sl]).sum())
        # a placed call takes the build for seed groups; the one-group
        # build is the code it was before placement
        takes_kernel(torch, lambda: fa.flash_attention(
            pq, pk, pv, True, None, rate, seed, place=place),
            fwd_kernel(D, groups=2), (B - b_off, H - h_off, T, T, D, rate))
        ref, ref_lse = fa.flash_attention_reference(pq, pk, pv, True, None,
                                                    rate, seed, place)
        rgrads = fa.flash_attention_backward_reference(
            pq, pk, pv, pdo, plse, fa.attention_delta_reference(pdo, pout),
            True, None, rate, seed, place)
        err_o, err_l = max_err(pout, ref), max_err(plse, ref_lse)
        err_g = max(grad_err(g, r) for g, r in zip(pgrads, rgrads))
        q0 = torch.zeros_like(q)
        f_g, b_g, same_g = kernel_mask(torch, q0, k, rate, seed)
        f_p, b_p, same_p = kernel_mask(torch, q0[sl], k[sl], rate, seed,
                                       place)
        keep = fa.keep_mask(seed, B - b_off, H - h_off, T, T, rate, "cuda",
                            place)
        bits = dict(forward=int((f_p != f_g[sl]).sum()),
                    backward=int((b_p != b_g[sl]).sum()),
                    plain=int((f_p != keep).sum()) + int((b_p != keep).sum()))
        torch.cuda.synchronize()
        print(f"[placed] {family} D={D}: ({B}, {H}, {T}, {T}) and its piece "
              f"rows {b_off}.. heads {h_off}.. at place {place}: elements "
              f"differing from the global call's slice {differ}; mask bits "
              f"differing (of {keep.numel()}): {bits}; unplaced piece O "
              f"differs in {unplaced}; against the plain version with the "
              f"placement: O {err_o:.3g}, lse {err_l:.3g}, gradients "
              f"{err_g:.3g} (of the largest entry)")
        check(not any(differ.values()) and not any(bits.values())
              and same_g and same_p and unplaced > 0,
              f"the placed piece at head_dim {D} is not the global call's "
              f"slice")
        check(torch.allclose(pout.float(), ref.float(), **FLASH_TOL)
              and torch.allclose(plse, ref_lse, **LSE_TOL)
              and err_g <= FLASH_GRAD_TOL,
              f"the placed piece at head_dim {D} differs from the plain "
              f"version")
        rows.append(dict(family=family, D=D, shape=[B, H, T, T],
                         place=list(place), differ=differ, bits=bits,
                         unplaced=unplaced))
    return rows


#: the placed pair check's classes: (family, B, H, T, D) of one member of
#: a grouped pair, whose call folds the two members into 2 x B rows:
#: iemocap's mmtrvat pairs (head_dim 25) and moviescope's (96)
PLACED_PAIRS = (("narrow", 8, 12, 512, 25), ("base", 8, 8, 512, 96))


def pair_piece(torch, t, b_off, h_off, B):
    """A data=2 x tensor=2 rank's piece of a grouped pair's folded (2 x B,
    H, ...) tensor: each member's rows b_off..B and heads h_off.., the
    members stacked again (a copy of the rows, a view of the heads)."""
    rows = torch.cat([torch.arange(m * B + b_off, (m + 1) * B,
                                   device=t.device) for m in range(2)])
    return t[rows][:, h_off:]


def phase_placed_pairs(torch, timer, gen):
    """A grouped pair's placed flash calls, per family: a global forward
    and backward with dropout over the pair's folded 2 x B rows, then the
    piece a data=2 x tensor=2 rank holds (each member's rows B/2.., heads
    H/2..) as the pair calls it: two seed groups of the one seed, member
    m's blocks ``m * B * H`` global blocks on (place (B/2, H/2, H,
    B * H)).  The piece's O, lse, dQ, dK, dV and both kernels' mask bits
    must equal the global call's rows bit for bit, and match the plain
    version with the same placement; one group at the plain placement
    must differ.  The whole pair placed at world size 1 (place (0, 0, H,
    B * H), two groups: what a pair runs on a mesh of one rank) must equal
    its unplaced one-group call bit for bit, and is timed beside it
    (forward, and forward with backward)."""
    from bpx_torch.ops import flash_attention as fa
    rate, seed = 0.1, 0x2545F491
    bf = torch.bfloat16
    rows = []
    for family, B, H, T, D in PLACED_PAIRS:
        b_off, h_off = B // 2, H // 2
        place = (b_off, h_off, H, B * H)
        seeds = [seed, seed]
        sl = lambda t: pair_piece(torch, t, b_off, h_off, B)
        q, k, v, do = (torch.randn(2 * B, H, T, D, generator=gen,
                                   device="cuda").to(bf) for _ in range(4))
        q = q * D ** -0.5
        out, lse = fa.flash_attention(q, k, v, True, None, rate, seed,
                                      return_lse=True)
        grads = fa.flash_attention_backward(q, k, v, out, lse, do, True,
                                            None, rate, seed)
        pq, pk, pv, pdo = (sl(t) for t in (q, k, v, do))
        pout, plse = fa.flash_attention(pq, pk, pv, True, None, rate, seeds,
                                        return_lse=True, place=place)
        pgrads = fa.flash_attention_backward(pq, pk, pv, pout, plse, pdo,
                                             True, None, rate, seeds, place)
        differ = {n: int((got != sl(want)).sum()) for n, got, want in zip(
            ("O", "lse", "dQ", "dK", "dV"), (pout, plse, *pgrads),
            (out, lse, *grads))}
        one_group = int((fa.flash_attention(pq, pk, pv, True, None, rate,
                                            seed, place=place[:3])
                         != sl(out)).sum())
        takes_kernel(torch, lambda: fa.flash_attention(
            pq, pk, pv, True, None, rate, seeds, place=place),
            fwd_kernel(D, groups=2), (2 * (B - b_off), H - h_off, T, T, D,
                                      rate, "pair"))
        ref, ref_lse = fa.flash_attention_reference(pq, pk, pv, True, None,
                                                    rate, seeds, place)
        rgrads = fa.flash_attention_backward_reference(
            pq, pk, pv, pdo, plse, fa.attention_delta_reference(pdo, pout),
            True, None, rate, seeds, place)
        err_o, err_l = max_err(pout, ref), max_err(plse, ref_lse)
        err_g = max(grad_err(g, r) for g, r in zip(pgrads, rgrads))
        q0 = torch.zeros_like(q)
        f_g, b_g, same_g = kernel_mask(torch, q0, k, rate, seed)
        f_p, b_p, same_p = kernel_mask(torch, sl(q0), sl(k), rate, seeds,
                                       place)
        keep = fa.keep_mask(seeds, 2 * (B - b_off), H - h_off, T, T, rate,
                            "cuda", place)
        bits = dict(forward=int((f_p != sl(f_g)).sum()),
                    backward=int((b_p != sl(b_g)).sum()),
                    plain=int((f_p != keep).sum()) + int((b_p != keep).sum()))

        def fwd_bwd(s, p):
            o, l = fa.flash_attention(q, k, v, True, None, rate, s,
                                      return_lse=True, place=p)
            return (o, l, *fa.flash_attention_backward(
                q, k, v, o, l, do, True, None, rate, s, p))
        whole = (0, 0, H, B * H)
        world1 = int(sum((a != b).sum() for a, b in zip(
            fwd_bwd(seeds, whole), (out, lse, *grads))))
        times = {}
        for label, s, p in (("placed pair", seeds, whole),
                            ("unplaced", seed, None)):
            times[label] = (
                timer(lambda: fa.flash_attention(q, k, v, True, None, rate,
                                                 s, place=p)),
                timer(lambda: fwd_bwd(s, p)))
        torch.cuda.synchronize()
        print(f"[placed pair] {family} D={D}: a pair of ({B}, {H}, {T}, "
              f"{T}) folded to {2 * B} rows, and its piece rows {b_off}.. "
              f"of each member, heads {h_off}.., at place {place} with "
              f"seeds {seeds}: elements differing from the global call's "
              f"rows {differ}; mask bits differing (of {keep.numel()}): "
              f"{bits}; one group at the plain placement differs in "
              f"{one_group}; against the plain version with the placement: "
              f"O {err_o:.3g}, lse {err_l:.3g}, gradients {err_g:.3g} (of "
              f"the largest entry); the whole pair placed at world size 1 "
              f"differs from its unplaced call in {world1} elements; its "
              f"device ms (forward, forward + backward) at ({2 * B}, {H}, "
              f"{T}, {T}): " + ", ".join(
                  f"{k} {t[0]:.4f} / {t[1]:.4f}" for k, t in times.items()))
        check(not any(differ.values()) and not any(bits.values())
              and same_g and same_p and one_group > 0 and world1 == 0,
              f"the placed pair piece at head_dim {D} is not the global "
              f"call's rows")
        check(torch.allclose(pout.float(), ref.float(), **FLASH_TOL)
              and torch.allclose(plse, ref_lse, **LSE_TOL)
              and err_g <= FLASH_GRAD_TOL,
              f"the placed pair piece at head_dim {D} differs from the "
              f"plain version")
        rows.append(dict(family=family, D=D, shape=[2 * B, H, T, T],
                         place=list(place), differ=differ, bits=bits,
                         one_group=one_group, world1=world1, ms=times))
    return rows


def stress_batch(np, exp, n: int, seed: int, accum: int = 0):
    """A stress request (text at ``max_seq_len`` tokens, BERT-large's
    positions; the model pads its stream to ``num_vectors_l``), or with
    ``accum`` an (A, n, ...) super-batch with multilabel targets."""
    m, d = exp.model, exp.data
    b = synthetic_batch(exp, n * max(accum, 1), seed)
    t = min(m.num_vectors_l, d.max_seq_len)
    for key in ("txt", "mask", "segment"):
        b[key] = np.ascontiguousarray(b[key][:, :t])
    if not accum:
        return b
    rng = np.random.RandomState(seed + 1)
    b["target"] = (rng.rand(n * accum, m.n_classes) < 0.2).astype(np.float32)
    return {k: v.reshape(accum, n, *v.shape[1:]) for k, v in b.items()}


def phase_stress(torch, np, timer, gen, mesh):
    """The stress preset (BERT-large, 2.21 B parameters, ``remat``) at full
    width and depth: one served request (batch 8), launches exact; then
    one FSDP2 step on the world-size-1 mesh at the preset's 64 rows:
    micro-batch 64 if it fits, else the largest of ``STRESS_LAYOUTS`` that
    does; launches exact (the recompute's included), every flash launch's
    class recorded.  Those classes (dropout 0.1 where the step draws it)
    are held against the plain versions and timed both ways, so the
    ``kernels`` line's stress rows pair the step's launches with times and
    bounds at the step's shapes.  The served request's classes are the
    same (Tq, Tk, D, band) at batch 8 and rate 0."""
    import gc
    from bpx_torch.config import get_preset
    from bpx_torch.models import get_model
    from bpx_torch.parallel import sharding
    from bpx_torch.serve import Predictor
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    exp = get_preset("stress")
    m = exp.model
    t0 = time.time()
    pred = Predictor(exp, batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"[stress] {m.model}, {n_params / 1e9:.3f} B params, hidden "
          f"{m.hidden_sz} over {m.num_heads} heads, {m.layers} layers, BERT "
          f"{m.bert.num_layers} layers, remat {m.remat}; built in "
          f"{time.time() - t0:.1f} s")
    req = stress_batch(np, exp, BATCH, 400)
    zero_launches()
    probs = pred(req)
    served = read_launches()
    check(probs.shape == (BATCH, m.n_classes) and np.isfinite(probs).all()
          and ((probs >= 0) & (probs <= 1)).all(),
          f"stress served output {probs.shape} is not finite probabilities")
    check(served["flash"] == STRESS.flash and served["ln"] == STRESS.ln,
          f"stress served launches {served}, expected flash {STRESS.flash}, "
          f"LayerNorm {STRESS.ln}")
    lat = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = pred(req)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    check(np.array_equal(again, probs), "stress serving reruns differ")
    print(f"[stress] served request of {BATCH}: {lat[-1]:.1f} ms (host "
          f"clock, synchronised; first {lat[0]:.1f} ms); launches {served}")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    want = {k: v for k, v in remat_launches(STRESS, m,
                                            STRESS_BERT_LAYERS).items()}
    rng = np.random.RandomState(11)
    freqs = rng.randint(30, 400, size=m.n_classes)
    tried = []
    for micro, accum in STRESS_LAYOUTS:
        model = opt = step = batch = None
        try:
            model = get_model(m, device="cuda", seed=0).train()
            model = sharding.shard_model(model, mesh, use_fsdp=True)
            opt = make_optimizer(model.parameters(), LR)
            loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                                   freqs.tolist(), 1000, device="cuda",
                                   groups=sharding.dp_groups(mesh))
            step = make_train_step(model, m.model, loss_fn, opt,
                                   grad_accum=accum,
                                   generator=torch.Generator().manual_seed(0),
                                   mesh=mesh)
            batch = {k: torch.from_numpy(v).to("cuda") for k, v in
                     stress_batch(np, exp, micro, 500, accum).items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t = time.perf_counter()
            with recording() as seen:
                loss = step(batch)["loss"].item()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            got = read_launches()
            break
        except torch.cuda.OutOfMemoryError as e:
            tried.append(f"{micro} x A={accum}")
            print(f"[stress] micro-batch {micro} x A={accum} does not fit: "
                  f"{str(e).splitlines()[0]}")
            del model, opt, step, batch
            gc.collect()
            torch.cuda.empty_cache()
    else:
        fail(f"[stress] no micro-batch fits: {tried}")
    per_step = {k: v * accum for k, v in want.items()}
    did_not_fit = f"; {', '.join(tried)} did not fit" if tried else ""
    print(f"[stress] one FSDP2 step at world size 1, micro-batch {micro} x "
          f"A={accum} ({micro * accum} rows{did_not_fit}): {step_ms:.1f} ms "
          f"(host clock, synchronised; the first step, its allocations "
          f"included); peak {peak:.2f} GiB (max_memory_allocated); "
          f"launches {got}; loss {loss:.6f}")
    check(got == per_step, f"[stress] step launches {got}, expected "
                           f"{per_step}")
    check(math.isfinite(loss), f"[stress] loss {loss}")
    del model, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    fwd_rows = phase_flash(torch, timer, seen["flash"], gen,
                           label="flash stress", **STRESS_PLAIN)
    bwd_rows = phase_flash_bwd(torch, timer, seen["flash_bwd"], gen,
                               label="flash_bwd stress", **STRESS_PLAIN)
    return dict(served_ms=lat[-1], served=served, micro=micro, accum=accum,
                step_ms=step_ms, peak_gib=peak, fwd_rows=fwd_rows,
                bwd_rows=bwd_rows, launches=got, params=n_params)


#: the world-size-1 runs of the paths that joined the mesh later, one
#: step each: moviescope's group_encoders pairs through DDP and FSDP2,
#: and mmtrvpa's (head_dim 192 memory encoders) through FSDP2
MESH_MORE = ((MOVIESCOPE_GROUPED, MESH_KINDS, 1),
             (MMTRVPA, ("one process", "FSDP2"), 1))


def phase_mesh(torch, np, timer, gen):
    """Phase 21: the world-size-1 NCCL mesh, the sharded trainer
    (moviescope, its grouped pairs, mmtrvpa), the placed kernels (and a
    grouped pair's), and the stress preset; the process group is ended
    after."""
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        mesh = start_mesh(torch, Path(tmp))
        try:
            steps = phase_mesh_steps(torch, np, mesh)
            more = {path.name: phase_mesh_steps(torch, np, mesh, path, kinds,
                                                n)
                    for path, kinds, n in MESH_MORE}
            placed = phase_placed(torch, gen)
            pairs = phase_placed_pairs(torch, timer, gen)
            stress = phase_stress(torch, np, timer, gen, mesh)
        finally:
            dist.destroy_process_group()
    return dict(steps=steps, more=more, placed=placed, pairs=pairs,
                stress=stress)

# ---------------------------------------------------------------------------
# phase 22: the flash kernels' whole domain (csrc/flash_generic.cu)
# ---------------------------------------------------------------------------

# moviescope at 16 heads: 768 / 16 = head_dim 48 in the crossmodal,
# biprojection and memory encoders, on the generic kernels (72 of the 84
# flash launches per forward); BERT stays 12 x 64 on the tabled ones.  Held
# to moviescope's limits: on an H100 (700 W) the sound kernels read probs
# 0.0112 / gates 0.0156 (limits 0.025 / 0.03), a flash kernel without its
# band 0.0508 / 0.0527, one without kv_lens 0.318 / 0.459; the micro-step's
# worst gradient group 0.189 (limit 0.5), a backward without its dropout
# mask 2.15, one without its band non-finite
MOVIESCOPE_16 = dataclasses.replace(
    MOVIESCOPE, panel=FLASH_PER_FORWARD - 12, options=(("num_heads", 16),))
# iemocap's mmtrvat in fp32 (compute_dtype "float32"): every flash call on
# the generic kernels, 96 at head_dim 25 and BERT's 12 at 64.  The kernels
# and the plain versions are both fp32 (no TF32 anywhere: the script turns
# it off for matmuls and cuDNN), so they differ only in the order of fp32
# sums.  On an H100 (700 W) the sound kernels read probs 1.16e-6 / gates
# 1.37e-6, a flash kernel without its band 0.0721 / 0.127, one without
# kv_lens 0.199 / 0.623; the micro-step's loss 3.55e-7 and worst gradient
# group 5.2e-6, a backward without its dropout mask 0.319, one without its
# band non-finite.  The limits sit at about the geometric mean of the sound
# and the nearer faulty reading: probs 3e-4 (259x over, 240x under), gates
# 4e-4 (292x, 318x), gradients 1e-3 (192x, 319x); the loss 1e-4 (282x over)
IEMOCAP_FP32_PROBS_TOL = 3e-4
IEMOCAP_FP32_GATES_TOL = 4e-4
IEMOCAP_FP32_LOSS_TOL = 1e-4
IEMOCAP_FP32_GRAD_TOL = 1e-3
IEMOCAP_FP32 = dataclasses.replace(
    IEMOCAP, generic=VAT_FLASH, probs_tol=IEMOCAP_FP32_PROBS_TOL,
    gates_tol=IEMOCAP_FP32_GATES_TOL, loss_tol=IEMOCAP_FP32_LOSS_TOL,
    grad_tol=IEMOCAP_FP32_GRAD_TOL, options=(("compute_dtype", "float32"),))
#: each path, its flash launches per forward by head dim, its dtype and the
#: route of its untabled head dim
DOMAIN_PATHS = ((MOVIESCOPE_16, {48: 72, 64: 12}, "bfloat16", "panel"),
                (IEMOCAP_FP32, {25: 96, 64: 12}, "float32", "generic"))
DOMAIN_REQUESTS = 2        # the second one ragged
DOMAIN_STEPS = 1
#: one class in each band of the panel builds' widths, in bf16 at head dims
#: the tabled kernels do not take (the panel route), and in fp32 (the
#: generic kernels): (dtype, kv_lens with an empty row, (B, H, Tq, Tk, D,
#: band, kv_lens, seed groups, rate)); the band with an offset (Tq != Tk),
#: a row with no visible key, rate 0.1, two seed groups, and Tk > 1024 (the
#: hash's tk_p 1152).
PANEL_CLASSES = (
    ("bfloat16", True, (4, 8, 200, 264, 16, True, True, 1, 0.1)),
    ("bfloat16", False, (4, 8, 256, 256, 32, True, False, 1, 0.0)),
    ("bfloat16", True, (4, 8, 264, 200, 80, True, True, 2, 0.1)),
    ("bfloat16", False, (4, 8, 256, 256, 112, True, False, 1, 0.1)),
    ("bfloat16", False, (2, 8, 200, 1100, 160, True, False, 1, 0.1)),
    ("bfloat16", True, (4, 4, 256, 256, 224, False, True, 1, 0.1)),
)
GENERIC_CLASSES = (
    ("float32", True, (4, 8, 256, 256, 48, True, True, 1, 0.1)),
    ("float32", False, (4, 4, 200, 264, 128, True, False, 1, 0.1)),
    ("float32", True, (2, 4, 256, 256, 256, True, True, 1, 0.0)),
)
#: the planted faults of phase 22, one a kernel, in one build: the generic
#: kernels' (csrc/flash_generic.cu) and the panel builds' (csrc/
#: flash_common.cuh's panel_fault; the tabled instantiations carry none):
#: the forward's row sum without each key tile's first key, dQ and dK/dV
#: without delta
DOMAIN_FAULTS = ["-DBPX_PLANT_GENERIC_FAULT=7", "-DBPX_PLANT_PANEL_FAULT=7"]
#: the panel faults' head dims: one of each panel width, and 33 (the wide
#: kernel's 2-byte loads on the fault's class)
PANEL_FAULT_DIMS = (16, 33, 48, 80, 160, 224)
#: the sweep of every panel head dim: (B, H, Tq, Tk), the band (offset 64),
#: kv_lens with an empty row, rate 0.1, one and two seed groups in turns
PANEL_SWEEP = (2, 2, 72, 136)
#: odd head dims above 32 on the wide and tall panel builds, on a fused
#: projection's views (2-byte loads; none copied)
PANEL_FUSED_DIMS = (33, 65, 129, 193)
#: the README's synthetic quick start (its port section), one epoch, with
#: the flash kernels: fp32, BERT's heads orig_d_l // 16 = 4 (head_dim 16),
#: the encoders' 64 / 4 = 16
README_ARGV = ["--task", "synthetic", "--model", "mmtrvapt", "--batch_sz",
               "8", "--gradient_accumulation_steps", "2", "--max_epochs",
               "1", "--from_seed", "1", "--to_seed", "1", "--num_vectors_l",
               "32", "--num_vectors_a", "16", "--num_vectors_v", "16",
               "--orig_d_l", "64", "--orig_d_v", "48", "--orig_d_a", "96",
               "--orig_d_p", "40", "--hidden_sz", "64", "--num_heads", "4",
               "--layers", "2", "--max_seq_len", "32", "--audio_raw_len",
               "576", "--video_len", "16", "--compute_dtype", "float32",
               "--use_audio_encoder", "1", "--attention_impl", "pallas"]
#: ``python -m bpx_torch.cli.train`` with the flash counters printed at exit
README_CHILD = r"""
import atexit, runpy, sys
from bpx_torch.ops import flash_attention as fa
atexit.register(lambda: print(
    "flash launches", fa.flash_attention.launches,
    fa.flash_attention.generic_launches, fa.flash_attention_backward.launches,
    fa.flash_attention_backward.generic_launches, flush=True))
sys.argv[0] = "bpx_torch.cli.train"
runpy.run_module("bpx_torch.cli.train", run_name="__main__", alter_sys=True)
"""


def route_classes(counter, dtype, route):
    """The classes of a recorded Counter that take ``route``'s kernels."""
    from bpx_torch.ops.flash_attention import kernel_route
    return collections.Counter({c: n for c, n in counter.items()
                                if kernel_route(dtype, c[4]) == route})


def domain_path(torch, np, timer, gen, path, dims, dtype, route,
                requests=DOMAIN_REQUESTS, steps=DOMAIN_STEPS,
                layer_norms=True):
    """One path of phase 22 (panel, generic) or 23 (chunked): served (the
    launches by route exact, against the plain path with the planted
    faults), its flash classes on ``route`` held against the plain
    versions and timed (with ``layer_norms``, its fp32 LayerNorm classes
    too), one micro-step against the plain path with the planted faults
    (launches by route exact), the micro-step's classes on ``route`` both
    ways, then ``steps`` Adam steps with exact counters."""
    pred, reqs = phase_predictor(torch, path, requests=requests)
    flash_cls, ln_cls = record_forward(path, pred, reqs[0], dims=dims)
    label = f"flash {route} {path.name}"
    rows = dict(flash=phase_flash(torch, timer,
                                  route_classes(flash_cls, dtype, route),
                                  gen, label=label, dtype=dtype))
    fp32_ln = layer_norms and dtype == torch.float32
    if fp32_ln:
        rows["ln"] = phase_layer_norm(torch, timer, ln_cls, gen,
                                      scalar_path=False)
    served = phase_serve(torch, np, pred, reqs, False, path)
    del pred
    torch.cuda.empty_cache()
    model, loss_fn, step, batches = phase_trainer(torch, np, path,
                                                  steps=steps)
    seen, micro = phase_micro_step(torch, model, loss_fn, batches, path)
    rows["flash_dropout"] = phase_flash(
        torch, timer,
        collections.Counter({c: n for c, n in route_classes(
            seen["flash"], dtype, route).items() if c[-1] > 0}),
        gen, label=label + " dropout", dtype=dtype)
    rows["flash_bwd"] = phase_flash_bwd(
        torch, timer, route_classes(seen["flash_bwd"], dtype, route), gen,
        label=label + " backward", dtype=dtype)
    if fp32_ln:
        rows["ln_bwd"] = phase_layer_norm_bwd(torch, timer, seen["ln_bwd"],
                                              gen, scalar_path=False)
    with recording() as train_seen:
        trained = phase_train(torch, model, step, batches, False, path)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    return dict(served=served, micro=micro, trained=trained, rows=rows,
                seen=seen, train_seen=train_seen)


def phase_readme_cli(card: str):
    """The README's synthetic quick start with ``--attention_impl pallas``
    through ``python -m bpx_torch.cli.train`` on the card, one epoch: rc 0,
    and every flash call on the generic kernels (fp32 at head_dim 16),
    both ways, with launches in each (its line under ``log``: it runs
    beside other phases)."""
    import os
    tag = "[readme cli]"
    with tempfile.TemporaryDirectory() as tmp:
        argv = README_ARGV + ["--savedir", tmp, "--name", "readme"]
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-c", README_CHILD, *argv], cwd=ROOT,
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="0"))
        wall = time.time() - t0
        check(proc.returncode == 0, f"{tag} exit {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        m = re.search(r"flash launches (\d+) (\d+) (\d+) (\d+)", proc.stdout)
        check(m is not None, f"{tag} no launch counts: {proc.stdout[-2000:]}")
        fwd, fwd_g, bwd, bwd_g = (int(x) for x in m.groups())
        text = (Path(tmp) / "readme_Seed1_run" / "logfile.log").read_text()
        dev = re.search(r"params on (\S+)", text)
    line = (f"{tag} python -m bpx_torch.cli.train (the README's synthetic "
            f"command, --attention_impl pallas, one epoch): rc 0 in "
            f"{wall:.1f} s on {dev.group(1) if dev else '?'}; flash launches "
            f"{fwd} forward ({fwd_g} generic), {bwd} backward ({bwd_g} "
            f"generic); card: {card}")
    check(dev is not None and dev.group(1).startswith("cuda"),
          f"{tag} the log does not name the card: {line}")
    check(fwd_g > 0 and bwd_g > 0 and fwd_g == fwd and bwd_g == bwd,
          f"{tag} the flash calls did not all take the generic kernels: "
          f"{line}")
    return dict(wall_s=wall, flash=fwd, generic=fwd_g, flash_bwd=bwd,
                generic_bwd=bwd_g, log=line)


def phase_class_rows(torch, timer, gen, classes, label):
    """``classes`` (PANEL_CLASSES, GENERIC_CLASSES, CHUNKED_CLASSES) both
    ways against the plain versions, timed beside the bound and SDPA (the
    profiler naming each kernel)."""
    rows = dict(flash=[], flash_bwd=[])
    for dt, empty, cls in classes:
        dtype = getattr(torch, dt)
        one = collections.Counter({cls: 1})
        rows["flash"] += phase_flash(torch, timer, one, gen,
                                     label=f"flash {label}",
                                     dtype=dtype, empty_row=empty)
        rows["flash_bwd"] += phase_flash_bwd(
            torch, timer, one, gen, label=f"flash_bwd {label}",
            dtype=dtype, empty_row=empty)
    return rows


def phase_generic_masks(torch, gen):
    """The panel builds' keep bits exactly (``phase_mask_check``): bf16 at
    head_dim 48 with one seed, with two seed groups (each group's bits its
    own launch's), placed as the (B/2, H/2) piece a rank of a data=2 x
    tensor=2 mesh holds (its bits the global call's slice), and at 33 (the
    words build) with one seed; the generic kernels' in fp32 at 25."""
    from bpx_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    before = fa.flash_attention.panel_launches
    phase_mask_check(torch, gen, BATCH, 4, 128, 48)
    phase_mask_check(torch, gen, BATCH, 4, 128, 33)
    phase_mask_check(torch, gen, BATCH, 4, 128, 25, torch.float32)
    phase_seed_masks(torch, gen, 2, 4, 4, 128, 48)
    place = (BATCH // 2, 2, 4)
    phase_mask_check(torch, gen, BATCH // 2, 2, 128, 48, bf, place)
    glob = fa.keep_mask(0xDEADBEEF, BATCH, 4, 128, 128, 0.1, "cuda")
    piece = fa.keep_mask(0xDEADBEEF, BATCH // 2, 2, 128, 128, 0.1, "cuda",
                         place)
    check(torch.equal(piece, glob[BATCH // 2:, 2:]),
          "the placed piece's bits are not the global call's slice")
    check(fa.flash_attention.panel_launches > before,
          "the bf16 masks did not run on the panel route")


def phase_planted_faults(torch, gen, variant, cases, caught, route):
    """Each kernel's planted fault (``variant``: the library built with
    ``DOMAIN_FAULTS``, or ``CHUNKED_FAULT``) against the sound build at the
    same class, at each (dtype, head_dim) of ``cases`` (band, kv_lens,
    rate 0.1), every call on ``route``: the sound kernels within the rows'
    limits, and the faulty forward's O and the gradients ``caught`` (the
    generic and panel faults: dQ and dK; the chunked ones: dQ and dV) each
    past theirs.  The backward runs from the plain forward's O and lse, so
    each kernel's own fault shows."""
    from bpx_torch.ops import _cuda, flash_attention as fa
    lib = _cuda.library()
    got = {}
    for dt, D in cases:
        dtype = getattr(torch, dt)
        check(fa.kernel_route(dtype, D) == route,
              f"{dt} D {D} is not on the {route} route")
        _, _, tol, grad_tol = dtype_limits(torch, dtype)
        q, k, v, kv_lens = attention_inputs(torch, gen, 4, 4, 200, 200, D,
                                            True, dtype)
        drop = (0.1, 0x5EED)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, True, kv_lens,
                                                    *drop)
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        want = fa.flash_attention_backward_reference(
            q, k, v, dout, ref_lse, fa.attention_delta_reference(dout, ref),
            True, kv_lens, *drop)
        for build, l in (("sound", lib), ("planted", variant)):
            _cuda._lib = l
            try:
                out = fa.flash_attention(q, k, v, True, kv_lens, *drop)
                dq, dk, dv = fa._launch_bwd(q, k, v, dout, ref_lse, ref,
                                            True, kv_lens, *drop)
                torch.cuda.synchronize()
            finally:
                _cuda._lib = lib
            e = dict(forward=max_err(out, ref),
                     forward_ok=torch.allclose(out.float(), ref.float(),
                                               **tol),
                     dq=grad_err(dq, want[0]), dk=grad_err(dk, want[1]),
                     dv=grad_err(dv, want[2]))
            got[(dt, build)] = e
            print(f"[{route} faults] {dt} D={D} {build} build: O max err "
                  f"{e['forward']:.3g} (within {tol}: {e['forward_ok']}), "
                  f"dQ {e['dq']:.3g}, dK {e['dk']:.3g}, dV {e['dv']:.3g} "
                  f"(limit {grad_tol})")
            if build == "sound":
                check(e["forward_ok"] and max(e["dq"], e["dk"], e["dv"])
                      <= grad_tol, f"the sound {route} kernels at {dt} D "
                                   f"{D} are past their limits")
            else:
                check(not e["forward_ok"]
                      and all(e[g] > grad_tol for g in caught),
                      f"a planted {route} fault at {dt} D {D} is not caught")
    return got


def phase_panel_sweep(torch, gen):
    """Every bf16 head dim from 1 to 256 outside ``KERNEL_ALIGN`` (247) at
    ``PANEL_SWEEP``'s class, both ways against the plain versions (the band
    with an offset, a row with no visible key, rate 0.1, one and two seed
    groups in turns), each call counted on the panel route; then the
    fused-view classes at ``PANEL_FUSED_DIMS``, uncopied and on the words
    build by the profiler's name.  Shows the zero padding, the word paths
    and the runtime stores right at every width."""
    from bpx_torch.ops import flash_attention as fa
    B, H, Tq, Tk = PANEL_SWEEP
    dims = [d for d in range(1, 257) if d not in fa.KERNEL_ALIGN]
    before = (fa.flash_attention.panel_launches,
              fa.flash_attention_backward.panel_launches)
    worst = dict(o=0.0, lse=0.0, grads=0.0)
    for i, D in enumerate(dims):
        seeds = group_seeds(0x5EED0 + D, 1 + i % 2)
        q, k, v, lens = attention_inputs(torch, gen, B, H, Tq, Tk, D, True,
                                         empty_row=True)
        out, lse = fa.flash_attention(q, k, v, True, lens, 0.1, seeds,
                                      return_lse=True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(
            out.dtype)
        got = fa._launch_bwd(q, k, v, dout, lse, out, True, lens, 0.1, seeds)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, True, lens, 0.1,
                                                    seeds)
        want = fa.flash_attention_backward_reference(
            q, k, v, dout, lse, fa.attention_delta_reference(dout, out),
            True, lens, 0.1, seeds)
        e_o, e_l = max_err(out, ref), max_err(lse, ref_lse)
        e_g = max(grad_err(g, w) for g, w in zip(got, want))
        worst = dict(o=max(worst["o"], e_o), lse=max(worst["lse"], e_l),
                     grads=max(worst["grads"], e_g))
        check(torch.allclose(out.float(), ref.float(), **FLASH_TOL)
              and torch.allclose(lse, ref_lse, **LSE_TOL),
              f"[panel sweep] D {D}: O err {e_o:.3g}, lse err {e_l:.3g}")
        check(e_g <= FLASH_GRAD_TOL,
              f"[panel sweep] D {D}: gradient err {e_g:.3g}")
    counted = (fa.flash_attention.panel_launches - before[0],
               fa.flash_attention_backward.panel_launches - before[1])
    print(f"[panel sweep] {len(dims)} head dims (1-256 outside the table) "
          f"at (B, H, Tq, Tk) {PANEL_SWEEP}, band, an empty kv_lens row, rate "
          f"0.1, one and two seed groups in turns, both ways within "
          f"{FLASH_TOL} / {LSE_TOL} / {FLASH_GRAD_TOL}: worst O {worst['o']:.3g}"
          f", lse {worst['lse']:.3g}, gradients {worst['grads']:.3g}; panel "
          f"launches {counted[0]} forward, {counted[1]} backward")
    check(counted == (len(dims), len(dims)),
          f"the sweep's panel launches {counted}, expected {len(dims)} each")
    for D in PANEL_FUSED_DIMS:
        buf = torch.randn(2, 90, 3, 4, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        check(all(fa._kernel_ready("t", t, t.device) is t for t in (q, k, v)),
              f"[panel sweep] a fused view at D {D} was copied")
        out, lse = fa.flash_attention(q, k, v, True, return_lse=True)
        ref, _ = fa.flash_attention_reference(q, k, v, True)
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(
            out.dtype)
        got = fa._launch_bwd(q, k, v, dout, lse, out, True, None)
        want = fa.flash_attention_backward_reference(
            q, k, v, dout, lse, fa.attention_delta_reference(dout, out), True)
        e_g = max(grad_err(g, w) for g, w in zip(got, want))
        check(torch.allclose(out.float(), ref.float(), **FLASH_TOL)
              and e_g <= FLASH_GRAD_TOL,
              f"[panel sweep] fused views at D {D}: O err "
              f"{max_err(out, ref):.3g}, gradients {e_g:.3g}")
        kernel = fwd_kernel(D)
        takes_kernel(torch, lambda: fa.flash_attention(q, k, v, True),
                     kernel, f"fused views at D {D}")
        print(f"[panel sweep] fused (2, 90, 3, 4, {D}) views uncopied on "
              f"{kernel}: O err {max_err(out, ref):.3g}, gradients "
              f"{e_g:.3g}")
    return dict(dims=len(dims), worst=worst, launches=counted)


def phase_domain(torch, np, timer, gen, card, cli):
    """Phase 22: (a) moviescope at 16 heads (bf16 on the panel builds) and
    (b) iemocap in fp32 (the generic kernels) through ``domain_path``; (c)
    ``cli``, the result of the README's synthetic quick start through the
    CLI (``phase_readme_cli``); (d) PANEL_CLASSES and GENERIC_CLASSES, the
    sweep of every panel head dim, the masks, and the panel builds' and
    the generic kernels' planted faults (one build of its own, made in the
    background meanwhile)."""
    from bpx_torch.ops import _cuda
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fault_build = pool.submit(_cuda.build, DOMAIN_FAULTS)
    out = {}
    try:
        for path, dims, dt, route in DOMAIN_PATHS:
            t0 = time.time()
            out[path.name] = domain_path(torch, np, timer, gen, path, dims,
                                         getattr(torch, dt), route)
            print(f"[time] domain {path.name} {time.time() - t0:.1f} s")
        print(f"[domain] TF32 with the fp32 readings: "
              f"torch.backends.cuda.matmul.allow_tf32 "
              f"{torch.backends.cuda.matmul.allow_tf32}, "
              f"torch.backends.cudnn.allow_tf32 "
              f"{torch.backends.cudnn.allow_tf32}")
        out["cli"] = cli
        t0 = time.time()
        out["rows"] = phase_class_rows(torch, timer, gen, PANEL_CLASSES,
                                       "panel band")
        out["generic_rows"] = phase_class_rows(torch, timer, gen,
                                               GENERIC_CLASSES,
                                               "generic band")
        phase_generic_masks(torch, gen)
        print(f"[time] domain band rows and masks {time.time() - t0:.1f} s")
        t0 = time.time()
        out["sweep"] = phase_panel_sweep(torch, gen)
        print(f"[time] domain panel sweep {time.time() - t0:.1f} s")
        t0 = time.time()
        t_wait = time.perf_counter()
        fault_build.result()
        SPENT["fault_build_wait_s"] += time.perf_counter() - t_wait
        faulty = _cuda.load(DOMAIN_FAULTS)
        out["faults"] = phase_planted_faults(
            torch, gen, faulty, (("float32", 25),), ("dq", "dk"), "generic")
        out["panel_faults"] = phase_planted_faults(
            torch, gen, faulty, tuple(("bfloat16", d)
                                      for d in PANEL_FAULT_DIMS),
            ("dq", "dk"), "panel")
        print(f"[time] domain planted faults (after their build) "
              f"{time.time() - t0:.1f} s")
    finally:
        pool.shutdown(wait=True)
    return out


# ---------------------------------------------------------------------------
# phase 23: the flash kernels past head dim 256 (csrc/flash_chunked.cu)
# ---------------------------------------------------------------------------

# moviescope at 2 heads: 768 / 2 = head_dim 384 in the crossmodal,
# biprojection and memory encoders, on the chunked kernels (72 of the 84
# flash launches per forward); BERT stays 12 x 64 on the tabled ones.  Held
# to moviescope's limits, as phase 22's moviescope at 16 heads
MOVIESCOPE_2 = dataclasses.replace(
    MOVIESCOPE_16, panel=0, chunked=FLASH_PER_FORWARD - 12,
    options=(("num_heads", 2),))
# iemocap's mmtrvat in fp32 at 1 head: head_dim 300 in the encoders, on the
# chunked kernels (96 of the 108 flash launches per forward); BERT's 12 at
# 64 on the generic ones (fp32).  Held to phase 22's fp32 limits
IEMOCAP_FP32_1 = dataclasses.replace(
    IEMOCAP_FP32, generic=12, chunked=VAT_FLASH - 12,
    options=(("compute_dtype", "float32"), ("num_heads", 1)))
#: each path, its flash launches per forward by head dim and its dtype
CHUNKED_PATHS = ((MOVIESCOPE_2, {384: 72, 64: 12}, "bfloat16"),
                 (IEMOCAP_FP32_1, {300: 96, 64: 12}, "float32"))
CHUNKED_REQUESTS = 2       # the second one ragged
CHUNKED_STEPS = 2
#: the chunked kernels past the paths' head dims, in bf16 and fp32 at 257
#: (one column past the generic builds), 384, 512, 768 and 1536 (mmtrvpa's
#: 2E-wide memory at moviescope's width over one head): (dtype, kv_lens
#: with an empty row, (B, H, Tq, Tk, D, band, kv_lens, seed groups, rate));
#: among them the band with an offset (Tq != Tk), a row with no visible
#: key, rate 0.1, two seed groups and Tk > 1024 (the hash's tk_p 1152) in
#: one class
CHUNKED_CLASSES = (
    ("bfloat16", True, (4, 2, 200, 264, 257, True, True, 1, 0.1)),
    ("bfloat16", False, (2, 2, 256, 256, 384, True, False, 2, 0.1)),
    ("bfloat16", False, (2, 2, 256, 256, 512, True, False, 1, 0.0)),
    ("bfloat16", True, (2, 1, 200, 1100, 768, True, True, 2, 0.1)),
    ("bfloat16", True, (2, 1, 256, 256, 1536, False, True, 1, 0.1)),
    ("float32", False, (2, 2, 256, 256, 257, True, False, 1, 0.1)),
    ("float32", True, (2, 2, 200, 264, 384, True, True, 2, 0.1)),
    ("float32", False, (2, 1, 256, 256, 512, True, False, 1, 0.1)),
    ("float32", True, (2, 1, 256, 256, 768, False, True, 1, 0.0)),
    ("float32", True, (2, 1, 200, 264, 1536, True, True, 1, 0.1)),
)
#: the chunked kernels' planted faults, one a kernel, in one build
#: (csrc/flash_chunked.cu): the forward's and the dK/dV kernel's scores
#: without chunk 1, the dQ kernel's delta without the last chunk
CHUNKED_FAULT = "-DBPX_PLANT_CHUNKED_FAULT=7"


def phase_chunked_masks(torch, gen):
    """The chunked kernels' keep bits exactly (``phase_mask_check``): bf16
    at head_dim 384 with one seed, with two seed groups (each group's bits
    its own launch's), placed as the (B/2, H/2) piece a rank of a data=2 x
    tensor=2 mesh holds (its bits the global call's slice); fp32 at 300."""
    from bpx_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    phase_mask_check(torch, gen, BATCH, 2, 128, 384)
    phase_mask_check(torch, gen, BATCH, 1, 128, 300, torch.float32)
    phase_seed_masks(torch, gen, 2, 4, 2, 128, 384)
    place = (BATCH // 2, 1, 2)
    phase_mask_check(torch, gen, BATCH // 2, 1, 128, 384, bf, place)
    glob = fa.keep_mask(0xDEADBEEF, BATCH, 2, 128, 128, 0.1, "cuda")
    piece = fa.keep_mask(0xDEADBEEF, BATCH // 2, 1, 128, 128, 0.1, "cuda",
                         place)
    check(torch.equal(piece, glob[BATCH // 2:, 1:]),
          "the placed piece's bits are not the global call's slice")


def phase_chunked(torch, np, timer, gen):
    """Phase 23: (a) moviescope at 2 heads and (b) iemocap in fp32 at 1
    head through ``domain_path`` on the chunked route; (c)
    CHUNKED_CLASSES, the chunked kernels' masks and their planted faults
    (a build of their own, made in the background meanwhile)."""
    from bpx_torch.ops import _cuda
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fault_build = pool.submit(_cuda.build, [CHUNKED_FAULT])
    out = {}
    try:
        for path, dims, dt in CHUNKED_PATHS:
            t0 = time.time()
            out[path.name] = domain_path(
                torch, np, timer, gen, path, dims, getattr(torch, dt),
                "chunked", CHUNKED_REQUESTS, CHUNKED_STEPS,
                layer_norms=False)
            print(f"[time] chunked {path.name} {time.time() - t0:.1f} s")
        t0 = time.time()
        out["rows"] = phase_class_rows(torch, timer, gen, CHUNKED_CLASSES,
                                       "chunked")
        phase_chunked_masks(torch, gen)
        print(f"[time] chunked rows and masks {time.time() - t0:.1f} s")
        t0 = time.time()
        t_wait = time.perf_counter()
        fault_build.result()
        SPENT["fault_build_wait_s"] += time.perf_counter() - t_wait
        out["faults"] = phase_planted_faults(
            torch, gen, _cuda.load([CHUNKED_FAULT]),
            (("bfloat16", 384), ("float32", 300)), ("dq", "dv"), "chunked")
        print(f"[time] chunked planted faults (after their build) "
              f"{time.time() - t0:.1f} s")
    finally:
        pool.shutdown(wait=True)
    return out


def split_rows(rows, which):
    """The generic backward rows as rows of its dQ (0) or dK/dV (1) kernel
    alone: the profiler's time of that kernel beside its own bound; the
    plain time and SDPA's are the whole backward's."""
    key = ("dq", "dkdv")[which]
    return [dict(r, ms=list(r["kernel_split_ms"].values())[which],
                 bound_ms=r[f"{key}_bound_ms"], bound_by=r[f"{key}_bound_by"],
                 recompute=r[f"{key}_recompute"])
            for r in rows]


def short_launches(seen, kind) -> int:
    """Calls of a kind of flash kernel at 32 x 32 in a recording."""
    return sum(c for cls, c in seen[kind].items() if cls[2:4] == (32, 32))


def pair_launches(seen, kind) -> int:
    """Calls of a kind of flash kernel at a doubled batch (a grouped
    pair) in a recording."""
    return sum(c for cls, c in seen[kind].items() if cls[0] == 2 * BATCH)


def hybrid_launches(opts, kind) -> int:
    """Calls of a LayerNorm kernel ("ln", "ln_bwd") in the hybrid train
    steps at the classes only the hybrid paths brought."""
    shapes = {tuple(r["shape"]) for r in opts[f"h_{kind}"]}
    return sum(c for seen in (opts["h_train_seen"], opts["ih_train_seen"])
               for cls, c in seen[kind].items() if cls[:2] in shapes)


def dim_rows(rows, D):
    """The rows at head_dim D among a path's rows."""
    return [r for r in rows if r["shape"][3] == D]


def dim_launches(seen, kind, D) -> int:
    """Calls of a kind of kernel ("flash", "flash_bwd") at head_dim D in a
    recording."""
    return sum(c for cls, c in seen[kind].items() if cls[4] == D)


def summarise(name, source, replaces, rows, launches, runs, per):
    """One kernel's entry: times are per launch, averaged over the recorded
    run's mix of shapes (weights: each class's launches in that run)."""
    check(rows, f"{name}: no shape was held against its plain version")
    total = sum(r["per_forward"] for r in rows)
    avg = lambda key: sum(r[key] * r["per_forward"] for r in rows) / total
    by = collections.Counter()
    for r in rows:
        by[r["bound_by"]] += r["per_forward"]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "ms": avg("ms"), "plain_ms": avg("plain_ms"),
             "bound_ms": avg("bound_ms"),
             "bound_by": by.most_common(1)[0][0],
             "library_ms": avg("library_ms"),
             f"launches_per_{per}": launches // runs, "shapes": rows}
    ms, lib, bound = entry["ms"], entry["library_ms"], entry["bound_ms"]
    entry.update(bound_share=bound / ms, library_ratio=ms / lib)
    redo = ""
    if any(r.get("recompute", 1) != 1 for r in rows):
        # the chunked kernels' flops over the function's, beside the bound
        entry["recompute"] = avg("recompute")
        redo = f", the kernel's flops x{entry['recompute']:.3f} the function's"
    print(f"[summary] {name} (mix-weighted): {ms:.4f} ms, library "
          f"{lib:.4f} ms ({ms / lib:.2f}x), bound {bound:.4f} ms "
          f"({bound / ms:.1%} of the bound{redo})")
    return entry


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    if not (ROOT / "bpx_torch" / "__init__.py").exists():
        fail("bpx_torch is not beside chip_smoke.py")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    print(f"[device] {name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    phase_build()
    dispatch = phase_dispatch(torch)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    phase_timing_check(torch, timer, gen)

    # moviescope serving: the forward kernels at the served classes, then
    # the path
    t0 = time.time()
    pred, reqs = phase_predictor(torch, MOVIESCOPE)
    flash_cls, ln_cls = record_forward(MOVIESCOPE, pred, reqs[0])
    flash_rows = phase_flash(torch, timer, flash_cls, gen)
    ln_rows = phase_layer_norm(torch, timer, ln_cls, gen)
    served = phase_serve(torch, np, pred, reqs, args.profile)
    del pred
    torch.cuda.empty_cache()

    # moviescope training: one recorded micro-step against the plain path,
    # the new kernels at its classes, then the train steps
    model, loss_fn, step, batches = phase_trainer(torch, np)
    seen, micro = phase_micro_step(torch, model, loss_fn, batches)
    drop_rows = phase_flash(
        torch, timer, {k: c for k, c in seen["flash"].items() if k[-1] > 0},
        gen, label="flash_dropout")
    bwd_rows = phase_flash_bwd(torch, timer, seen["flash_bwd"], gen)
    ln_bwd_rows = phase_layer_norm_bwd(torch, timer, seen["ln_bwd"], gen)
    dropout_ms = phase_dropout_hash(torch, timer, seen["dropout"], gen)
    phase_mask_check(torch, gen, BATCH, 8, 64, 64)
    long_rows = phase_long_shape(torch, timer, gen)
    trained = phase_train(torch, model, step, batches, args.profile)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    print(f"[time] moviescope phases {time.time() - t0:.1f} s")

    # iemocap (mmtrvat, head_dim 25): serving, MAG, training
    t0 = time.time()
    pred, reqs = phase_predictor(torch, IEMOCAP)
    i_flash_cls, i_ln_cls = record_forward(IEMOCAP, pred, reqs[0], 25)
    i_flash_rows = phase_flash(torch, timer, i_flash_cls, gen,
                               label="flash iemocap")
    i_ln_rows = phase_layer_norm(torch, timer, i_ln_cls, gen,
                                 scalar_path=False)
    i_served = phase_serve(torch, np, pred, reqs, args.profile, IEMOCAP)
    del pred
    mag_pred, mag_reqs = phase_predictor(torch, IEMOCAP_MAG, requests=1)
    record_forward(IEMOCAP_MAG, mag_pred, mag_reqs[0], 25)
    i_mag = phase_serve(torch, np, mag_pred, mag_reqs, False, IEMOCAP_MAG,
                        faults=False)
    del mag_pred
    torch.cuda.empty_cache()

    model, loss_fn, step, batches = phase_trainer(torch, np, IEMOCAP)
    i_seen, i_micro = phase_micro_step(torch, model, loss_fn, batches,
                                       IEMOCAP)
    i_drop_rows = phase_flash(
        torch, timer, {k: c for k, c in i_seen["flash"].items() if k[-1] > 0},
        gen, label="flash_dropout iemocap")
    i_bwd_rows = phase_flash_bwd(torch, timer, i_seen["flash_bwd"], gen,
                                 label="flash_bwd iemocap")
    i_ln_bwd_rows = phase_layer_norm_bwd(torch, timer, i_seen["ln_bwd"], gen,
                                         scalar_path=False)
    phase_mask_check(torch, gen, BATCH, 12, 512, 25)
    i_long_rows = phase_long_shape(torch, timer, gen, 25)
    with recording() as i_train_seen:
        i_trained = phase_train(torch, model, step, batches, args.profile,
                                IEMOCAP)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    print(f"[time] iemocap phases {time.time() - t0:.1f} s")

    # cmu-mosei (head_dim 30): one served request and one train step, the
    # kernels at their classes
    t0 = time.time()
    pred, reqs = phase_predictor(torch, CMU_MOSEI, requests=1)
    c_flash_cls, _ = record_forward(CMU_MOSEI, pred, reqs[0], 30)
    c_flash_rows = phase_flash(torch, timer, c_flash_cls, gen,
                               label="flash cmu-mosei")
    c_served = phase_serve(torch, np, pred, reqs, False, CMU_MOSEI,
                           faults=False)
    del pred
    model, loss_fn, step, batches = phase_trainer(torch, np, CMU_MOSEI,
                                                  steps=1)
    with recording() as c_seen:
        c_trained = phase_train(torch, model, step, batches, False,
                                CMU_MOSEI)
    per_micro = lambda seen: {k: c // TRAIN_A for k, c in seen.items()}
    c_drop_rows = phase_flash(
        torch, timer,
        per_micro({k: c for k, c in c_seen["flash"].items() if k[-1] > 0}),
        gen, label="flash_dropout cmu-mosei")
    c_bwd_rows = phase_flash_bwd(torch, timer, per_micro(c_seen["flash_bwd"]),
                                 gen, label="flash_bwd cmu-mosei")
    c_long_rows = phase_long_shape(torch, timer, gen, 30)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    print(f"[time] cmu-mosei phases {time.time() - t0:.1f} s")

    # mmimdb (mmtrvapt, head_dim 128): serving, training
    t0 = time.time()
    pred, reqs = phase_predictor(torch, MMIMDB)
    m_flash_cls, m_ln_cls = record_forward(MMIMDB, pred, reqs[0], 128)
    m_flash_rows = phase_flash(torch, timer, m_flash_cls, gen,
                               label="flash mmimdb")
    m_ln_rows = phase_layer_norm(torch, timer, m_ln_cls, gen,
                                 scalar_path=False)
    m_served = phase_serve(torch, np, pred, reqs, args.profile, MMIMDB)
    del pred
    torch.cuda.empty_cache()
    model, loss_fn, step, batches = phase_trainer(torch, np, MMIMDB)
    m_seen, m_micro = phase_micro_step(torch, model, loss_fn, batches,
                                       MMIMDB)
    m_drop_rows = phase_flash(
        torch, timer, {k: c for k, c in m_seen["flash"].items() if k[-1] > 0},
        gen, label="flash_dropout mmimdb")
    m_bwd_rows = phase_flash_bwd(torch, timer, m_seen["flash_bwd"], gen,
                                 label="flash_bwd mmimdb")
    m_ln_bwd_rows = phase_layer_norm_bwd(torch, timer, m_seen["ln_bwd"], gen,
                                         scalar_path=False)
    phase_mask_check(torch, gen, BATCH, 6, 512, 128)
    m_long_rows = phase_long_shape(torch, timer, gen, 128)
    with recording() as m_train_seen:
        m_trained = phase_train(torch, model, step, batches, args.profile,
                                MMIMDB)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    print(f"[time] mmimdb phases {time.time() - t0:.1f} s")

    # the classes the moviescope phases held against the plain versions
    # (the loop's), and those the iemocap and cmu-mosei phases added (the
    # training forward's LayerNorms are the served ones)
    checked = dict(
        flash=set(flash_cls) | {k for k in seen["flash"] if k[-1] > 0},
        flash_bwd=set(seen["flash_bwd"]), ln=set(ln_cls),
        ln_bwd=set(seen["ln_bwd"]))
    held = dict(
        flash=checked["flash"] | set(i_flash_cls)
        | {k for k in i_seen["flash"] if k[-1] > 0} | set(c_flash_cls)
        | {k for k in c_seen["flash"] if k[-1] > 0},
        flash_bwd=checked["flash_bwd"] | set(i_seen["flash_bwd"])
        | set(c_seen["flash_bwd"]),
        ln=checked["ln"] | set(seen["ln"]) | set(i_ln_cls)
        | set(i_seen["ln"]),
        ln_bwd=checked["ln_bwd"] | set(i_seen["ln_bwd"]))
    # the CLI checks that run in processes of their own (the README's
    # synthetic command, mmtrvpa's, the loop's export and its archive
    # served) run on side threads beside the phases up to the farm, which
    # time no kernel: each is held as before, and its line printed when
    # it is joined
    side = concurrent.futures.ThreadPoolExecutor(3)
    t_side = time.time()
    readme_cli = side.submit(phase_readme_cli, card)
    legacy_cli = side.submit(phase_legacy_cli, np, card)

    # the training loop: moviescope's full-width model through the CLI,
    # at the classes the moviescope phases held against the plain versions
    t0 = time.time()
    looped = phase_loop(torch, np, card, checked, side)
    torch.cuda.empty_cache()
    print(f"[time] loop phase {time.time() - t0:.1f} s")

    # recompute at the presets' own settings: iemocap (full recompute) and
    # mmimdb (save_attn in the encoders, BERT in full)
    t0 = time.time()
    remat = {p.preset: phase_remat(torch, np, p, card)
             for p in (IEMOCAP, MMIMDB)}
    print(f"[time] remat phases {time.time() - t0:.1f} s")

    # counseling and cmu-mosi (head_dim 30, 5 layers): one request and one
    # train step each; synthetic-tiny on the einsum attention likewise
    t0 = time.time()
    small = {}
    for path, head_dim in ((COUNSELING, 30), (CMU_MOSI, 30),
                           (SYNTHETIC_TINY, None)):
        pred, reqs = phase_predictor(torch, path, requests=1)
        record_forward(path, pred, reqs[0], head_dim)
        served_p = phase_serve(torch, np, pred, reqs, False, path,
                               faults=False)
        del pred
        model, loss_fn, step, batches = phase_trainer(torch, np, path,
                                                      steps=1)
        trained_p = phase_train(torch, model, step, batches, False, path)
        del model, loss_fn, step, batches
        torch.cuda.empty_cache()
        small[path.preset] = (served_p, trained_p)
    t_served, t_trained = small["synthetic-tiny"]
    print(f"[synthetic-tiny] einsum attention: flash launches served "
          f"{t_served['flash_launches']}, trained "
          f"{t_trained['totals']['flash']} forward / "
          f"{t_trained['totals']['flash_bwd']} backward: no flash launch")
    check(t_served["flash_launches"] == 0
          and t_trained["totals"]["flash"] == 0
          and t_trained["totals"]["flash_bwd"] == 0,
          "synthetic-tiny launched a flash kernel")
    print(f"[time] counseling, cmu-mosi, synthetic-tiny phases "
          f"{time.time() - t0:.1f} s")

    # phase 18: the task farm on the card
    t0 = time.time()
    farm = phase_farm(card)
    print(f"[time] farm phase {time.time() - t0:.1f} s")

    t0 = time.time()
    side.shutdown(wait=True)
    looped["export_cli"] = looped["export_cli"].result()
    readme_cli, legacy_cli = readme_cli.result(), legacy_cli.result()
    for r in (readme_cli, legacy_cli, looped["export_cli"]):
        print(r.pop("log"))
    print(f"[time] side CLIs joined after {time.time() - t_side:.1f} s "
          f"(waited {time.time() - t0:.1f} s): the README command "
          f"{readme_cli['wall_s']:.1f} s, mmtrvpa's "
          f"{legacy_cli['wall_s']:.1f} s, the export "
          f"{looped['export_cli']['cli_s']:.1f} s and its archive served")

    # the options the CLI accepts: hybrid (RAdam), group_encoders (bf16
    # accumulation), iemocap hybrid, the 32 x 32 sweep; new classes only
    # against the plain versions, beside those ``held``
    t0 = time.time()
    opts = phase_options(torch, np, timer, gen, held)
    print(f"[time] options phase {time.time() - t0:.1f} s")

    # phase 17: iemocap's five seeds in one vmapped step, the folded
    # launches held against the plain versions at their S·B classes
    t0 = time.time()
    multi = phase_multiseed(torch, np, timer, gen, card)
    ms_flash_rows = phase_flash(torch, timer, multi["seen"]["flash"], gen,
                                label="flash multiseed")
    ms_bwd_rows = phase_flash_bwd(torch, timer, multi["seen"]["flash_bwd"],
                                  gen, label="flash_bwd multiseed")
    # the LayerNorms run per seed, at iemocap's classes (held in phase 8)
    ln_new = (new_classes(multi["seen"]["ln"], set(i_ln_cls)
                          | set(i_seen["ln"]))
              | new_classes(multi["seen"]["ln_bwd"], set(i_seen["ln_bwd"])))
    check(not ln_new, f"the vmapped step's LayerNorm classes {ln_new} were "
                      f"not held against the plain versions")
    print(f"[time] multiseed iemocap {time.time() - t0:.1f} s")
    # mmimdb at its own recompute (save_attn, D 128) and mmtrvpa at
    # moviescope's widths (D 192), two seeds each, and mmtrvpa's export;
    # then 20 seeds through one vmapped flash call
    ms_held = dict(flash=held["flash"] | set(m_flash_cls)
                   | set(m_seen["flash"]),
                   flash_bwd=held["flash_bwd"] | set(m_seen["flash_bwd"]),
                   ln=held["ln"] | set(m_ln_cls) | set(m_seen["ln"]),
                   ln_bwd=held["ln_bwd"] | set(m_seen["ln_bwd"]))
    pairs = {p.preset if p is MMIMDB else "mmtrvpa": phase_multiseed_path(
        torch, np, timer, gen, p, card, ms_held) for p in (MMIMDB, MMTRVPA)}
    print(f"[time] multiseed iemocap, mmimdb, mmtrvpa {time.time() - t0:.1f} s")
    pred, reqs = phase_predictor(torch, MMTRVPA_EXPORT, requests=2)
    vpa_export = phase_export(torch, np, pred, reqs, card, MMTRVPA_EXPORT)
    del pred
    torch.cuda.empty_cache()
    print(f"[time] multiseed and mmtrvpa's export {time.time() - t0:.1f} s")
    chunks = phase_seed_chunks(torch, timer, gen)
    print(f"[time] multiseed phase {time.time() - t0:.1f} s")

    # phase 19: the notebook-era models at moviescope's full width; the
    # classes the earlier phases held (the options phase's included) are
    # not held again
    t0 = time.time()
    legacy = phase_legacy(torch, np, timer, gen, card, held, legacy_cli)
    print(f"[time] legacy phase {time.time() - t0:.1f} s")

    # phase 20: mmtrvpa at iemocap, cmu-mosei and mmimdb (memory head dims
    # 50, 60 and 256); the classes every earlier phase held are not held
    # again
    t0 = time.time()
    vpa = phase_mmtrvpa(torch, np, timer, gen, held)
    print(f"[time] mmtrvpa presets phase {time.time() - t0:.1f} s")

    # phase 21: the mesh at world size 1 (moviescope through the DDP and
    # FSDP2 trainers), the placed flash kernels, the stress preset
    t0 = time.time()
    mesh = phase_mesh(torch, np, timer, gen)
    print(f"[time] mesh phase {time.time() - t0:.1f} s")

    # phase 22: the flash kernels' whole domain: moviescope at 16 heads
    # (head_dim 48) and iemocap in fp32 on the generic kernels, the
    # README's synthetic command through the CLI, the generic kernels at
    # one class of each panel band, their masks and planted faults
    t0 = time.time()
    domain = phase_domain(torch, np, timer, gen, card, readme_cli)
    print(f"[time] domain phase {time.time() - t0:.1f} s")

    # phase 23: the flash kernels past head dim 256: moviescope at 2 heads
    # (head_dim 384) and iemocap in fp32 at 1 head (300) on the chunked
    # kernels, the chunked kernels at 257 to 1536, their masks and faults
    t0 = time.time()
    chunked = phase_chunked(torch, np, timer, gen)
    print(f"[time] chunked phase {time.time() - t0:.1f} s")
    print(f"[time] of the whole run: kernel, plain and library timings "
          f"{SPENT['timing_s']:.1f} s; {SPENT['profiles']} profiler windows "
          f"{SPENT['profiler_s']:.1f} s; waits for the planted-fault builds "
          f"{SPENT['fault_build_wait_s']:.1f} s")

    steps = TRAIN_STEPS * TRAIN_A
    legacy_runs = LEGACY_STEPS * TRAIN_A
    lt_seen = legacy["train_seen"]["mmtrvpa"]
    fwd_src = "bpx_torch/csrc/flash_fwd.cu"
    bwd_src = "bpx_torch/csrc/flash_bwd.cu"
    ln_src, ln_bwd_src = ("bpx_torch/csrc/layer_norm.cu",
                          "bpx_torch/csrc/layer_norm_bwd.cu")
    fwd_tpu, drop_tpu, bwd_tpu = ("bpx/ops/pallas_attention.py:145",
                                  "bpx/ops/pallas_attention.py:102",
                                  "bpx/ops/pallas_attention.py:462")
    # the training loop's launches (its own run, counters from 0) beside the
    # moviescope rows, whose classes it runs
    in_loop = lambda key: dict(
        loop_launches=looped["launches"][key],
        loop_launches_per_epoch=looped["launches_per_epoch"][key])
    kernels = [
        dict(summarise("flash_fwd", fwd_src, fwd_tpu, flash_rows,
                       served["flash_launches"], REQUESTS, "forward"),
             **in_loop("flash")),
        dict(summarise("flash_fwd_dropout", fwd_src, drop_tpu, drop_rows,
                       trained["totals"]["dropout"], steps, "micro_step"),
             **in_loop("dropout")),
        dict(summarise("flash_bwd", bwd_src, bwd_tpu, bwd_rows,
                       trained["totals"]["flash_bwd"], steps, "micro_step"),
             long_shape=long_rows, **in_loop("flash_bwd")),
        dict(summarise("layer_norm_fwd", ln_src, "bpx/ops/norm.py:53",
                       ln_rows, served["ln_launches"], REQUESTS, "forward"),
             **in_loop("ln")),
        dict(summarise("layer_norm_bwd", ln_bwd_src, "bpx/ops/norm.py:69",
                       ln_bwd_rows, trained["totals"]["ln_bwd"], steps,
                       "micro_step"), **in_loop("ln_bwd")),
        # iemocap: head_dim 25 (and BERT's 64) on its own path
        summarise("flash_fwd_iemocap", fwd_src, fwd_tpu, i_flash_rows,
                  i_served["flash_launches"], REQUESTS, "forward"),
        summarise("flash_fwd_dropout_iemocap", fwd_src, drop_tpu,
                  i_drop_rows, i_trained["totals"]["dropout"], steps,
                  "micro_step"),
        dict(summarise("flash_bwd_iemocap", bwd_src, bwd_tpu, i_bwd_rows,
                       i_trained["totals"]["flash_bwd"], steps,
                       "micro_step"), long_shape=i_long_rows),
        summarise("layer_norm_fwd_iemocap", ln_src, "bpx/ops/norm.py:53",
                  i_ln_rows, i_served["ln_launches"], REQUESTS, "forward"),
        summarise("layer_norm_bwd_iemocap", ln_bwd_src, "bpx/ops/norm.py:69",
                  i_ln_bwd_rows, i_trained["totals"]["ln_bwd"], steps,
                  "micro_step"),
        # cmu-mosei: head_dim 30
        summarise("flash_fwd_cmu_mosei", fwd_src, fwd_tpu, c_flash_rows,
                  c_served["flash_launches"], 1, "forward"),
        summarise("flash_fwd_dropout_cmu_mosei", fwd_src, drop_tpu,
                  c_drop_rows, c_trained["totals"]["dropout"], TRAIN_A,
                  "micro_step"),
        dict(summarise("flash_bwd_cmu_mosei", bwd_src, bwd_tpu, c_bwd_rows,
                       c_trained["totals"]["flash_bwd"], TRAIN_A,
                       "micro_step"), long_shape=c_long_rows),
        # the narrow kernels alone (rows 2 @ 25 and 2 @ 30: the backward's
        # own two kernels; rows 1 @ 25 and 1 @ 30: the forward's own
        # kernel, over the served and the dropout classes), launches those
        # of the train steps at head_dim 25 / 30
        summarise("flash_bwd_narrow_d25", bwd_src, bwd_tpu,
                  dim_rows(i_bwd_rows, 25),
                  dim_launches(i_train_seen, "flash_bwd", 25), steps,
                  "micro_step"),
        summarise("flash_bwd_narrow_d30", bwd_src, bwd_tpu,
                  dim_rows(c_bwd_rows, 30),
                  dim_launches(c_seen, "flash_bwd", 30), TRAIN_A,
                  "micro_step"),
        summarise("flash_fwd_narrow_d25", fwd_src, fwd_tpu,
                  dim_rows(i_flash_rows + i_drop_rows, 25),
                  dim_launches(i_train_seen, "flash", 25), steps,
                  "micro_step"),
        summarise("flash_fwd_narrow_d30", fwd_src, fwd_tpu,
                  dim_rows(c_flash_rows + c_drop_rows, 30),
                  dim_launches(c_seen, "flash", 30), TRAIN_A, "micro_step"),
        # mmimdb: head_dim 128 (and BERT's 64)
        summarise("flash_fwd_mmimdb", fwd_src, fwd_tpu, m_flash_rows,
                  m_served["flash_launches"], REQUESTS, "forward"),
        summarise("flash_fwd_dropout_mmimdb", fwd_src, drop_tpu, m_drop_rows,
                  m_trained["totals"]["dropout"], steps, "micro_step"),
        summarise("flash_bwd_mmimdb", bwd_src, bwd_tpu, m_bwd_rows,
                  m_trained["totals"]["flash_bwd"], steps, "micro_step"),
        # the D 128 backward alone (row 2 @ 128: its own two kernels) and
        # the D 128 forward alone (row 1 @ 128: its own kernel, over the
        # served and the dropout classes; row 1b @ 128 the long shape)
        dict(summarise("flash_bwd_d128", bwd_src, bwd_tpu,
                       dim_rows(m_bwd_rows, 128),
                       dim_launches(m_train_seen, "flash_bwd", 128), steps,
                       "micro_step"), long_shape=m_long_rows),
        summarise("flash_fwd_d128", fwd_src, fwd_tpu,
                  dim_rows(m_flash_rows + m_drop_rows, 128),
                  dim_launches(m_train_seen, "flash", 128), steps,
                  "micro_step"),
        summarise("layer_norm_fwd_mmimdb", ln_src, "bpx/ops/norm.py:53",
                  m_ln_rows, m_served["ln_launches"], REQUESTS, "forward"),
        summarise("layer_norm_bwd_mmimdb", ln_bwd_src, "bpx/ops/norm.py:69",
                  m_ln_bwd_rows, m_trained["totals"]["ln_bwd"], steps,
                  "micro_step"),
        # phase 16: every head dim at 32 x 32 (the sweep, and any hybrid
        # class it missed; launches those of the hybrid train steps at 32 x
        # 32, moviescope's 6 at A = 1 and iemocap's one at A = 2), the
        # grouped pairs' 2B classes (launches those of the grouped train
        # steps at 2B) and the hybrid paths' new LayerNorm classes
        # (launches those of the hybrid train steps at those classes)
        summarise("flash_fwd_32x32", fwd_src, fwd_tpu,
                  opts["s_rows"] + opts["h_flash"],
                  short_launches(opts["h_train_seen"], "flash")
                  + short_launches(opts["ih_train_seen"], "flash"),
                  RADAM_STEPS + TRAIN_A, "micro_step"),
        summarise("flash_bwd_32x32", bwd_src, bwd_tpu,
                  opts["s_bwd_rows"] + opts["h_flash_bwd"],
                  short_launches(opts["h_train_seen"], "flash_bwd")
                  + short_launches(opts["ih_train_seen"], "flash_bwd"),
                  RADAM_STEPS + TRAIN_A, "micro_step"),
        summarise("flash_fwd_grouped", fwd_src, fwd_tpu, opts["g_flash"],
                  pair_launches(opts["g_train_seen"], "flash"), steps,
                  "micro_step"),
        summarise("flash_bwd_grouped", bwd_src, bwd_tpu,
                  opts["g_flash_bwd"],
                  pair_launches(opts["g_train_seen"], "flash_bwd"), steps,
                  "micro_step"),
        summarise("layer_norm_fwd_hybrid", ln_src, "bpx/ops/norm.py:53",
                  opts["h_ln"], hybrid_launches(opts, "ln"),
                  RADAM_STEPS + TRAIN_A, "micro_step"),
        summarise("layer_norm_bwd_hybrid", ln_bwd_src, "bpx/ops/norm.py:69",
                  opts["h_ln_bwd"], hybrid_launches(opts, "ln_bwd"),
                  RADAM_STEPS + TRAIN_A, "micro_step"),
        # phase 17: the folded launches at iemocap's S·B classes (launches
        # those of the vmapped steps), the LayerNorms per seed at iemocap's
        # classes
        summarise("flash_fwd_multiseed", fwd_src, fwd_tpu, ms_flash_rows,
                  multi["totals"]["flash"], MULTISEED_STEPS, "micro_step"),
        summarise("flash_bwd_multiseed", bwd_src, bwd_tpu, ms_bwd_rows,
                  multi["totals"]["flash_bwd"], MULTISEED_STEPS,
                  "micro_step"),
        summarise("layer_norm_fwd_multiseed", ln_src, "bpx/ops/norm.py:53",
                  i_ln_rows, multi["totals"]["ln"], MULTISEED_STEPS,
                  "micro_step"),
        summarise("layer_norm_bwd_multiseed", ln_bwd_src,
                  "bpx/ops/norm.py:69", i_ln_bwd_rows,
                  multi["totals"]["ln_bwd"], MULTISEED_STEPS, "micro_step"),
        # phase 17's two-seed paths: the folded classes at head_dim 128
        # under save_attn (mmimdb) and 192 (mmtrvpa), launches those of
        # one vmapped step each; the S = 20 call's chunks
        summarise("flash_fwd_multiseed_d128", fwd_src, fwd_tpu,
                  dim_rows(pairs["mmimdb"]["rows"]["flash"], 128),
                  dim_launches(pairs["mmimdb"]["seen"], "flash", 128), 1,
                  "micro_step"),
        summarise("flash_bwd_multiseed_d128", bwd_src, bwd_tpu,
                  dim_rows(pairs["mmimdb"]["rows"]["flash_bwd"], 128),
                  dim_launches(pairs["mmimdb"]["seen"], "flash_bwd", 128), 1,
                  "micro_step"),
        summarise("flash_fwd_multiseed_d192", fwd_src, fwd_tpu,
                  dim_rows(pairs["mmtrvpa"]["rows"]["flash"], 192),
                  dim_launches(pairs["mmtrvpa"]["seen"], "flash", 192), 1,
                  "micro_step"),
        summarise("flash_bwd_multiseed_d192", bwd_src, bwd_tpu,
                  dim_rows(pairs["mmtrvpa"]["rows"]["flash_bwd"], 192),
                  dim_launches(pairs["mmtrvpa"]["seen"], "flash_bwd", 192),
                  1, "micro_step"),
        summarise("flash_fwd_seed_chunks", fwd_src, fwd_tpu,
                  chunks["rows"]["flash"], chunks["launches"]["flash"], 1,
                  "call"),
        summarise("flash_bwd_seed_chunks", bwd_src, bwd_tpu,
                  chunks["rows"]["flash_bwd"],
                  chunks["launches"]["flash_bwd"], 1, "call"),
        # phase 19: the head_dim-192 kernels (rows 1 @ 192 and 2 @ 192:
        # mmtrvpa's memory encoders, served and trained) and the 1536-wide
        # LayerNorms, launches those of mmtrvpa's train steps
        summarise("flash_fwd_d192", fwd_src, fwd_tpu,
                  dim_rows(legacy["rows"]["flash"], 192),
                  dim_launches(lt_seen, "flash", 192), legacy_runs,
                  "micro_step"),
        summarise("flash_bwd_d192", bwd_src, bwd_tpu,
                  dim_rows(legacy["rows"]["flash_bwd"], 192),
                  dim_launches(lt_seen, "flash_bwd", 192), legacy_runs,
                  "micro_step"),
        summarise("layer_norm_fwd_1536", ln_src, "bpx/ops/norm.py:53",
                  [r for r in legacy["rows"]["ln"] if r["shape"][1] == 1536],
                  width_launches(lt_seen, "ln", 1536), legacy_runs,
                  "micro_step"),
        summarise("layer_norm_bwd_1536", ln_bwd_src, "bpx/ops/norm.py:69",
                  [r for r in legacy["rows"]["ln_bwd"]
                   if r["shape"][1] == 1536],
                  width_launches(lt_seen, "ln_bwd", 1536), legacy_runs,
                  "micro_step"),
    ]
    # phase 20: the memory encoders' kernels at head_dim 50 (iemocap), 60
    # (cmu-mosei: one train step) and 256 (mmimdb), launches those of each
    # path's train steps, and the 600-wide LayerNorms (iemocap's steps)
    v_seen = vpa["train_seen"]
    for preset, (D, _) in VPA_MEMORY.items():
        runs = legacy_runs if preset in VPA_TRAINED else TRAIN_A
        kernels += [
            summarise(f"flash_fwd_d{D}", fwd_src, fwd_tpu,
                      dim_rows(vpa["rows"]["flash"], D),
                      dim_launches(v_seen[preset], "flash", D), runs,
                      "micro_step"),
            summarise(f"flash_bwd_d{D}", bwd_src, bwd_tpu,
                      dim_rows(vpa["rows"]["flash_bwd"], D),
                      dim_launches(v_seen[preset], "flash_bwd", D), runs,
                      "micro_step")]
    kernels += [
        summarise("layer_norm_fwd_600", ln_src, "bpx/ops/norm.py:53",
                  [r for r in vpa["rows"]["ln"] if r["shape"][1] == 600],
                  width_launches(v_seen["iemocap"], "ln", 600), legacy_runs,
                  "micro_step"),
        summarise("layer_norm_bwd_600", ln_bwd_src, "bpx/ops/norm.py:69",
                  [r for r in vpa["rows"]["ln_bwd"] if r["shape"][1] == 600],
                  width_launches(v_seen["iemocap"], "ln_bwd", 600),
                  legacy_runs,
                  "micro_step")]
    # phase 22: each route's kernels at the classes of its path (the panel
    # builds moviescope-16's, the generic kernels iemocap-fp32's) and of its
    # band classes; launches those of the path's train step
    d_runs = DOMAIN_STEPS * TRAIN_A
    for path, _, _, route in DOMAIN_PATHS:
        d = domain[path.name]
        band = domain["rows" if route == "panel" else "generic_rows"]
        rows = lambda key: d["rows"][key] + band.get(key, [])
        d_fwd = rows("flash") + rows("flash_dropout")
        d_bwd = rows("flash_bwd")
        totals = d["trained"]["totals"]
        src = (("bpx_torch/csrc/flash_panel_fwd.cu",
                "bpx_torch/csrc/flash_panel_bwd.cu") if route == "panel"
               else ("bpx_torch/csrc/flash_generic.cu",) * 2)
        kernels += [
            summarise(f"flash_{route}_fwd", src[0], fwd_tpu, d_fwd,
                      totals[route], d_runs, "micro_step"),
            summarise(f"flash_{route}_dq", src[1],
                      "bpx/ops/pallas_attention.py:276", split_rows(d_bwd, 0),
                      totals[f"{route}_bwd"], d_runs, "micro_step"),
            summarise(f"flash_{route}_dkdv", src[1],
                      "bpx/ops/pallas_attention.py:357", split_rows(d_bwd, 1),
                      totals[f"{route}_bwd"], d_runs, "micro_step")]
    # phase 23: the chunked kernels at the classes of paths (a) and (b) and
    # of CHUNKED_CLASSES; launches those of both paths' train steps
    ch_src = "bpx_torch/csrc/flash_chunked.cu"
    c_paths = [chunked[p.name] for p, _, _ in CHUNKED_PATHS]
    c_rows = lambda key: ([r for d in c_paths for r in d["rows"][key]]
                          + chunked["rows"].get(key, []))
    c_bwd = c_rows("flash_bwd")
    c_runs = CHUNKED_STEPS * TRAIN_A * len(c_paths)
    c_launch = lambda key: sum(d["trained"]["totals"][key] for d in c_paths)
    kernels += [
        summarise("flash_chunked_fwd", ch_src, fwd_tpu,
                  c_rows("flash") + c_rows("flash_dropout"),
                  c_launch("chunked"), c_runs, "micro_step"),
        summarise("flash_chunked_dq", ch_src,
                  "bpx/ops/pallas_attention.py:276", split_rows(c_bwd, 0),
                  c_launch("chunked_bwd"), c_runs, "micro_step"),
        summarise("flash_chunked_dkdv", ch_src,
                  "bpx/ops/pallas_attention.py:357", split_rows(c_bwd, 1),
                  c_launch("chunked_bwd"), c_runs, "micro_step")]
    st = mesh["stress"]
    kernels += [
        summarise("flash_fwd_stress", fwd_src, fwd_tpu, st["fwd_rows"],
                  st["launches"]["flash"], st["accum"], "micro_step"),
        summarise("flash_bwd_stress", bwd_src, bwd_tpu, st["bwd_rows"],
                  st["launches"]["flash_bwd"], st["accum"], "micro_step")]
    print(f"[summary] moviescope: served median request "
          f"{served['median_ms']:.2f} ms; train step median "
          f"{trained['median_ms']:.1f} ms "
          f"({TRAIN_A * BATCH / trained['median_ms'] * 1e3:.2f} samples/s, "
          f"peak {trained['peak_gib']:.2f} GiB); plain hash dropout "
          f"{dropout_ms:.2f} ms per micro-step; micro-step kernels vs plain: "
          f"loss {micro['loss_err']:.3g}, gradients {micro['grad_err']:.3g}; "
          f"card: {card}")
    print(f"[summary] iemocap: served median request "
          f"{i_served['median_ms']:.2f} ms (MAG request "
          f"{i_mag['median_ms']:.2f} ms); train step median "
          f"{i_trained['median_ms']:.1f} ms "
          f"({TRAIN_A * BATCH / i_trained['median_ms'] * 1e3:.2f} "
          f"samples/s, peak {i_trained['peak_gib']:.2f} GiB); micro-step "
          f"kernels vs plain: loss {i_micro['loss_err']:.3g}, gradients "
          f"{i_micro['grad_err']:.3g}; cmu-mosei: request "
          f"{c_served['median_ms']:.2f} ms, train step "
          f"{c_trained['median_ms']:.1f} ms; card: {card}")
    print(f"[summary] mmimdb: served median request "
          f"{m_served['median_ms']:.2f} ms; train step median "
          f"{m_trained['median_ms']:.1f} ms "
          f"({TRAIN_A * BATCH / m_trained['median_ms'] * 1e3:.2f} "
          f"samples/s, peak {m_trained['peak_gib']:.2f} GiB); micro-step "
          f"kernels vs plain: loss {m_micro['loss_err']:.3g}, gradients "
          f"{m_micro['grad_err']:.3g}; "
          + "; ".join(f"{p}: request {sv['median_ms']:.2f} ms, train step "
                      f"{tr['median_ms']:.1f} ms, peak {tr['peak_gib']:.2f} "
                      f"GiB" for p, (sv, tr) in small.items())
          + f"; card: {card}")
    per_epoch = lambda key, scale, fmt: ", ".join(
        format(s[key] * scale, fmt) for s in looped["epochs"])
    print(f"[summary] loop (moviescope through the CLI, micro-batch {BATCH} "
          f"x A={TRAIN_A}): epochs {per_epoch('train_s', 1, '.2f')} s, step "
          f"p50 {per_epoch('step_p50_s', 1e3, '.1f')} ms, evaluation "
          f"{per_epoch('eval_s', 1, '.2f')} s; "
          f"launches per epoch {looped['launches_per_epoch']}; "
          f"from_checkpoint max err {looped['from_checkpoint_err']:.3g}; "
          f"peak {looped['peak_gib']:.2f} GiB; card: {card}")
    print(f"[summary] custom ops: {dispatch['extra_us']['flash']:.2f} / "
          f"{dispatch['extra_us']['ln']:.2f} us of host time per flash / "
          f"LayerNorm call, {dispatch['per_request_ms']:.2f} ms per "
          f"moviescope request, {dispatch['per_step_ms']:.2f} ms per step; "
          f"export CLI: {looped['export_cli']['cli_s']:.1f} s, "
          f"{looped['export_cli']['mib']:.1f} MiB, served median eager "
          f"{looped['export_cli']['eager_ms']:.2f} ms / exported "
          f"{looped['export_cli']['exported_ms']:.2f} ms; card: {card}")
    h, g, ih = (opts["h_trained"], opts["g_trained"], opts["ih_trained"])
    print(f"[summary] options: moviescope hybrid served median "
          f"{opts['h_served']['median_ms']:.2f} ms, RAdam step (A = 1) median "
          f"{h['median_ms']:.1f} ms, losses "
          + ", ".join(f"{x:.4f}" for x in h["losses"])
          + f", peak {h['peak_gib']:.2f} GiB; moviescope group_encoders "
          f"served median {opts['g_served']['median_ms']:.2f} ms, bf16-"
          f"accumulation step (A = {TRAIN_A}) median {g['median_ms']:.1f} ms,"
          f" peak {g['peak_gib']:.2f} GiB, bf16 vs fp32 accumulation: "
          f"{opts['g_accum']['differ']} of {opts['g_accum']['of']} "
          f"gradients differ, {opts['g_accum']['bound_share']:.3g} of the "
          f"bound, relative L2 up to {opts['g_accum']['max_rel_l2']:.3g}; "
          f"iemocap hybrid request {opts['ih_served']['median_ms']:.2f} ms, "
          f"step {ih['median_ms']:.1f} ms; micro-step kernels vs plain: "
          f"hybrid loss {opts['h_micro']['loss_err']:.3g} / gradients "
          f"{opts['h_micro']['grad_err']:.3g}, grouped "
          f"{opts['g_micro']['loss_err']:.3g} / "
          f"{opts['g_micro']['grad_err']:.3g}; card: {card}")
    print("[summary] recompute: " + "; ".join(
        f"{p} peak at micro-batch {BATCH} {r['peak_gib'][False]:.2f} GiB "
        f"without / {r['peak_gib'][True]:.2f} GiB with, batch {r['batch']} "
        f"step {r['step_ms']:.1f} ms at {r['step_peak_gib']:.2f} GiB"
        for p, r in remat.items()) + f"; card: {card}")
    print(f"[summary] multiseed: iemocap, {len(MULTISEED)} seeds in one "
          f"vmapped step with recompute: median {multi['median_ms']:.1f} ms, single-seed "
          f"A = 1 step {multi['single_ms']:.1f} ms, S * t_single / "
          f"t_vmapped {multi['speedup']:.3f}, peak {multi['peak_gib']:.2f} "
          f"GiB; seeds against their own steps: " + ", ".join(
              f"seed {MULTISEED[i]} loss {e['loss_err']:.3g} gradients "
              f"{e['grad_err']:.3g}" for i, e in multi["seed_errors"].items())
          + f"; planted faults {multi['planted_faults']}; against plain "
          f"versions: loss {multi['plain_loss_err']:.3g}, gradients "
          f"{max(multi['plain_grad_err']):.3g}; folded launch / "
          f"{len(MULTISEED)} launches: " + ", ".join(
              f"D {f['shape'][3]} forward {f['fwd'] / f['fwd_s']:.2f}x, "
              f"backward {f['bwd'] / f['bwd_s']:.2f}x"
              for f in multi["folded"])
          + "; two seeds at the presets' own configs, each seed against "
          "its own step: " + ", ".join(
              f"{p} " + ", ".join(f"seed {sd} loss {e['loss_err']:.3g} "
                                  f"gradients {e['grad_err']:.3g}"
                                  for sd, e in r["errors"].items())
              for p, r in pairs.items())
          + f"; mmtrvpa export {vpa_export['export_s']:.1f} s, served "
          f"median exported {vpa_export['exported_ms']:.2f} ms; "
          f"{CHUNK_SEEDS} seeds in one vmapped flash call: launches "
          f"{chunks['launches']['flash']} / {chunks['launches']['flash_bwd']}"
          f", seeds differing from their own launches {chunks['differ']}, "
          f"mask bits {chunks['bits']}"
          + f"; task farm {farm['wall_s']:.1f} s; card: {card}")
    print("[summary] notebook-era models (moviescope widths): served median "
          + ", ".join(f"{n} {sv['median_ms']:.2f} ms"
                      for n, sv in legacy["served"].items())
          + "; train step median " + ", ".join(
              f"{n} {tr['median_ms']:.1f} ms (peak {tr['peak_gib']:.2f} "
              f"GiB)" for n, tr in legacy["trained"].items())
          + "; micro-step kernels vs plain: " + ", ".join(
              f"{n} loss {e['loss_err']:.3g} gradients {e['grad_err']:.3g}"
              for n, e in legacy["micro"].items())
          + f"; CLI epoch {legacy['cli']['wall_s']:.1f} s; card: {card}")
    print("[summary] mmtrvpa at the presets (memory head dims 50, 60, 256): "
          "served median " + ", ".join(
              f"{p} {sv['median_ms']:.2f} ms"
              for p, sv in vpa["served"].items())
          + "; train step median " + ", ".join(
              f"{p} {tr['median_ms']:.1f} ms (peak {tr['peak_gib']:.2f} GiB)"
              for p, tr in vpa["trained"].items())
          + "; micro-step kernels vs plain: " + ", ".join(
              f"{p} loss {e['loss_err']:.3g} gradients {e['grad_err']:.3g}"
              for p, e in vpa["micro"].items()) + f"; card: {card}")
    ms = mesh["steps"]
    print("[summary] mesh (world size 1, NCCL): moviescope step median "
          + ", ".join(f"{k} {v['median_ms']:.1f} ms (peak {v['peak_gib']:.2f}"
                      f" GiB)" for k, v in ms.items())
          + "; sharded step 1 vs one process: " + ", ".join(
              f"{k} loss {v['loss_err']:.3g} gradients {v['grad_err']:.3g}"
              for k, v in ms.items() if "loss_err" in v)
          + "; placed pieces differing from the global slice: " + ", ".join(
              f"D {r['D']} {sum(r['differ'].values())} elements, "
              f"{sum(r['bits'].values())} mask bits"
              for r in mesh["placed"])
          + "; " + "; ".join(
              f"{p}: step median " + ", ".join(
                  f"{k} {v['median_ms']:.1f} ms (peak {v['peak_gib']:.2f} "
                  f"GiB)" for k, v in runs.items()) + ", step 1 vs one "
              "process " + ", ".join(
                  f"{k} loss {v['loss_err']:.3g} gradients "
                  f"{v['grad_err']:.3g}" for k, v in runs.items()
                  if "loss_err" in v)
              for p, runs in mesh["more"].items())
          + "; placed pair pieces differing from the global rows: "
          + ", ".join(f"D {r['D']} {sum(r['differ'].values())} elements, "
                      f"{sum(r['bits'].values())} mask bits"
                      for r in mesh["pairs"])
          + f"; stress ({st['params'] / 1e9:.3f} B params): served request "
          f"of {BATCH} {st['served_ms']:.1f} ms, FSDP2 step at micro-batch "
          f"{st['micro']} x A={st['accum']} {st['step_ms']:.1f} ms, peak "
          f"{st['peak_gib']:.2f} GiB; card: {card}")
    print("[summary] domain (the panel builds and the generic flash "
          "kernels): " + "; ".join(
        f"{name}: served median {d['served']['median_ms']:.2f} ms "
        f"({d['served'][f'{route}_launches'] // DOMAIN_REQUESTS} of "
        f"{d['served']['flash_launches'] // DOMAIN_REQUESTS} flash launches "
        f"per forward {route}, "
        f"{d['served']['generic_launches'] // DOMAIN_REQUESTS} generic), "
        f"train step median {d['trained']['median_ms']:.1f} ms (peak "
        f"{d['trained']['peak_gib']:.2f} GiB; {route} launches per "
        f"micro-step {d['trained']['totals'][route] // d_steps} forward"
        f" / {d['trained']['totals'][f'{route}_bwd'] // d_steps} backward), "
        f"micro-step kernels vs plain: loss {d['micro']['loss_err']:.3g}, "
        f"gradients {d['micro']['grad_err']:.3g}"
        for name, d, d_steps, route in (
            (p.name, domain[p.name], DOMAIN_STEPS * TRAIN_A, r)
            for p, _, _, r in DOMAIN_PATHS))
          + f"; panel sweep: {domain['sweep']['dims']} head dims, worst "
          f"gradient err {domain['sweep']['worst']['grads']:.3g}"
          + f"; README command through the CLI: {domain['cli']['wall_s']:.1f}"
          f" s, {domain['cli']['generic']} generic forward / "
          f"{domain['cli']['generic_bwd']} backward launches; card: {card}")
    print("[summary] past head_dim 256 (the chunked flash kernels): "
          + "; ".join(
              f"{p.name}: served median {d['served']['median_ms']:.2f} ms "
              f"({d['served']['chunked_launches'] // CHUNKED_REQUESTS} of "
              f"{d['served']['flash_launches'] // CHUNKED_REQUESTS} flash "
              f"launches per forward chunked, "
              f"{d['served']['generic_launches'] // CHUNKED_REQUESTS} "
              f"generic), train step median {d['trained']['median_ms']:.1f} "
              f"ms (peak {d['trained']['peak_gib']:.2f} GiB; chunked "
              f"launches per micro-step "
              f"{d['trained']['totals']['chunked'] // c_steps} forward / "
              f"{d['trained']['totals']['chunked_bwd'] // c_steps} "
              f"backward), micro-step kernels vs plain: loss "
              f"{d['micro']['loss_err']:.3g}, gradients "
              f"{d['micro']['grad_err']:.3g}"
              for p, d, c_steps in ((p, chunked[p.name],
                                     CHUNKED_STEPS * TRAIN_A)
                                    for p, _, _ in CHUNKED_PATHS))
          + f"; card: {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
