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
   backend that ran, and ``F.layer_norm``) times (CUDA events, median of 20
   groups of 10 warm runs), the bound (the larger of bytes / 3.35 TB/s and
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
   flash backward (delta, dK/dV and dQ kernels, timed together, with the
   profiler's split) at rate 0 and 0.1 (SDPA's backward as the library
   yardstick) and its delta kernel alone, the LayerNorm backward
   (``F.layer_norm``'s backward; bitwise-equal reruns; the device kernels
   one call runs, from the profiler: exactly one, the cooperative launch,
   and no memset; its scalar kernel once on a misaligned view); the plain
   hash dropout's time; an exact
   check of the kernels' dropout masks (q = 0, V = I, dO = I); one long
   multi-tile shape (B*H 2, 640 x 1280, band and dropout), checked, then
   timed: the forward, the dQ and the dK/dV kernel each beside its bound
   and SDPA;
7. three train steps at micro-batch 8 x A = 2 on numpy-seeded synthetic
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
   4 requests against the plain path with its own limits, which both
   planted faults must cross; one request of the same model with
   ``fusion="mag"`` against the plain path.  Training: one micro-step
   against the plain path (planted backward faults), the head_dim-25
   dropout forward and backward at its classes (each backward row also
   with the dQ and dK/dV kernels' own bounds), the exact dropout mask at
   (8, 12, 512, 512, 25), the long shape at head_dim 25, then 3 train
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
   128), 3 train steps (168 / 72 / 168 / 458 / 458 launches per step) with
   the peak memory;
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
   layers, micro-batch 8 x A = 2, ``attention_impl`` pallas) for 2 epochs:
   the memmap cache, checkpoints, ``test``.  Counters set to 0 before and
   read after, and checked per train step (168 flash forward, 72 with
   dropout, 168 backward, 458 LayerNorm forward and backward) and per
   evaluation forward (84 flash, 181 LayerNorm); every launch class among
   those phases 3-6 held against the plain versions; no tensor copied.
   Then the run resumed to 3 epochs (it must start at epoch 2, with weights
   and Adam moments equal to the saved ones bitwise, and run one epoch),
   and ``Predictor.from_checkpoint`` on the test records against ``test``'s
   ``preds_raw.npy``; per-epoch times, the cache build and the peak memory.

The build phase prints ptxas' registers and spills of every kernel and, per
head dim, the blocks of the forward, dK/dV and dQ kernels one SM holds.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
(per kernel, mix-weighted times, ``bound_share`` and ``library_ratio``, its
rows by shape class, and on the moviescope rows the training loop's launches in
phase 13 and per epoch) and, last, ``{"ok": true, "device": {...}}``.  It
imports nothing of JAX or of the JAX package; without a CUDA device, or
without ``bpx_torch`` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
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
FLASH_TOL = dict(atol=2e-2, rtol=2e-2)    # bf16 output
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
REQUESTS = 4               # the second one is ragged
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
TRAIN_STEPS = 3
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
    group, so host-side launch overhead never shows up as device time.
    Inputs stay warm in L2, as on the served path, where each kernel reads
    what the op before it just wrote."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int = 20, inner: int = 10,
                 warmup: int = 5) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
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
        return statistics.median(s.elapsed_time(e)
                                 for s, e in events) / inner


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


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


def flash_class(q, k, masked, kv_lens, rate):
    """(B, H, Tq, Tk, D, masked, has kv_lens, dropout rate)."""
    return (*q.shape[:3], k.shape[2], q.shape[3], masked,
            kv_lens is not None, rate)


@contextlib.contextmanager
def recording():
    """Record the shape classes of every kernel launch (and every hash
    dropout) inside the context: a dict of Counters keyed by "flash",
    "flash_bwd", "ln", "ln_bwd" and "dropout"; and under "copies", by head
    dim, the tensors (q, k, v, dO, O) the flash wrappers had to copy
    before a launch."""
    from bpx_torch.ops import dropout, flash_attention as fa, norm
    seen = {k: collections.Counter()
            for k in ("flash", "flash_bwd", "ln", "ln_bwd", "dropout",
                      "copies")}
    kernel_ready = fa._kernel_ready

    def ready(name, t, device):
        got = kernel_ready(name, t, device)
        seen["copies"][t.shape[3]] += got is not t
        return got

    def flash(launch, q, k, v, masked, kv_lens, rate=0.0, seed=None):
        seen["flash"][flash_class(q, k, masked, kv_lens, rate)] += 1
        return launch(q, k, v, masked, kv_lens, rate, seed)

    def flash_bwd(launch, q, k, v, dout, lse, out, masked, kv_lens,
                  rate=0.0, seed=None):
        seen["flash_bwd"][flash_class(q, k, masked, kv_lens, rate)] += 1
        return launch(q, k, v, dout, lse, out, masked, kv_lens, rate, seed)

    def ln(launch, x, w, b, eps, out_dtype):
        seen["ln"][(x.numel() // x.shape[-1], x.shape[-1], eps, x.dtype,
                    out_dtype)] += 1
        return launch(x, w, b, eps, out_dtype)

    def ln_bwd(launch, x, w, mu, rstd, dy):
        seen["ln_bwd"][(x.numel() // x.shape[-1], x.shape[-1], x.dtype,
                        dy.dtype)] += 1
        return launch(x, w, mu, rstd, dy)

    hash_dropout = dropout.hash_dropout

    def drop(x, rate, seed):
        seen["dropout"][(tuple(x.shape), x.dtype, rate)] += 1
        return hash_dropout(x, rate, seed)

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
    launches' shape classes: (B, H, Tq, Tk, D, masked, has kv_lens, rate)
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
    from bpx_torch.ops.flash_attention import KERNEL_HEAD_DIMS, blocks_per_sm
    for d in KERNEL_HEAD_DIMS:
        print(f"[build] blocks per SM at head_dim {d} (occupancy "
              f"calculator): {blocks_per_sm(d)}")


def kernel_name(mangled: str) -> str:
    """``flash_fwd_kernel<96>`` from a mangled kernel symbol: the length-
    prefixed identifier that ends in ``_kernel``, and its template
    arguments."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            ident = mangled[m.end():m.end() + n]
            if len(ident) == n and ident.endswith("_kernel"):
                args = re.match(r"I(.*?)E+v", mangled[m.end() + n:])
                if args is None:
                    return ident
                targs = re.sub(r"Li(-?[0-9]+)", r"\1", args.group(1))
                return f"{ident}<{targs}>"
    return mangled


def attention_inputs(torch, gen, B, H, Tq, Tk, D, padded):
    """q/k/v as the model hands them over: strided (B, H, T, D) views of
    (B, T, S, H, D) projection outputs, q pre-scaled; per-sample key
    lengths in [64, Tk] (one full row) when ``padded``."""
    bf = torch.bfloat16
    qbuf = torch.randn(B, Tq, 1, H, D, generator=gen, device="cuda")
    kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda")
    q = (qbuf[:, :, 0] * D ** -0.5).to(bf).transpose(1, 2)
    kv = kvbuf.to(bf)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    kv_lens = None
    if padded:
        lens = torch.randint(64, Tk + 1, (B,), generator=gen, device="cuda")
        lens[0] = Tk
        kv_lens = lens.to(torch.int32)
    return q, k, v, kv_lens


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


def phase_flash(torch, timer, classes, gen, label="flash"):
    """The forward kernel against its plain version at each class (with
    the class's dropout rate and a fixed seed)."""
    import torch.nn.functional as F
    from bpx_torch.ops.flash_attention import (effective_band,
                                               flash_attention,
                                               flash_attention_reference)
    rows = []
    seed = 0x9E3779B9
    for (B, H, Tq, Tk, D, masked, padded, rate), count in sorted(
            classes.items()):
        q, k, v, kv_lens = attention_inputs(torch, gen, B, H, Tq, Tk, D,
                                            padded)
        drop = (rate, seed if rate else None)
        out, lse = flash_attention(q, k, v, masked, kv_lens, *drop,
                                   return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, masked, kv_lens,
                                                 *drop)
        again = flash_attention(q, k, v, masked, kv_lens, *drop)
        torch.cuda.synchronize()
        check(torch.equal(out, again),
              f"flash forward reruns differ at {(B, H, Tq, Tk, D, rate)}")
        err_o, err_l = max_err(out, ref), max_err(lse, ref_lse)
        check(torch.allclose(out.float(), ref.float(), **FLASH_TOL),
              f"flash O differs at {(B, H, Tq, Tk, D, rate)}: max err "
              f"{err_o}")
        check(torch.allclose(lse, ref_lse, **LSE_TOL),
              f"flash lse differs at {(B, H, Tq, Tk, D)}: max err {err_l}")

        visible, keys, ok = attention_work(torch, B, H, Tq, Tk, masked,
                                           kv_lens)
        flops = 4.0 * D * visible
        nbytes = 2 * (2 * B * H * Tq * D + 2 * keys * D) + 4 * B * H * Tq
        b_ms, b_by = bound_ms(nbytes, flops)
        t_k = timer(lambda: flash_attention(q, k, v, masked, kv_lens, *drop))
        t_p = timer(lambda: flash_attention_reference(q, k, v, masked,
                                                      kv_lens, *drop))
        sdpa = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=ok, dropout_p=rate, scale=1.0)
        t_l = timer(sdpa)
        backend = sdpa_backend(torch, sdpa)
        eff_masked = effective_band(Tq, Tk, masked)[0]
        rows.append(dict(shape=[B * H, Tq, Tk, D], masked=eff_masked,
                         kv_lens=padded, rate=rate, per_forward=count,
                         max_abs_err=err_o, lse_max_abs_err=err_l, ms=t_k,
                         plain_ms=t_p, library_ms=t_l,
                         library_backend=backend, bound_ms=b_ms,
                         bound_by=b_by))
        print(f"[{label}] BH={B * H} {Tq}x{Tk} D={D} band={eff_masked} "
              f"kv_lens={padded} rate={rate} x{count}: err O {err_o:.3g} "
              f"(tol {FLASH_TOL}) lse {err_l:.3g} (tol {LSE_TOL}); "
              + timing_text(t_k, t_p, t_l, b_ms, b_by, f"sdpa ({backend})"))
    return rows


def sdpa_backend(torch, fn) -> str:
    """Which of SDPA's backends ran ``fn``, from the device kernels the
    profiler names: flash, cuDNN, memory-efficient (cutlass fmha) or the
    math path (matmuls and a softmax)."""
    names = " ".join(device_kernels(torch, fn, n=2)).lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                         ("fmha", "efficient"), ("mem_eff", "efficient")):
        if key in names:
            return backend
    return "math"


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


def takes_kernel(torch, fn, kernel):
    """Fails unless one call of ``fn`` runs one device kernel, ``kernel``."""
    split = one_kernel_per_call(torch, fn, kernel, "a misaligned view")
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


def flash_bwd_work(torch, B, H, Tq, Tk, D, masked, kv_lens):
    """(bytes, flops, SDPA's mask) of the whole backward: q, k, v, dO, O and
    lse read and dq, dk, dv written once; delta's 2 D and the five
    products' 10 D flops per visible score entry."""
    visible, keys, ok = attention_work(torch, B, H, Tq, Tk, masked, kv_lens)
    flops = 10.0 * D * visible + 2.0 * D * B * H * Tq
    nbytes = (2 * D * (4 * B * H * Tq + 2 * keys + 2 * B * H * Tk)
              + 4 * B * H * Tq)
    return nbytes, flops, ok


def sdpa_backward(torch, q, k, v, ok, rate, dout):
    """SDPA's backward alone (its forward runs once) on the same inputs:
    the library yardstick."""
    import torch.nn.functional as F
    ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ok,
                                         dropout_p=rate, scale=1.0)
    return lambda: torch.autograd.grad(out, (ql, kl, vl), dout,
                                       retain_graph=True)


#: the backward's kernels, by the names the profiler reports
BWD_KERNELS = ("flash_delta_kernel", "flash_bwd_dkdv_kernel",
               "flash_bwd_dq_kernel")


def phase_flash_bwd(torch, timer, classes, gen, label="flash_bwd"):
    """The backward kernels (delta, dK/dV, dQ) against the plain backward at
    each class of the recorded micro-step, from the kernel forward's lse;
    the delta kernel on its own against its plain version."""
    from bpx_torch.ops import flash_attention as fa
    rows = []
    seed = 0x7F4A7C15
    for (B, H, Tq, Tk, D, masked, padded, rate), count in sorted(
            classes.items()):
        q, k, v, kv_lens = attention_inputs(torch, gen, B, H, Tq, Tk, D,
                                            padded)
        drop = (rate, seed if rate else None)
        out, lse = fa.flash_attention(q, k, v, masked, kv_lens, *drop,
                                      return_lse=True)
        # dO as the model hands it over: a (B, H, T, D) view of (B, T, H, D)
        dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)
        delta = fa.attention_delta(dout, out)
        want_delta = fa.attention_delta_reference(dout, out)
        got = fa._launch_bwd(q, k, v, dout, lse, out, masked, kv_lens, *drop)
        want = fa.flash_attention_backward_reference(
            q, k, v, dout, lse, want_delta, masked, kv_lens, *drop)
        torch.cuda.synchronize()
        err_d = max_err(delta, want_delta)
        check(torch.allclose(delta, want_delta, **DELTA_TOL),
              f"flash delta differs at {(B, H, Tq, D)}: max err {err_d}")
        errs = [grad_err(g, w) for g, w in zip(got, want)]
        check(max(errs) <= FLASH_GRAD_TOL,
              f"flash backward differs at {(B, H, Tq, Tk, D, rate)}: "
              f"dq/dk/dv relative errors {errs}")

        nbytes, flops, ok = flash_bwd_work(torch, B, H, Tq, Tk, D, masked,
                                           kv_lens)
        b_ms, b_by = bound_ms(nbytes, flops)
        t_k = timer(lambda: fa._launch_bwd(q, k, v, dout, lse, out, masked,
                                           kv_lens, *drop))
        t_p = timer(lambda: fa.flash_attention_backward_reference(
            q, k, v, dout, lse, fa.attention_delta_reference(dout, out),
            masked, kv_lens, *drop))
        sdpa = sdpa_backward(torch, q, k, v, ok, rate, dout)
        t_l = timer(sdpa)
        backend = sdpa_backend(torch, sdpa)
        split = kernel_ms(torch, lambda: fa._launch_bwd(
            q, k, v, dout, lse, out, masked, kv_lens, *drop), BWD_KERNELS)
        dq_b, dkdv_b = split_bounds(torch, B, H, Tq, Tk, D, masked, kv_lens)
        again = fa._launch_bwd(q, k, v, dout, lse, out, masked, kv_lens,
                               *drop)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"flash backward reruns differ at {(B, H, Tq, Tk, D, rate)}")
        eff_masked = fa.effective_band(Tq, Tk, masked)[0]
        rows.append(dict(shape=[B * H, Tq, Tk, D], masked=eff_masked,
                         kv_lens=padded, rate=rate, per_forward=count,
                         max_abs_err=max(max_err(g, w)
                                         for g, w in zip(got, want)),
                         rel_err=max(errs), delta_max_abs_err=err_d,
                         ms=t_k, plain_ms=t_p, library_ms=t_l,
                         library_backend=backend, bound_ms=b_ms,
                         bound_by=b_by, kernel_split_ms=split,
                         dq_bound_ms=dq_b[0], dkdv_bound_ms=dkdv_b[0]))
        print(f"[{label}] BH={B * H} {Tq}x{Tk} D={D} band={eff_masked} "
              f"kv_lens={padded} rate={rate} x{count}/micro-step: "
              f"dq/dk/dv rel err {max(errs):.3g} (tol {FLASH_GRAD_TOL}), "
              f"delta err {err_d:.3g} (tol {DELTA_TOL}), reruns bitwise "
              f"equal; delta + dK/dV + dQ "
              + timing_text(t_k, t_p, t_l, b_ms, b_by,
                            f"sdpa bwd ({backend})")
              + "; profiler: " + ", ".join(f"{n} {t:.4f} ms"
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
        rows.append(dict(shape=[n, e], dtype=str(dt), dy_dtype=str(dy_dt),
                         per_forward=count, max_abs_err=err,
                         param_rel_err=perr,
                         ms=t_k, plain_ms=t_p, library_ms=t_l,
                         bound_ms=b_ms, bound_by=b_by, kernel_split_ms=split))
        print(f"[layer_norm_bwd] ({n}, {e}) {dt}, dy {dy_dt} x{count}/"
              f"micro-step: dx err {err:.3g} (tol {LN_TOL}), dw/db rel err "
              f"{perr:.3g} (tol {LN_PARAM_GRAD_TOL}), reruns bitwise equal; "
              + timing_text(t_k, t_p, t_l, b_ms, b_by, "F.layer_norm bwd")
              + "; profiler: " + split_text(split))
    if not scalar_path:
        return rows
    # the scalar path once, too, on misaligned views
    n, e = 133, 768
    x, dy = (misaligned_view(torch, gen, n, e) for _ in range(2))
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    _, mu, rstd = norm.layer_norm(x, w, torch.zeros_like(w), 1e-6,
                                  return_stats=True)
    got = norm._launch_bwd(x, w, mu, rstd, dy)
    want = norm.layer_norm_backward_reference(x, w, mu, rstd, dy)
    perr = max(grad_err(g, r) for g, r in zip(got[1:], want[1:]))
    check(torch.allclose(got[0].float(), want[0].float(), **LN_TOL)
          and perr <= LN_PARAM_GRAD_TOL,
          f"layer_norm backward scalar path differs: dx "
          f"{max_err(got[0], want[0])}, dw/db {perr}")
    takes_kernel(torch, lambda: norm._launch_bwd(x, w, mu, rstd, dy),
                 "ln_bwd_scalar_kernel")
    return rows


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
        ctx = type("Ctx", (), {})()
        t_f = timer(lambda: _HashDropout.forward(ctx, x, rate, 12345),
                    reps=5, inner=4)
        t_b = timer(lambda: _HashDropout.backward(ctx, g), reps=5, inner=4)
        total += count * (t_f + t_b)
        print(f"[dropout] {tuple(shape)} {dt} rate={rate} x{count}/"
              f"micro-step: forward {t_f:.4f} ms, backward {t_b:.4f} ms")
    print(f"[dropout] plain hash dropout per micro-step: {total:.2f} ms")
    return total


def phase_mask_check(torch, gen, B, H, T, D):
    """Exact mask check: q = 0 makes every probability 1/T, so with V_r[j,
    c] = [j == D r + c] column c of O is the keep bit of key D r + c times
    bf16(inv_keep)/T, and with dO = V_r row j of dV holds the bits of query
    D r + c at key j; ceil(T / D) rounds (one, V = I, when D = T) cover
    every (query, key), every key visible.  Compared with the plain
    version's mask for equality (a tolerance on O would not see a few wrong
    bits), and O with the plain version's O."""
    from bpx_torch.ops import flash_attention as fa
    rate, seed = 0.1, 0xDEADBEEF
    bf = torch.bfloat16
    q = torch.zeros(B, H, T, D, device="cuda", dtype=bf)
    k = torch.randn(B, H, T, D, generator=gen, device="cuda").to(bf)
    fwd = torch.zeros(B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    rounds = (T + D - 1) // D
    same = True
    for r in range(rounds):
        c = j - D * r
        sel = (c >= 0) & (c < D)
        onehot = torch.zeros(T, D, device="cuda", dtype=bf)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(B, H, T, D)
        out, lse = fa.flash_attention(q, k, e, False, None, rate, seed,
                                      return_lse=True)
        ref, _ = fa.flash_attention_reference(q, k, e, False, None, rate,
                                              seed)
        _, _, dv = fa._launch_bwd(q, k, e, e, lse, out, False, None, rate,
                                  seed)
        same = same and torch.equal(out, ref)
        fwd[..., sel] = out[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    keep = fa.keep_mask(seed, B, H, T, T, rate, "cuda")
    torch.cuda.synchronize()
    bad_f = int((fwd != keep).sum())
    bad_b = int((bwd != keep).sum())
    print(f"[mask] D={D} at ({B}, {H}, {T}, {T}), {rounds} round(s): "
          f"forward mask bits differing from the plain version's: {bad_f} "
          f"of {keep.numel()}; backward (dV): {bad_b}; kept "
          f"{keep.float().mean().item():.4f} (1 - rate = {1 - rate})")
    check(bad_f == 0 and bad_b == 0 and same,
          f"the kernels' dropout mask at head_dim {D} differs from the "
          f"plain version's")


def device_kernels(torch, fn, n: int = 20):
    """{kernel: (activities per call, device ms per call)} of ``fn``, from
    the profiler's device events (kernels, memsets, copies) over ``n``
    calls; a kernel is named as ``short_name`` gives it.  The profiler now
    and then drops events, or a whole profile: a profile whose counts are
    not whole multiples of ``n`` is taken again (up to 5 times, keeping the
    fullest), counts are rounded to whole activities per call (at least one
    for a kernel seen at all), and times taken over the events seen."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best_total, got = -1, {}
    for _ in range(5):
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


def split_bounds(torch, B, H, Tq, Tk, D, masked, kv_lens):
    """Bounds of the dQ and the dK/dV kernel alone, each against the work
    it does: both read q, k, v, dO, lse and delta and compute S and dP (4 D
    flops per visible score entry); dQ then writes dq (2 D more), dK/dV
    writes dk and dv (4 D more)."""
    visible, keys, _ = attention_work(torch, B, H, Tq, Tk, masked, kv_lens)
    bh = B * H
    io = 2 * D * (2 * bh * Tq + 2 * keys) + 8 * bh * Tq
    return (bound_ms(io + 2 * D * bh * Tq, 6.0 * D * visible),
            bound_ms(io + 4 * D * bh * Tk, 8.0 * D * visible))


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

    visible, keys, ok = attention_work(torch, B, H, Tq, Tk, True, None)
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
            q, k, v, attn_mask=ok, dropout_p=rate, scale=1.0)), *f_ms)
    # rows 3 and 4: the dQ and dK/dV kernels, each against the work it does
    # (S and dP, then dQ; S^T and dP^T, then dV and dK); SDPA has no call of
    # its own for either, so its whole backward stands beside the pair
    split = kernel_ms(torch, lambda: fa._launch_bwd(
        q, k, v, dout, lse, out, True, None, rate, seed), BWD_KERNELS)
    t_l = timer(sdpa_backward(torch, q, k, v, ok, rate, dout))
    dq_b, dkdv_b = split_bounds(torch, B, H, Tq, Tk, D, True, None)
    rows["3 dQ kernel"] = (split["flash_bwd_dq_kernel"], None, t_l, *dq_b)
    rows["4 dK/dV kernel"] = (split["flash_bwd_dkdv_kernel"], None, t_l,
                              *dkdv_b)
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
    print(f"[long] D={D} delta kernel {split['flash_delta_kernel']:.4f} ms "
          f"of the backward")
    return {name: dict(ms=r[0], plain_ms=r[1], library_ms=r[2],
                       bound_ms=r[3], bound_by=r[4])
            for name, r in rows.items()}


def experiment(path: ModelPath):
    from bpx_torch.config import get_preset
    exp = get_preset(path.preset)
    return exp.replace(model=exp.model.replace(fusion=path.fusion))


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
    print(f"[serve {path.preset}] {m.model} fusion={m.fusion}, "
          f"{n_params / 1e6:.1f} M params, {m.compute_dtype}, built in "
          f"{time.time() - t0:.1f} s")
    reqs = [synthetic_batch(exp, BATCH, seed=100 + i)
            for i in range(requests)]
    return pred, reqs


def gates_dim(m) -> int:
    """Width of the final fusion's gates: the N-ary GMU's N * E, MAG's
    alpha 1."""
    if m.fusion == "mag":
        return 1
    return (4 if m.model == "mmtrvapt" else 3) * m.hidden_sz


def record_forward(path: ModelPath, pred, batch, head_dim=None):
    """Serve ``batch`` once (the warm-up request: cuBLAS/cuDNN set-up),
    recording every launch; the counts must be the structure's, the
    encoders' attentions at ``head_dim`` (BERT's 12 at 64), and the flash
    wrappers must have copied nothing."""
    flash_cls, ln_cls, copies = launch_classes(pred, batch)
    n_flash, n_ln = sum(flash_cls.values()), sum(ln_cls.values())
    by_dim = collections.Counter()
    for cls, c in flash_cls.items():
        by_dim[cls[4]] += c
    print(f"[serve {path.preset}] recorded forward: {n_flash} flash "
          f"launches in {len(flash_cls)} shape classes (by head_dim "
          f"{dict(by_dim)}), {n_ln} layer_norm launches in {len(ln_cls)} "
          f"(structure: {path.flash}, {path.ln}); tensors the flash "
          f"wrappers copied, by head_dim: {dict(copies)}")
    check(n_flash == path.flash and n_ln == path.ln,
          f"the recorded {path.preset} forward's launches differ from the "
          f"structure's")
    if head_dim is not None:
        check(by_dim == {head_dim: path.flash - 12, 64: 12},
              f"{path.preset}: flash launches by head_dim {dict(by_dim)}")
    check(not sum(copies.values()),
          f"{path.preset}: the flash wrappers copied tensors, by head_dim "
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

    tag = f"[serve {path.preset}]"
    n_cls = pred.exp.model.n_classes
    n_gates = gates_dim(pred.exp.model)
    n_req = len(reqs)
    reqs = list(reqs)
    full = reqs[1] if n_req > 1 else None
    if full is not None:
        reqs[1] = {k: v[:5] for k, v in full.items()}   # a ragged request
    torch.cuda.synchronize()

    flash_attention.launches = 0
    layer_norm.launches = 0
    outs, lat = [], []
    for batch in reqs:
        t = time.perf_counter()
        probs, gates = pred(batch, return_gates=True)
        lat.append((time.perf_counter() - t) * 1e3)
        outs.append((probs, gates))
    n_flash, n_ln = flash_attention.launches, layer_norm.launches

    print(f"{tag} {n_req} requests: flash launches {n_flash} "
          f"({n_flash / n_req:g}/forward), layer_norm launches {n_ln} "
          f"({n_ln / n_req:g}/forward)")
    check(n_flash == path.flash * n_req,
          f"flash kernel launched {n_flash} times, expected "
          f"{path.flash * n_req}")
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
        return (max(float(np.abs(a[0] - b[0]).max())
                    for a, b in zip(served, plain)),
                max(float(np.abs(a[1] - b[1]).max())
                    for a, b in zip(served, plain)))

    perr, gerr = errors(outs)
    print(f"{tag} kernels vs plain versions: probs max err {perr:.3g} "
          f"(tol {path.probs_tol}), gates max err {gerr:.3g} (tol "
          f"{path.gates_tol})")
    check(perr <= path.probs_tol,
          f"{path.preset}: probs differ from the plain path by {perr}")
    check(gerr <= path.gates_tol,
          f"{path.preset}: gates differ from the plain path by {gerr}")

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
              f"{path.preset}: the comparison with the plain path misses a "
              f"planted fault ({fault})")

    if full is not None:
        # a ragged request's rows equal the same rows served in a full batch
        fp = pred(full)
        rerr = float(np.abs(fp[:5] - outs[1][0]).max())
        print(f"{tag} ragged request vs the same rows in a full batch: "
              f"max err {rerr:.3g}")
        check(rerr <= path.probs_tol, f"ragged request differs by {rerr}")

    med = statistics.median(lat)
    print(f"{tag} per-request latency (host clock, numpy in -> numpy "
          f"out): median {med:.2f} ms over {n_req}: "
          + ", ".join(f"{x:.2f}" for x in lat))
    if profile:
        profile_forward(torch, pred, reqs[0])
    return dict(latency_ms=lat, median_ms=med, flash_launches=n_flash,
                ln_launches=n_ln, probs_err=perr, gates_err=gerr,
                planted_faults=planted)


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

def train_batch(torch, np, exp, seed: int, label_p):
    """A numpy-seeded (A, micro, ...) super-batch on the card, with
    multilabel targets drawn at the synthetic label frequencies, or (no
    ``label_p``: cmu-mosi) one real-valued target per sample."""
    b = synthetic_batch(exp, TRAIN_A * BATCH, seed)
    rng = np.random.RandomState(seed + 1)
    if label_p is None:
        b["target"] = rng.uniform(-3, 3, TRAIN_A * BATCH).astype(np.float32)
    else:
        b["target"] = (rng.rand(TRAIN_A * BATCH, len(label_p))
                       < label_p).astype(np.float32)
    return {k: torch.from_numpy(v.reshape(TRAIN_A, BATCH, *v.shape[1:]))
            .to("cuda") for k, v in b.items()}


def phase_trainer(torch, np, path: ModelPath = MOVIESCOPE,
                  steps: int = TRAIN_STEPS):
    """The path's model at full width and depth in training mode, Adam at
    LR, BCE with pos_weight from synthetic label frequencies (cmu-mosi: its
    L1 loss on real-valued targets), and the accumulation step at A =
    TRAIN_A."""
    from bpx_torch.models import get_model
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    exp = experiment(path)
    m = exp.model
    regression = exp.data.task == "cmu-mosi"
    check(regression or exp.data.task_type == "multilabel",
          f"{path.preset} is neither multilabel nor cmu-mosi")
    t0 = time.time()
    model = get_model(m, device="cuda", seed=0).train()
    rng = np.random.RandomState(7)
    n_train = 1000
    freqs = rng.randint(30, 400, size=m.n_classes)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), n_train, device="cuda")
    opt = make_optimizer(model.parameters(), LR)
    step = make_train_step(model, m.model, loss_fn, opt,
                           grad_accum=TRAIN_A,
                           generator=torch.Generator().manual_seed(0))
    batches = [train_batch(torch, np, exp, 300 + i,
                           None if regression else freqs / n_train)
               for i in range(steps)]
    torch.cuda.synchronize()
    print(f"[train {path.preset}] {m.model}, Adam lr {LR}, "
          f"{'L1' if regression else 'BCE with pos_weight'}, micro-batch "
          f"{BATCH} x A={TRAIN_A}, {m.compute_dtype}, attention_impl "
          f"{m.attention_impl}; built in {time.time() - t0:.1f} s")
    return model, loss_fn, step, batches


def grad_groups(model):
    """Parameter groups for the gradient comparison: BERT's embeddings,
    BERT's layers, and every other top-level module."""
    groups = collections.defaultdict(list)
    for n, p in model.named_parameters():
        top = n.split(".")[0]
        if top == "bert":
            top = "bert.layers" if n.startswith("bert.layers.") \
                else "bert.embeddings"
        groups[top].append(p)
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
    errs = {}
    for g, got in flat_grads(torch, groups).items():
        e = ((got - ref[g]).norm() / ref[g].norm()).item()
        errs[g] = e if math.isfinite(e) else float("inf")
    return errs


# the backward launched without part of its contract, to show that the
# micro-step comparison with the plain path catches a wrong kernel
TRAIN_FAULTS = {
    "flash backward ignores its dropout mask":
        lambda launch, q, k, v, do, lse, out, masked, kv_lens, rate, seed:
            launch(q, k, v, do, lse, out, masked, kv_lens, 0.0, None),
    "flash backward ignores the band":
        lambda launch, q, k, v, do, lse, out, masked, kv_lens, rate, seed:
            launch(q, k, v, do, lse, out, False, kv_lens, rate, seed),
}


def phase_micro_step(torch, model, loss_fn, batches,
                     path: ModelPath = MOVIESCOPE):
    """One micro-step with the kernels (recording every launch's class)
    against the same step under plain_versions(): same weights, batch and
    dropout seed.  Then the planted faults; and the wrappers' copies at a
    narrow head dim, which must be none."""
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.dispatch import plain_versions
    micro = {k: v[0] for k, v in batches[0].items()}
    seed = 0x5EED
    groups = grad_groups(model)
    # the scale of bf16 rounding: the same step in fp32 compute (plain
    # versions, same weights and dropout masks) as a yardstick for both
    model32 = type(model)(model.config.replace(compute_dtype="float32"),
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
    tag = f"[micro-step {path.preset}]"
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
    faults = {}
    for fault, wrap in TRAIN_FAULTS.items():
        with wrapped_launch(fa, wrap, "_launch_bwd"):
            micro_step(model, loss_fn, micro, seed)
        ferrs = group_errors(torch, groups, ref)
        fworst = max(ferrs, key=ferrs.get)
        faults[fault] = dict(group=fworst, grad_err=ferrs[fworst])
        print(f"{tag} planted fault, {fault}: worst group {fworst} "
              f"rel err {ferrs[fworst]:.3g}")
        check(ferrs[fworst] > path.grad_tol,
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
    return seen, dict(loss_err=lerr, grad_err=errs[worst], worst=worst,
                      planted_faults=faults)


def phase_train(torch, model, step, batches, profile: bool,
                path: ModelPath = MOVIESCOPE):
    """TRAIN_STEPS accumulation steps with the launch counters checked per
    step; step time on the host clock around a synchronised step."""
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    from bpx_torch.ops.norm import layer_norm, layer_norm_backward
    tag = f"[train {path.preset}]"
    counters = (flash_attention, flash_attention_backward, layer_norm,
                layer_norm_backward)
    want = dict(flash=path.flash * TRAIN_A, dropout=path.dropout * TRAIN_A,
                flash_bwd=path.flash * TRAIN_A,
                ln=path.ln_train * TRAIN_A, ln_bwd=path.ln_train * TRAIN_A)
    totals = collections.Counter()
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        for c in counters:
            c.launches = 0
        flash_attention.dropout_launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(batch)["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        got = dict(flash=flash_attention.launches,
                   dropout=flash_attention.dropout_launches,
                   flash_bwd=flash_attention_backward.launches,
                   ln=layer_norm.launches, ln_bwd=layer_norm_backward.launches)
        totals.update(got)
        losses.append(loss)
        print(f"{tag} step {i + 1}: loss {loss:.6f}, {times[-1]:.1f} ms; "
              f"launches {got}")
        check(got == want, f"step {i + 1} launches {got}, expected {want}")
        check(math.isfinite(loss), f"step {i + 1} loss is {loss}")
        if i == 0:
            check_grads(torch, model)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = statistics.median(times)
    print(f"{tag} step time (host clock, synchronised) median {med:.1f} ms "
          f"over {len(times)} steps: " + ", ".join(f"{x:.1f}" for x in times)
          + f"; {TRAIN_A * BATCH / med * 1e3:.2f} samples/s; peak memory "
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
                       "_FlashAttention", "_FlashAttentionBackward",
                       "_LayerNorm", "_LayerNormBackward"):
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
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    from bpx_torch.ops.norm import layer_norm, layer_norm_backward
    from bpx_torch.train import loop

    def read():
        return dict(flash=flash_attention.launches,
                    dropout=flash_attention.dropout_launches,
                    flash_bwd=flash_attention_backward.launches,
                    ln=layer_norm.launches,
                    ln_bwd=layer_norm_backward.launches)

    def counted(factory, kind):
        def make(*args, **kw):
            fn = factory(*args, **kw)

            def run(batch):
                before = read()
                out = fn(batch)
                after = read()
                calls.append((kind, {k: after[k] - before[k]
                                     for k in after}))
                return out
            return run
        return make

    made = loop.make_train_step, loop.make_eval_step
    loop.make_train_step = counted(made[0], "step")
    loop.make_eval_step = counted(made[1], "eval")
    try:
        yield read
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


def phase_loop(torch, np, card: str, checked):
    """The README's moviescope command through ``bpx_torch.cli.train.
    cli_main`` in this process: the memmap cache, two epochs, checkpoints,
    ``test``; a resume to three epochs with the restored state checked bit
    for bit against the saved one; ``Predictor.from_checkpoint`` against
    ``test``'s ``preds_raw.npy``.  ``checked``: the launch classes the
    earlier phases held against the plain versions, per kernel."""
    from bpx_torch.cli.train import cli_main
    from bpx_torch.config import config_from_dict
    from bpx_torch.data.loaders import get_data_loaders
    from bpx_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_backward)
    from bpx_torch.ops.norm import layer_norm, layer_norm_backward
    from bpx_torch.serve import Predictor
    from bpx_torch.utils.checkpoint import CheckpointManager
    tag = "[loop]"
    tmp = Path(tempfile.mkdtemp(prefix="bpx_loop_"))
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
            for c in (flash_attention, flash_attention_backward, layer_norm,
                      layer_norm_backward):
                c.launches = 0
            flash_attention.dropout_launches = 0
            results = cli_main(epochs(2))
            totals = read()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check_loop_calls(calls, 2 * LOOP_STEPS, 2 * LOOP_EVALS + LOOP_TESTS,
                         tag)
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
        check(host["epoch"] == 2, f"{tag} host_state.json epoch "
                                  f"{host['epoch']}, expected 2")

        # resume to three epochs: one epoch from epoch 2, restored bitwise
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
                cli_main(epochs(3))
                wall2 = time.time() - t1
        finally:
            CheckpointManager.restore = restore
        del saved
        check(restored.get("host", (None, {}))[1].get("epoch") == 2,
              f"{tag} the resume did not start at epoch 2: {restored}")
        check(restored["weights"] and restored["moments"],
              f"{tag} the restored weights or Adam moments differ from the "
              f"saved ones")
        check_loop_calls(calls2, LOOP_STEPS, LOOP_EVALS + LOOP_TESTS,
                         f"{tag} resume")
        print(f"{tag} resumed at epoch 2 (step {restored['host'][0]}) and "
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
        probs = np.concatenate([pred(b) for b in test_loader])
        want = np.load(run / "preds_raw.npy")
        err = float(np.abs(probs - want).max())
        print(f"{tag} Predictor.from_checkpoint (best, restored in "
              f"{load_s:.1f} s) on the {len(want)} test records against "
              f"test's preds_raw.npy: max abs err {err:.3g} (tol "
              f"{LOOP_PROBS_TOL})")
        check(probs.shape == want.shape and err <= LOOP_PROBS_TOL,
              f"{tag} from_checkpoint differs from preds_raw.npy by {err}")
        del pred

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
        print(f"{tag} two epochs, checkpoints and test in {wall:.1f} s, the "
              f"resume in {wall2:.1f} s; peak memory {peak:.2f} GiB "
              f"(max_memory_allocated); card: {card}")
        check(len(stats) == 3, f"{tag} {len(stats)} epochs logged")
        per_epoch = collections.Counter()
        for _, c in calls[:LOOP_STEPS + LOOP_EVALS]:    # epoch 0
            per_epoch.update(c)
        return dict(wall_s=wall, resume_s=wall2, peak_gib=peak, epochs=stats,
                    cache=builds, from_checkpoint_err=err,
                    launches=totals, launches_per_epoch=dict(per_epoch))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def summarise(name, source, replaces, rows, launches, runs, per):
    """One kernel's entry: times are per launch, averaged over the recorded
    run's mix of shapes (weights: each class's launches in that run)."""
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
    print(f"[summary] {name} (mix-weighted): {ms:.4f} ms, library "
          f"{lib:.4f} ms ({ms / lib:.2f}x), bound {bound:.4f} ms "
          f"({bound / ms:.1%} of the bound)")
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
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)

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
    m_trained = phase_train(torch, model, step, batches, args.profile,
                            MMIMDB)
    del model, loss_fn, step, batches
    torch.cuda.empty_cache()
    print(f"[time] mmimdb phases {time.time() - t0:.1f} s")

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

    # the training loop: moviescope's full-width model through the CLI,
    # at the classes the moviescope phases held against the plain versions
    t0 = time.time()
    looped = phase_loop(torch, np, card, dict(
        flash=set(flash_cls) | {k for k in seen["flash"] if k[-1] > 0},
        flash_bwd=set(seen["flash_bwd"]), ln=set(ln_cls),
        ln_bwd=set(seen["ln_bwd"])))
    torch.cuda.empty_cache()
    print(f"[time] loop phase {time.time() - t0:.1f} s")

    steps = TRAIN_STEPS * TRAIN_A
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
        # mmimdb: head_dim 128 (and BERT's 64)
        summarise("flash_fwd_mmimdb", fwd_src, fwd_tpu, m_flash_rows,
                  m_served["flash_launches"], REQUESTS, "forward"),
        summarise("flash_fwd_dropout_mmimdb", fwd_src, drop_tpu, m_drop_rows,
                  m_trained["totals"]["dropout"], steps, "micro_step"),
        summarise("flash_bwd_mmimdb", bwd_src, bwd_tpu, m_bwd_rows,
                  m_trained["totals"]["flash_bwd"], steps, "micro_step"),
        summarise("layer_norm_fwd_mmimdb", ln_src, "bpx/ops/norm.py:53",
                  m_ln_rows, m_served["ln_launches"], REQUESTS, "forward"),
        summarise("layer_norm_bwd_mmimdb", ln_bwd_src, "bpx/ops/norm.py:69",
                  m_ln_bwd_rows, m_trained["totals"]["ln_bwd"], steps,
                  "micro_step"),
    ]
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
