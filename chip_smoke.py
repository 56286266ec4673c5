#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``bpx_torch``) on one CUDA card.

    python3 chip_smoke.py              # build, check, serve; last line is JSON
    python3 chip_smoke.py --profile    # also print a kernel-time breakdown of
                                       # one served forward

Phases, each of which fails the script (non-zero exit) if it fails:

1. build the CUDA kernels from ``bpx_torch/csrc`` with nvcc for sm_90a;
   print the card's name and power limit;
2. build ``bpx_torch.serve.Predictor`` for the ``moviescope`` preset at
   full width (BERT-base T=512, 12 four-layer hidden-768 encoders, conv
   audio encoder, GMUs), batch 8, bf16, seeded random weights, and serve
   one warm-up request while recording the arguments of every kernel
   launch: these are the shape classes of the served forward;
3. the flash-attention kernel against its plain PyTorch version at every
   recorded shape class: max error of O and of the log-sum-exp, kernel /
   plain / ``F.scaled_dot_product_attention`` times (CUDA events, median of
   20 groups of 10 warm runs) and the bound (the larger of bytes / 3.35
   TB/s and flops / 989 TFLOP/s);
4. the LayerNorm kernel likewise at its recorded shape classes
   (``F.layer_norm`` as the library yardstick);
5. the serving path: numpy-seeded synthetic requests, one of them ragged.
   The launch counters are set to 0 before the requests and read after:
   every attention and every LayerNorm must have gone through the kernels.
   Probabilities and gates are checked for shape, range and finiteness, and
   against the same forward with the plain versions forced on the card.
   Planted faults (the flash kernel launched without its ``kv_lens``, or
   without its band) must move that comparison past its limits.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  It imports nothing of JAX or
of the JAX package; without a CUDA device, or without ``bpx_torch`` beside
it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import statistics
import subprocess
import sys
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
def wrapped_launch(module, wrap):
    """Route every kernel launch of ``module`` (its ``_launch(*args)``)
    through ``wrap(launch, *args)`` inside the context."""
    launch = module._launch
    module._launch = lambda *args: wrap(launch, *args)
    try:
        yield
    finally:
        module._launch = launch


def launch_classes(pred, batch):
    """Serve ``batch`` once and return, per kernel, a Counter of the
    launches' shape classes: (B, H, Tq, Tk, D, masked, has kv_lens) for
    the flash kernel, (rows, E, eps, in dtype, out dtype) for LayerNorm."""
    from bpx_torch.ops import flash_attention as fa, norm
    flash, ln = collections.Counter(), collections.Counter()

    def flash_seen(launch, q, k, v, masked, kv_lens):
        flash[(*q.shape[:3], k.shape[2], q.shape[3], masked,
               kv_lens is not None)] += 1
        return launch(q, k, v, masked, kv_lens)

    def ln_seen(launch, x, w, b, eps, out_dtype):
        ln[(x.numel() // x.shape[-1], x.shape[-1], eps, x.dtype,
            out_dtype)] += 1
        return launch(x, w, b, eps, out_dtype)

    with wrapped_launch(fa, flash_seen), wrapped_launch(norm, ln_seen):
        pred(batch)
    return flash, ln


# a flash kernel launched without part of its mask, to show that the
# whole-forward comparison with the plain path catches a wrong kernel
PLANTED_FAULTS = {
    "flash kernel ignores kv_lens":
        lambda launch, q, k, v, masked, kv_lens:
            launch(q, k, v, masked, None),
    "flash kernel ignores the band":
        lambda launch, q, k, v, masked, kv_lens:
            launch(q, k, v, False, kv_lens),
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
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}")


def phase_flash(torch, timer, classes, gen):
    import torch.nn.functional as F
    from bpx_torch.ops.flash_attention import (effective_band,
                                               flash_attention,
                                               flash_attention_reference)
    from bpx_torch.ops.masks import band_allowed
    rows = []
    for (B, H, Tq, Tk, D, masked, padded), count in sorted(classes.items()):
        # q/k/v as the model hands them over: strided (B, H, T, D) views of
        # (B, T, S, H, D) projection outputs, q pre-scaled
        bf = torch.bfloat16
        qbuf = torch.randn(B, Tq, 1, H, D, generator=gen, device="cuda")
        kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda")
        q = (qbuf[:, :, 0] * D ** -0.5).to(bf).transpose(1, 2)
        kv = kvbuf.to(bf)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        kv_lens = None
        if padded:
            lens = torch.randint(64, Tk + 1, (B,), generator=gen,
                                 device="cuda")
            lens[0] = Tk
            kv_lens = lens.to(torch.int32)
        out, lse = flash_attention(q, k, v, masked, kv_lens, return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, masked, kv_lens)
        torch.cuda.synchronize()
        err_o, err_l = max_err(out, ref), max_err(lse, ref_lse)
        check(torch.allclose(out.float(), ref.float(), **FLASH_TOL),
              f"flash O differs at {(B, H, Tq, Tk, D)}: max err {err_o}")
        check(torch.allclose(lse, ref_lse, **LSE_TOL),
              f"flash lse differs at {(B, H, Tq, Tk, D)}: max err {err_l}")

        eff_masked, _ = effective_band(Tq, Tk, masked)
        ok = torch.ones(B, 1, Tq, Tk, dtype=torch.bool, device="cuda")
        if eff_masked:
            ok = ok & band_allowed(Tq, Tk, "cuda")
        if kv_lens is not None:
            col = torch.arange(Tk, device="cuda")
            ok = ok & (col[None, :] < kv_lens[:, None])[:, None, None, :]
        # work this run's data needs: the visible score entries, and the
        # keys below kv_len (the kernel never reads the padded ones)
        visible = ok.sum().item() * H
        keys = (kv_lens.sum().item() if padded else B * Tk) * H
        flops = 4.0 * D * visible
        nbytes = 2 * (2 * B * H * Tq * D + 2 * keys * D) + 4 * B * H * Tq
        b_ms, b_by = bound_ms(nbytes, flops)
        sdpa_mask = None if ok.all() else ok
        t_k = timer(lambda: flash_attention(q, k, v, masked, kv_lens))
        t_p = timer(lambda: flash_attention_reference(q, k, v, masked,
                                                      kv_lens))
        t_l = timer(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask, scale=1.0))
        rows.append(dict(shape=[B * H, Tq, Tk, D], masked=eff_masked,
                         kv_lens=padded, per_forward=count,
                         max_abs_err=err_o, lse_max_abs_err=err_l, ms=t_k,
                         plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by))
        print(f"[flash] BH={B * H} {Tq}x{Tk} D={D} band={eff_masked} "
              f"kv_lens={padded} x{count}/fwd: err O {err_o:.3g} "
              f"(tol {FLASH_TOL}) lse {err_l:.3g} (tol {LSE_TOL}); "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, sdpa {t_l:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    return rows


def phase_layer_norm(torch, timer, classes, gen):
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
        rows.append(dict(shape=[n, e], eps=eps, dtype=str(dt),
                         out_dtype=str(out_dt), per_forward=count,
                         max_abs_err=err, ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b_ms, bound_by=b_by))
        print(f"[layer_norm] ({n}, {e}) eps={eps:g} {dt} -> {out_dt} "
              f"x{count}/fwd: err {err:.3g} (tol {LN_TOL}); kernel "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, F.layer_norm {t_l:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")
    # the scalar path (a width the vector loads do not take) once, too
    x = torch.randn(64, 300, generator=gen, device="cuda").to(torch.bfloat16)
    w, b = torch.ones(300, device="cuda"), torch.zeros(300, device="cuda")
    y = layer_norm(x, w, b, 1e-6, torch.float32)
    ry, _, _ = layer_norm_reference(x, w, b, 1e-6, torch.float32)
    check(torch.allclose(y, ry, atol=1e-4, rtol=1e-4),
          f"layer_norm scalar path differs: {max_err(y, ry)}")
    return rows


def synthetic_batch(exp, n: int, seed: int):
    """numpy-seeded moviescope-shaped request: text with per-sample
    contiguous-suffix padding, VGG-like video frames, mel-like audio
    frames, a poster vector."""
    import numpy as np
    rng = np.random.RandomState(seed)
    m, d = exp.model, exp.data
    T = m.num_vectors_l
    lens = rng.randint(64, T + 1, size=n)
    lens[0] = T
    mask = np.arange(T)[None, :] < lens[:, None]
    txt = rng.randint(1, m.bert.vocab_size, size=(n, T)) * mask
    return {
        "txt": txt.astype(np.int32),
        "mask": mask.astype(np.int32),
        "segment": np.zeros((n, T), np.int32),
        "video": rng.rand(n, d.video_len, m.orig_d_v).astype(np.float32),
        "audio": rng.rand(n, d.audio_raw_len, m.orig_d_a).astype(np.float32),
        "poster": rng.rand(n, m.orig_d_p).astype(np.float32),
    }


def phase_predictor(torch):
    from bpx_torch.config import get_preset
    from bpx_torch.serve import Predictor
    exp = get_preset("moviescope")
    t0 = time.time()
    pred = Predictor(exp, batch_size=BATCH, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"[serve] moviescope mmtrvapt, {n_params / 1e6:.1f} M params, "
          f"{exp.model.compute_dtype}, built in {time.time() - t0:.1f} s")
    reqs = [synthetic_batch(exp, BATCH, seed=100 + i)
            for i in range(REQUESTS)]
    return pred, reqs


def phase_serve(torch, np, pred, reqs, profile: bool):
    from bpx_torch.ops import flash_attention as fa
    from bpx_torch.ops.dispatch import plain_versions
    from bpx_torch.ops.flash_attention import flash_attention
    from bpx_torch.ops.norm import layer_norm

    n_cls = pred.exp.model.n_classes
    gates_dim = 4 * pred.exp.model.hidden_sz
    full = reqs[1]
    reqs = list(reqs)
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

    print(f"[serve] {REQUESTS} requests: flash launches {n_flash} "
          f"({n_flash / REQUESTS:g}/forward), layer_norm launches {n_ln} "
          f"({n_ln / REQUESTS:g}/forward)")
    check(n_flash == FLASH_PER_FORWARD * REQUESTS,
          f"flash kernel launched {n_flash} times, expected "
          f"{FLASH_PER_FORWARD * REQUESTS}")
    check(n_ln == LN_PER_FORWARD * REQUESTS,
          f"layer_norm kernel launched {n_ln} times, expected "
          f"{LN_PER_FORWARD * REQUESTS}")

    for batch, (probs, gates) in zip(reqs, outs):
        n = batch["txt"].shape[0]
        check(probs.shape == (n, n_cls), f"probs shape {probs.shape}")
        check(gates.shape == (n, gates_dim), f"gates shape {gates.shape}")
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
    print(f"[serve] kernels vs plain versions: probs max err {perr:.3g} "
          f"(tol {PROBS_TOL}), gates max err {gerr:.3g} (tol {GATES_TOL})")
    check(perr <= PROBS_TOL, f"probs differ from the plain path by {perr}")
    check(gerr <= GATES_TOL, f"gates differ from the plain path by {gerr}")

    # the same comparison must catch a kernel launched with a wrong mask
    faults = {}
    for fault, wrap in PLANTED_FAULTS.items():
        with wrapped_launch(fa, wrap):
            f_perr, f_gerr = errors([pred(batch, return_gates=True)
                                     for batch in reqs])
        faults[fault] = dict(probs_err=f_perr, gates_err=f_gerr)
        print(f"[serve] planted fault, {fault}: probs max err {f_perr:.3g}, "
              f"gates max err {f_gerr:.3g}")
    for fault, e in faults.items():
        check(e["probs_err"] > PROBS_TOL or e["gates_err"] > GATES_TOL,
              f"the comparison with the plain path misses a planted "
              f"fault ({fault})")

    # a ragged request's rows equal the same rows served in a full batch
    fp = pred(full)
    rerr = float(np.abs(fp[:5] - outs[1][0]).max())
    print(f"[serve] ragged request vs the same rows in a full batch: "
          f"max err {rerr:.3g}")
    check(rerr <= PROBS_TOL, f"ragged request differs by {rerr}")

    med = statistics.median(lat)
    print(f"[serve] per-request latency (host clock, numpy in -> numpy "
          f"out): median {med:.2f} ms over {REQUESTS}: "
          + ", ".join(f"{x:.2f}" for x in lat))
    if profile:
        profile_forward(torch, pred, reqs[0])
    return dict(latency_ms=lat, median_ms=med, flash_launches=n_flash,
                ln_launches=n_ln, probs_err=perr, gates_err=gerr,
                planted_faults=faults)


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


def summarise(name, source, replaces, rows, launches):
    """One kernel's entry: times are per launch, averaged over the served
    forward's mix of shapes (weights: each class's launches in the recorded
    forward)."""
    total = sum(r["per_forward"] for r in rows)
    avg = lambda key: sum(r[key] * r["per_forward"] for r in rows) / total
    by = collections.Counter()
    for r in rows:
        by[r["bound_by"]] += r["per_forward"]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=avg("ms"), plain_ms=avg("plain_ms"),
                bound_ms=avg("bound_ms"), bound_by=by.most_common(1)[0][0],
                library_ms=avg("library_ms"),
                launches_per_forward=launches // REQUESTS, shapes=rows)


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
    pred, reqs = phase_predictor(torch)
    # the warm-up request (cuBLAS/cuDNN set-up) records the launches
    flash_cls, ln_cls = launch_classes(pred, reqs[0])
    n_flash, n_ln = sum(flash_cls.values()), sum(ln_cls.values())
    print(f"[serve] recorded forward: {n_flash} flash launches in "
          f"{len(flash_cls)} shape classes, {n_ln} layer_norm launches in "
          f"{len(ln_cls)} (structure: {FLASH_PER_FORWARD}, "
          f"{LN_PER_FORWARD})")
    check(n_flash == FLASH_PER_FORWARD and n_ln == LN_PER_FORWARD,
          "the recorded forward's launches differ from the structure's")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_rows = phase_flash(torch, timer, flash_cls, gen)
    ln_rows = phase_layer_norm(torch, timer, ln_cls, gen)
    served = phase_serve(torch, np, pred, reqs, args.profile)

    kernels = [
        summarise("flash_fwd", "bpx_torch/csrc/flash_fwd.cu",
                  "bpx/ops/pallas_attention.py:145", flash_rows,
                  served["flash_launches"]),
        summarise("layer_norm_fwd", "bpx_torch/csrc/layer_norm.cu",
                  "bpx/ops/norm.py:53", ln_rows, served["ln_launches"]),
    ]
    print(f"[serve] median request {served['median_ms']:.2f} ms; "
          f"card: {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
