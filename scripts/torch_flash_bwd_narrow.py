#!/usr/bin/env python3
"""The flash-attention kernels on a CUDA card, one build against another in
the same process: the backward (default) or the forward, at the narrow head
dims (25, 30) or any other class; or the LayerNorm backward.

    python3 scripts/torch_flash_bwd_narrow.py
    python3 scripts/torch_flash_bwd_narrow.py --tree parent=build/parent \\
        --variant LABEL=-DSOME_MACRO=1
    python3 scripts/torch_flash_bwd_narrow.py --kernel fwd
    python3 scripts/torch_flash_bwd_narrow.py --shape 8,6,512,128
    python3 scripts/torch_flash_bwd_narrow.py --kernel fwd \
        --shape 8,12,512,50 --shape 8,10,512,60 --tree parent=build/parent
    python3 scripts/torch_flash_bwd_narrow.py --kernel ln_bwd \\
        --shape 4096,1536 --tree parent=build/parent

Builds the port's kernels from ``bpx_torch/csrc`` of this checkout
("this"), from each ``--tree LABEL=DIR`` (a checkout's root, e.g. the parent
commit unpacked with ``git archive``) and with each ``--variant
LABEL=FLAGS`` (extra nvcc flags, comma-separated, on this checkout's
sources).  Prints ptxas' registers and spills of every flash kernel of the
chosen ``--kernel`` and the blocks per SM of the forward, dK/dV and dQ
kernels at every head dim of each build.  Then, at the iemocap class (8 x
12, 512 x 512 causal, D 25) and the cmu-mosei class (8 x 10, D 30), or each
``--shape B,H,T,D`` (mmimdb's D 128 class: 8,6,512,128), rate 0 and 0.1, on
strided views of fused projections as the model hands them over: every
build's kernel against the plain version (the backward within
``FLASH_GRAD_TOL`` of ``chip_smoke.py``, the forward within ``FLASH_TOL``
and ``LSE_TOL``) and bitwise on a rerun, then its time (CUDA events,
``chip_smoke.Timer``) in turns (A B ... B A, ``--rounds`` times) beside
SDPA's (``is_causal``; its backward alone for ``--kernel bwd``, the
backend the profiler saw) and the profiler's device time per kernel.  With ``--kernel ln_bwd`` the classes
are LayerNorm rows ``--shape N,E`` (default mmtrvpa's 4096 x 1536 and
1600 x 1536), bf16 x and dy: the backward within ``LN_TOL`` (dx) and
``LN_PARAM_GRAD_TOL`` (dw, db) of the plain version, bitwise on a rerun,
timed in turns beside ``F.layer_norm``'s backward.  A build that fails, or
disagrees with the plain version, is reported and dropped.  Writes
``chiprun_out/flash_<kernel>_ab.json``.  Without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CLASSES = ((8, 12, 512, 25), (8, 10, 512, 30))
LN_CLASSES = ((4096, 1536), (1600, 1536))
RATES = (0.0, 0.1)
SEED = 0x7F4A7C15


class OlderLibrary:
    """A library built from an older tree, by how far back its flash entry
    points' dropout arguments go (``level``): 2, the block placement
    without the group stride, ending at (b_off, h_off, H_g) where this
    tree's add the stride; 1, seed groups without the placement, ending at
    tk_p; 0, one dropout seed (on, seed, threshold, inv_keep, tk_p) where
    this tree's take (on, seeds, groups, threshold, inv_keep, tk_p).  The
    calls of this tree's wrappers, as far as the older form holds them
    (unplaced at level 0-1, one seed group at level 0, no stride at level
    2), are passed on in that form.  Everything else passes through."""

    def __init__(self, lib, level):
        import ctypes
        p, i, f, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong, ctypes.c_uint)
        dropout = ([i, ctypes.POINTER(u), i, u, f, i] + [i] * 3 * (level > 1)
                   if level else [i, u, u, f, i])
        lib.bpx_flash_fwd.argtypes = ([p] * 6 + [i] * 5 + [ll] * 12
                                      + [i, i] + dropout + [p])
        lib.bpx_flash_bwd.argtypes = ([p] * 11 + [i] * 5 + [ll] * 24
                                      + [i, i] + dropout + [p])
        self._lib = lib
        self._level = level

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def _older(self, args, at, heads):
        b_off, h_off, heads_g, stride = args[at + 6:at + 10]
        if stride:
            raise ValueError("an older build takes no group stride")
        if self._level == 2:
            return (*args[:at + 9], *args[at + 10:])
        if (b_off, h_off, heads_g) != (0, 0, heads):
            raise ValueError("an older build takes no block placement")
        args = (*args[:at + 6], *args[at + 10:])
        if self._level:
            return args
        on, seeds, groups = args[at:at + 3]
        if groups != 1:
            raise ValueError("a one-seed build takes one seed group")
        return (*args[:at], on, seeds[0] if on else 0, *args[at + 3:])

    def bpx_flash_fwd(self, *args):
        return self._lib.bpx_flash_fwd(*self._older(args, 25, args[7]))

    def bpx_flash_bwd(self, *args):
        return self._lib.bpx_flash_bwd(*self._older(args, 42, args[12]))


def build(label, src_dir, flags, kernel="bwd"):
    """Build and load one library; returns a dict with the library, ptxas'
    lines of the forward or backward kernels (and its wgmma warnings), the
    blocks per SM; None if the build fails.  A tree without seed groups
    (``kMaxSeedGroups`` in ``flash_common.cuh``), without the block
    placement (``heads_g``) or without the group stride (``group_stride``)
    loads as an :class:`OlderLibrary`."""
    from bpx_torch.ops import _cuda
    _cuda.SRC_DIR = Path(src_dir)
    try:
        lib = _cuda._lib = _cuda.load(flags)
    except RuntimeError as e:
        print(f"[{label}] build failed: {str(e)[:4000]}")
        return None
    common = (Path(src_dir) / "flash_common.cuh").read_text()
    if "group_stride" not in common:
        level = (2 if "heads_g" in common else
                 1 if "kMaxSeedGroups" in common else 0)
        lib = _cuda._lib = OlderLibrary(lib, level)
    lines, name, spill = [], "", ""
    for line in _cuda.build_log.splitlines():
        if "Compiling entry function" in line:
            name = cs.kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and (f"flash_{kernel}" in name
                                      or kernel == "ln_bwd"
                                      and "ln_bwd_" in name):
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
        elif "wgmma" in line.lower():
            lines.append(f"{name}: {line.strip()}")
    from bpx_torch.ops.flash_attention import KERNEL_HEAD_DIMS, blocks_per_sm
    occ = {}
    for d in KERNEL_HEAD_DIMS:
        try:
            occ[d] = blocks_per_sm(d)
        except RuntimeError:   # a tree older than this head dim
            occ[d] = "not built"
    print(f"[{label}] built from {src_dir} {' '.join(flags)}")
    for line in lines:
        print(f"[{label}] {line}")
    print(f"[{label}] blocks per SM: {occ}")
    return dict(label=label, lib=lib, ptxas=lines, blocks_per_sm=occ)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR: build DIR/bpx_torch/csrc too")
    ap.add_argument("--variant", action="append", default=[],
                    help="LABEL=FLAG,FLAG: this tree with extra nvcc flags")
    ap.add_argument("--kernel", choices=("bwd", "fwd", "ln_bwd"),
                    default="bwd",
                    help="time the flash backward (with delta), the flash "
                         "forward or the LayerNorm backward")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", action="append", default=[],
                    help="B,H,T,D: a causal T x T class to time instead of "
                         "the two model classes; N,E with --kernel ln_bwd "
                         "(repeatable)")
    args = ap.parse_args()
    classes = ([tuple(int(x) for x in spec.split(",")) for spec in args.shape]
               or (LN_CLASSES if args.kernel == "ln_bwd" else CLASSES))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_narrow: no CUDA device")
    from bpx_torch.ops import _cuda
    from bpx_torch.ops import flash_attention as fa
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    here = ROOT / "bpx_torch" / "csrc"
    kernel = args.kernel
    builds = [build("this", here, [], kernel)]
    for spec in args.tree:
        label, d = spec.split("=", 1)
        builds.append(build(label, ROOT / d / "bpx_torch" / "csrc", [],
                            kernel))
    for spec in args.variant:
        label, flags = spec.split("=", 1)
        builds.append(build(label, here, flags.split(","), kernel))
    builds = [b for b in builds if b is not None]

    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "ln_bwd":
        results = [ln_bwd_row(torch, timer, gen, builds, n, e, args.rounds)
                   for n, e in classes]
        write_results(kernel, card, builds, results)
        return
    results = []
    for B, H, Tq, D in classes:
        Tk = Tq
        for rate in RATES:
            q, k, v, _ = cs.attention_inputs(torch, gen, B, H, Tq, Tk, D,
                                             False)
            drop = (rate, SEED if rate else None)
            _cuda._lib = builds[0]["lib"]
            if kernel == "bwd":
                out, lse = fa.flash_attention(q, k, v, True, None, *drop,
                                              return_lse=True)
                dout = torch.randn(B, Tq, H, D, generator=gen,
                                   device="cuda").to(
                                       torch.bfloat16).transpose(1, 2)
                want = fa.flash_attention_backward_reference(
                    q, k, v, dout, lse,
                    fa.attention_delta_reference(dout, out), True, None,
                    *drop)
                call = (lambda q=q, k=k, v=v, dout=dout, lse=lse, out=out:
                        fa._launch_bwd(q, k, v, dout, lse, out, True, None,
                                       *drop))
                nbytes, flops, _ = cs.flash_bwd_work(torch, B, H, Tq, Tk,
                                                     D, True, None)
            else:
                want = fa.flash_attention_reference(q, k, v, True, None,
                                                    *drop)
                call = (lambda q=q, k=k, v=v:
                        fa._launch(q, k, v, True, None, *drop))
                visible, keys, _ = cs.attention_work(torch, B, H, Tq, Tk,
                                                     True, None)
                nbytes = (2 * (2 * B * H * Tq * D + 2 * keys * D)
                          + 4 * B * H * Tq)
                flops = 4.0 * D * visible
            b_ms, b_by = cs.bound_ms(nbytes, flops)
            # the library yardstick: SDPA on the same inputs, is_causal
            causal = dict(is_causal=True)
            if kernel == "bwd":
                sdpa = cs.sdpa_backward(torch, q, k, v, causal, rate, dout)
            else:
                sdpa = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, dropout_p=rate, scale=1.0, **causal))
            backend, _ = cs.sdpa_backend(torch, sdpa)
            times = {b["label"]: [] for b in builds}
            lib_times = []
            row = dict(shape=[B * H, Tq, Tk, D], rate=rate, bound_ms=b_ms,
                       bound_by=b_by, library_backend=backend, builds={})
            for b in list(builds):
                _cuda._lib = b["lib"]
                got = call()
                again = call()
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                if kernel == "bwd":
                    errs = [cs.grad_err(g, w) for g, w in zip(got, want)]
                    ok = max(errs) <= cs.FLASH_GRAD_TOL
                else:
                    errs = [cs.max_err(got[0], want[0]),
                            cs.max_err(got[1], want[1])]
                    ok = (torch.allclose(got[0].float(), want[0].float(),
                                         **cs.FLASH_TOL)
                          and torch.allclose(got[1], want[1], **cs.LSE_TOL))
                if not (ok and same):
                    print(f"[{b['label']}] WRONG at {(B, H, Tq, D, rate)}: "
                          f"errs {errs}, reruns equal {same}; dropped")
                    builds.remove(b)
                    del times[b["label"]]
                    continue
                split = cs.device_kernels(torch, call)
                row["builds"][b["label"]] = dict(
                    rel_err=max(errs),
                    split_ms={cs.short_name(n): t
                              for n, (_, t) in split.items()},
                    kernels_per_call={n: c for n, (c, _) in split.items()})
            order = builds + builds[::-1]
            for _ in range(args.rounds):
                for j, b in enumerate(order):
                    if j == len(builds):
                        lib_times.append(timer(sdpa))
                    _cuda._lib = b["lib"]
                    times[b["label"]].append(timer(call))
            row["library_ms"] = statistics.median(lib_times or
                                                  [timer(sdpa)])
            print(f"[sdpa] BH={B * H} {Tq}x{Tk} D={D} rate={rate}: "
                  f"{row['library_ms']:.4f} ms ({backend}, runs "
                  + ", ".join(f"{t:.4f}" for t in lib_times) + ")")
            for b in builds:
                r = row["builds"][b["label"]]
                r["ms"] = statistics.median(times[b["label"]])
                r["ms_all"] = times[b["label"]]
                print(f"[{b['label']}] BH={B * H} {Tq}x{Tk} D={D} rate="
                      f"{rate}: {r['ms']:.4f} ms (runs "
                      + ", ".join(f"{t:.4f}" for t in r["ms_all"])
                      + f"), bound {b_ms:.4f} ms ({b_by}), "
                      f"{b_ms / r['ms']:.1%} of it, "
                      f"{r['ms'] / row['library_ms']:.2f}x sdpa; err "
                      f"{r['rel_err']:.3g}, reruns bitwise equal; profiler: "
                      + ", ".join(f"{n} {t:.4f} ms"
                                  for n, t in r["split_ms"].items()))
            results.append(row)
    write_results(kernel, card, builds, results)


def use_build(b):
    """Make build ``b`` the wrappers' library.  The LayerNorm backward's
    workspace size depends on the build's path, so its cache is cleared."""
    from bpx_torch.ops import _cuda, norm
    _cuda._lib = b["lib"]
    norm._WORKSPACE_NUMEL.clear()


def ln_bwd_row(torch, timer, gen, builds, n, e, rounds):
    """The LayerNorm backward of every build at (n, e), bf16 x and dy:
    checked against the plain version and on a rerun, then timed in turns
    beside F.layer_norm's backward.  A build that disagrees is dropped."""
    import torch.nn.functional as F
    from bpx_torch.ops import norm
    x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(
        torch.bfloat16)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    dy = torch.randn(n, e, generator=gen, device="cuda").to(torch.bfloat16)
    use_build(builds[0])
    _, mu, rstd = norm.layer_norm(x, w, torch.zeros_like(w), 1e-6,
                                  return_stats=True)
    want = norm.layer_norm_backward_reference(x, w, mu, rstd, dy)
    call = lambda: norm._launch_bwd(x, w, mu, rstd, dy)
    nbytes = n * e * 3 * 2 + 3 * e * 4 + 2 * n * 4
    b_ms, b_by = cs.bound_ms(nbytes, 12.0 * n * e)
    xl = x.detach().requires_grad_(True)
    wl = w.to(torch.bfloat16).requires_grad_(True)
    bl = torch.zeros_like(wl).requires_grad_(True)
    y = F.layer_norm(xl, (e,), wl, bl, 1e-6)
    t_lib = timer(lambda: torch.autograd.grad(y, (xl, wl, bl), dy,
                                              retain_graph=True))
    row = dict(shape=[n, e], bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
               builds={})
    for b in list(builds):
        use_build(b)
        got, again = call(), call()
        torch.cuda.synchronize()
        err = cs.max_err(got[0], want[0])
        perr = max(cs.grad_err(g, r) for g, r in zip(got[1:], want[1:]))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        ok = (torch.allclose(got[0].float(), want[0].float(), **cs.LN_TOL)
              and perr <= cs.LN_PARAM_GRAD_TOL)
        if not (ok and same):
            print(f"[{b['label']}] WRONG at {(n, e)}: dx err {err}, dw/db "
                  f"{perr}, reruns equal {same}; dropped")
            builds.remove(b)
            continue
        split = cs.device_kernels(torch, call)
        # fp32 workspace of the cross-block dw/db sums: 2 E per partial row
        work = b["lib"].bpx_layer_norm_bwd_workspace(n, e, 1, 1, 1)
        row["builds"][b["label"]] = dict(
            max_abs_err=err, param_rel_err=perr, ms_all=[],
            workspace_mib=work * 4 / 2 ** 20, partial_rows=work // (2 * e),
            split_ms={cs.short_name(k): t for k, (_, t) in split.items()})
    for _ in range(rounds):
        for b in builds + builds[::-1]:
            use_build(b)
            row["builds"][b["label"]]["ms_all"].append(timer(call))
    for b in builds:
        r = row["builds"][b["label"]]
        r["ms"] = statistics.median(r["ms_all"])
        print(f"[{b['label']}] layer_norm_bwd ({n}, {e}) bf16: "
              f"{r['ms']:.4f} ms (runs "
              + ", ".join(f"{t:.4f}" for t in r["ms_all"])
              + f"), bound {b_ms:.4f} ms ({b_by}), {b_ms / r['ms']:.1%} of "
              f"it, F.layer_norm bwd {t_lib:.4f} ms ("
              f"{r['ms'] / t_lib:.2f}x); dx err {r['max_abs_err']:.3g}, "
              f"dw/db {r['param_rel_err']:.3g}, reruns bitwise equal; "
              f"{r['partial_rows']} partial rows ({r['workspace_mib']:.1f} "
              f"MiB of workspace); profiler: " + ", ".join(f"{k} {t:.4f} ms"
                                        for k, t in r["split_ms"].items()))
    return row


def write_results(kernel, card, builds, results):
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"flash_{kernel}_ab.json").write_text(json.dumps(dict(
        card=card.strip(),
        builds=[{k: v for k, v in b.items() if k != "lib"} for b in builds],
        rows=results), indent=1))
    print(card.strip())


if __name__ == "__main__":
    main()
