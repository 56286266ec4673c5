#!/usr/bin/env python3
"""Where the time of one LayerNorm backward launch goes, on a CUDA card.

    python3 scripts/torch_ln_bwd_phases.py

Builds the port's kernels with ``-DBPX_LN_TRACE``, under which thread 0 of
every block of ``bpx_torch/csrc/layer_norm_bwd.cu`` stamps the global timer
(ns) at its start, after its rows, after its partial rows, after the grid
barrier and at its end.  For the model's two LayerNorm classes (1600 and 4096
rows of 768, bf16) it prints, per phase, the median and the latest stamp
over the blocks, relative to the earliest start, each the median of 5
launches; and the card's name and power limit.  Without a card it exits
non-zero.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PHASES = ("rows", "partial rows", "grid barrier", "column sums")
LAUNCHES = 5


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_ln_bwd_phases: no CUDA device")
    from bpx_torch.ops import _cuda, norm
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    _cuda.CFLAGS = _cuda.CFLAGS + ["-DBPX_LN_TRACE"]
    lib = _cuda.library()
    lib.bpx_ln_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bpx_ln_trace_read.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for n, e in ((1600, 768), (4096, 768)):
        x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(bf)
        w = torch.rand(e, generator=gen, device="cuda") + 0.5
        dy = torch.randn(n, e, generator=gen, device="cuda").to(bf)
        _, mu, rstd = norm.layer_norm(x, w, torch.zeros_like(w), 1e-6,
                                      return_stats=True)
        grid = lib.bpx_layer_norm_bwd_workspace(n, e, 1, 1, 1) // (2 * e)
        runs = []
        for _ in range(LAUNCHES + 1):   # the first warms up
            norm.layer_norm_backward(x, w, mu, rstd, dy)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (5 * grid))()
            _cuda.check(lib.bpx_ln_trace_read(ctypes.addressof(buf), grid),
                        "trace read")
            stamps = [buf[5 * b:5 * b + 5] for b in range(grid)]
            t0 = min(s[0] for s in stamps)
            runs.append([(statistics.median(s[k] - t0 for s in stamps),
                          max(s[k] - t0 for s in stamps))
                         for k in range(1, 5)])
        runs = runs[1:]
        med = lambda k, i: statistics.median(r[k][i] for r in runs)
        print(f"({n}, {e}) bf16, {grid} blocks: " + "; ".join(
            f"{name} done at median {med(k, 0):.0f} ns, last {med(k, 1):.0f}"
            f" ns" for k, name in enumerate(PHASES)))


if __name__ == "__main__":
    main()
