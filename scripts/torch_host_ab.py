#!/usr/bin/env python3
"""Served-request and train-step times of two source trees of the port, in
turns on one card: what a change to the host path (dispatch, wrappers)
costs end to end.

    python3 scripts/torch_host_ab.py --tree parent=build/parent

Each round runs in a process of its own with ``bpx_torch`` imported from
its tree, in three pairs: (base, this tree), (this tree, base), (base,
this tree); ``--tree`` names the base.  A round builds moviescope's and
iemocap's ``Predictor`` at full width (batch 8, bf16, seeded weights),
serves two warm-up requests and then 12 numpy-seeded requests, timing
each on the host clock (numpy in, numpy out); for moviescope it also runs
one warm-up train step and 3 timed steps at micro-batch 8 x A = 2
(synchronised), without recompute in either tree.  First
it times one call of the flash and LayerNorm wrappers at (1, 1, 64, 64,
64) and 64 x 768 (host clock over 2000 calls, synchronised after them):
under inference_mode, and forward and backward with grad.  The
requests and super-batches are ``chip_smoke.py``'s, from this tree.  Prints
one JSON line per round, then per tree and preset the median over its
rounds, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib.util, json, statistics, sys, time
tree, root = sys.argv[1:3]
sys.path.insert(0, tree)
import numpy as np
import torch
spec = importlib.util.spec_from_file_location("smoke", f"{root}/chip_smoke.py")
smoke = sys.modules["smoke"] = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from bpx_torch.config import get_preset
from bpx_torch.models import get_model
from bpx_torch.serve import Predictor
from bpx_torch.train.losses import make_loss_fn
from bpx_torch.train.optim import make_optimizer
from bpx_torch.train.steps import make_train_step
import bpx_torch
assert bpx_torch.__file__.startswith(tree), bpx_torch.__file__
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
# host time of one wrapper call at a shape whose kernel takes a few us
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.norm import layer_norm
gen = torch.Generator(device="cuda").manual_seed(1)
q = torch.randn(1, 1, 64, 64, device="cuda", generator=gen).bfloat16()
x = torch.randn(64, 768, device="cuda", generator=gen).bfloat16()
w = torch.randn(768, device="cuda", generator=gen)
qg, xg, wg = (t.clone().requires_grad_() for t in (q, x, w))
def per_call(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6
with torch.inference_mode():
    out["flash us"] = per_call(lambda: flash_attention(q, q, q, True))
    out["ln us"] = per_call(lambda: layer_norm(x, w, w, 1e-6, torch.bfloat16))
out["flash fwd+bwd us"] = per_call(
    lambda: flash_attention(qg, qg, qg, True).sum().backward())
out["ln fwd+bwd us"] = per_call(
    lambda: layer_norm(xg, wg, wg, 1e-6, torch.bfloat16).sum().backward())
for preset in ("moviescope", "iemocap"):
    exp = get_preset(preset)
    exp = exp.replace(model=exp.model.replace(remat=False))
    pred = Predictor(exp, batch_size=8, device="cuda", seed=0)
    reqs = [smoke.synthetic_batch(exp, 8, 100 + i)
            for i in range(14)]
    lat = []
    for r in reqs:
        t = time.perf_counter()
        pred(r)
        lat.append((time.perf_counter() - t) * 1e3)
    out[f"{preset} served ms"] = statistics.median(lat[2:])
    del pred
    torch.cuda.empty_cache()
    if preset != "moviescope":
        continue
    m = exp.model
    model = get_model(m, device="cuda", seed=0).train()
    freqs = np.random.RandomState(7).randint(30, 400, size=m.n_classes)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), 1000, device="cuda")
    step = make_train_step(model, m.model, loss_fn,
                           make_optimizer(model.parameters(), 1e-3),
                           grad_accum=2,
                           generator=torch.Generator().manual_seed(0))
    times = []
    for i in range(4):
        batch = smoke.train_batch(torch, np, exp, 300 + i, freqs / 1000)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)["loss"].item()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out[f"{preset} step ms"] = statistics.median(times[1:])
    del model, step
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True,
                    help="LABEL=PATH of the base tree (e.g. a git archive "
                         "of the parent commit)")
    args = ap.parse_args()
    label, path = args.tree.split("=", 1)
    base = str(Path(path).resolve())
    pair = [(label, base), ("this", str(ROOT))]
    trees = pair + pair[::-1] + pair
    got = {}
    for name, tree in trees:
        res = subprocess.run(
            [sys.executable, "-c", CHILD, tree, str(ROOT)],
            capture_output=True, text=True, timeout=1800)
        if res.returncode != 0:
            sys.exit(f"round on {name} failed:\n{res.stderr[-4000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **row}))
        for key, ms in row.items():
            got.setdefault((name, key), []).append(ms)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    for (name, key), values in sorted(got.items()):
        print(f"{name}: {key} median {statistics.median(values):.2f} over "
              f"rounds " + ", ".join(f"{v:.2f}" for v in values))
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
