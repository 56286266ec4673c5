#!/usr/bin/env python3
"""The sharded trainer on several cards of one host, one process a card.

    torchrun --standalone --nproc_per_node 4 scripts/torch_mesh_cards.py
    torchrun --standalone --nproc_per_node 1 scripts/torch_mesh_cards.py

Each rank joins an NCCL process group from torchrun's environment, with a
deadline on every collective (``--deadline`` seconds: a hung collective
fails the run instead of holding it), and takes card ``LOCAL_RANK``.
Rank 0 prints every card's name and power limit and builds the kernels
while the other ranks wait; they then load the built library.

Then, for each case below, at moviescope's full width and depth (bf16,
every dropout, Adam), every rank builds the model from seed 0 and the
same batches and dropout seeds:

* **step 1 against one process**: rank 0 first takes the one-process step
  on its own card at the global batch of 8 rows x A = 2, as
  ``chip_smoke.py``'s phase 21 does, and the same step split as the
  mesh's (data, fsdp) ranks split its rows (``split_step``: one card, no
  collective); then every rank takes the sharded step on the case's
  ``(data, fsdp, tensor)`` mesh over its rows.  Read: the relative error
  of the loss and of each parameter group's whole gradient
  (``sharding.full_gradients``) against both, and every rank's launch
  counters, which must be the one-process step's exactly.  A rank sums
  over fewer rows than one process (cuBLAS's and cuDNN's choices for the
  smaller batch, each weight gradient's sum in another order, and in bf16
  each partial sum rounded before the collective adds it), so against the
  one-process step the bf16 step through the kernels is held to the
  path's micro-step limits (``loss_tol``, ``grad_tol``), as phase 21
  holds it first; a planted fault at data=4, the ranks' dropout hashing
  their rows from 0 (``unplaced_rows``), must cross them.  Against the
  split step, which does the ranks' arithmetic without the mesh, the
  loss is held to ``MESH_TOL``, and so is each gradient group where no
  tensor split adds partial sums; the same step in fp32 on the einsum
  attention (``fp32_experiment``: TF32 off, the convolution PyTorch's
  own, not cuDNN's) is held there likewise;
* **time**: 5 steps at 8 rows a card (a global micro-batch of 8 x data x
  fsdp rows, A = 2) after one warm-up step; the median on CUDA events
  (rank 0's stream) and on the host clock (synchronised), beside rank 0's
  one-process step at 8 rows; each card's peak memory; and the share of
  rank 0's device time in NCCL kernels (``torch.profiler``, one step).

Cases (at 4 ranks; at another world size each runs on the world-size
mesh of ``fit``, one card running every layout at world size 1):
mmtrvapt at data=4, fsdp=4 and data=2 x tensor=2; ``group_encoders`` at
data=2 x tensor=2 and fsdp=4; mmtrvpa at data=2 x tensor=2.

Last, the README's four-card command (``python -m bpx_torch.cli.train``
at moviescope's widths, ``--mesh_data 2 --mesh_tensor 2``) on a
moviescope dataset written from a seed in place of ``/data``
(``chip_smoke.write_moviescope``: 32 training records, two steps an
epoch): one epoch, then resumed for a second.  (The ``synthetic`` task
sizes its BERT to 16-wide heads, which the flash kernels do not take.)

Rank 0 writes ``chiprun_out/mesh_cards.json`` and prints one JSON line of
the results; the exit code is non-zero if any check failed.  Without a
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (label, path, (data, fsdp, tensor)) at four ranks
CASES = (
    ("mmtrvapt data4", cs.MOVIESCOPE, (4, 1, 1)),
    ("mmtrvapt fsdp4", cs.MOVIESCOPE, (1, 4, 1)),
    ("mmtrvapt data2 x tensor2", cs.MOVIESCOPE, (2, 1, 2)),
    ("group_encoders data2 x tensor2", cs.MOVIESCOPE_GROUPED, (2, 1, 2)),
    ("group_encoders fsdp4", cs.MOVIESCOPE_GROUPED, (1, 4, 1)),
    ("mmtrvpa data2 x tensor2", cs.MMTRVPA, (2, 1, 2)),
)
TIMED_STEPS = 5
ROWS_PER_CARD = cs.BATCH
#: the README's command (README.md); --data_path and --savedir are added
CLI_ARGV = ["--model", "mmtrvapt", "--task", "moviescope", "--hidden_sz",
            "768", "--num_heads", "8", "--layers", "4", "--orig_d_v", "4096",
            "--orig_d_a", "96", "--batch_sz", "8",
            "--gradient_accumulation_steps", "2", "--attention_impl",
            "pallas", "--mesh_data", "2", "--mesh_fsdp", "1",
            "--mesh_tensor", "2", "--from_seed", "1", "--to_seed", "1"]


def check(cond: bool, msg: str, failures: list) -> None:
    """Record a failed check (printed at once) and go on."""
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        failures.append(msg)


def fit(layout, world: int):
    """The case's layout at ``world`` ranks: the layout itself where it
    holds ``world`` ranks; at one rank (1, 1, 1), run as DDP or FSDP2 as
    the layout's fsdp says; None where neither fits."""
    data, fsdp, tensor = layout
    if data * fsdp * tensor == world:
        return layout
    return (1, 1, 1) if world == 1 else None


def say(rank: int, *args) -> None:
    if rank == 0:
        print(*args, flush=True)


def cards_text() -> str:
    """Every card's name and power limit, a line each, as nvidia-smi gives
    them (its error output where it gives none)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip() or f"nvidia-smi: {res.stderr.strip()}"


def model_and_step(torch, exp, freqs, mesh, use_fsdp, seed=0):
    """The path's model from ``seed``, placed on ``mesh`` (or not), with
    Adam, its loss and the train step (dropout generator seeded 0)."""
    from bpx_torch.models import get_model
    from bpx_torch.parallel import sharding
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    m = exp.model
    model = get_model(m, device="cuda", seed=seed).train()
    if mesh is not None:
        model = sharding.shard_model(model, mesh, use_fsdp=use_fsdp)
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), 1000, device="cuda",
                           groups=sharding.dp_groups(mesh)
                           if mesh is not None else ())
    opt = make_optimizer(model.parameters(), cs.LR)
    step = make_train_step(model, m.model, loss_fn, opt,
                           grad_accum=cs.TRAIN_A,
                           generator=torch.Generator().manual_seed(0),
                           mesh=mesh)
    return model, opt, step


def global_batch(torch, np, exp, freqs, rows: int, seed: int):
    """An (A, rows, ...) super-batch on the card, the same on every rank
    (numpy-seeded as ``chip_smoke.train_batch``)."""
    b = cs.synthetic_batch(exp, cs.TRAIN_A * rows, seed)
    rng = np.random.RandomState(seed + 1)
    b["target"] = (rng.rand(cs.TRAIN_A * rows, len(freqs))
                   < freqs / 1000).astype(np.float32)
    return {k: torch.from_numpy(v.reshape(cs.TRAIN_A, rows, *v.shape[1:]))
            .to("cuda") for k, v in b.items()}


def timed_steps(torch, step, batch, n: int):
    """One warm-up step, then ``n`` steps: (device ms by CUDA events on
    this rank's stream, host ms synchronised) per step."""
    step(batch)
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        step(batch)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        dev.append(start.elapsed_time(end))
    return dev, host


def nccl_share(torch, step, batch, profile: bool):
    """One step on every rank; on the rank that ``profile``s, the share of
    its device time in NCCL kernels, and both totals (ms)."""
    if not profile:
        step(batch)
        torch.cuda.synchronize()
        return None
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        step(batch)
        torch.cuda.synchronize()
    total = nccl = 0.0
    for e in prof.events():
        if e.device_type.name == "CUDA":
            total += e.device_time / 1e3
            if "nccl" in e.name.lower():
                nccl += e.device_time / 1e3
    return dict(share=nccl / total if total else float("nan"),
                nccl_ms=nccl, device_ms=total)


def fp32_experiment(exp):
    """The experiment in fp32 on the einsum attention (the flash kernels
    take bf16 only): the same model and weights, without bf16 rounding."""
    return exp.replace(model=exp.model.replace(compute_dtype="float32",
                                               attention_impl="xla"))


def unplaced_rows(place_batch):
    """``sharding.place_batch`` that hides the rows' offset from the step:
    every rank hashes its rows' dropout as rows 0.., the fault the block
    placement exists for."""
    def planted(batch, mesh, *args, **kw):
        return place_batch(batch, mesh, *args, **kw)[0], None
    return planted


_MESHES = {}


def mesh_of(layout):
    """The ``(data, fsdp, tensor)`` mesh of ``layout``, made once (each
    mesh starts its own process groups)."""
    from bpx_torch.config import MeshConfig
    from bpx_torch.parallel.mesh import make_mesh
    if layout not in _MESHES:
        _MESHES[layout] = make_mesh(MeshConfig(*layout), "cuda")
    return _MESHES[layout]


def split_step(torch, exp, freqs, batch, parts: int):
    """(loss, whole gradients) of step 1 from seed 0 on this card and with
    no collective, taken as ``parts`` ranks of a (data, fsdp) split take
    it: each micro-batch's rows in ``parts`` blocks, each block's forward
    with its rows placed and its loss's share (1 / ``parts``, as DDP and
    FSDP2 average) backward, the gradients summed, then divided by A.
    What a rank computes over fewer rows (cuBLAS's and cuDNN's choices for
    the smaller batch, the order of each weight gradient's sum), with
    nothing of the mesh."""
    from bpx_torch.inputs import model_inputs
    from bpx_torch.models import get_model
    from bpx_torch.ops.dropout import SeedStream, draw_base_seed
    from bpx_torch.train.losses import make_loss_fn
    m = exp.model
    loss_fn = make_loss_fn(exp.data.task, exp.data.task_type, True,
                           freqs.tolist(), 1000, device="cuda")
    model = get_model(m, device="cuda", seed=0).train()
    gen = torch.Generator().manual_seed(0)
    n = cs.BATCH // parts
    loss = 0.0
    for i in range(cs.TRAIN_A):
        base = draw_base_seed(gen)
        for r in range(parts):
            micro = {k: v[i, r * n:(r + 1) * n] for k, v in batch.items()}
            part = loss_fn(model(*model_inputs(m.model, micro),
                                 dropout_seed=SeedStream(base, (r * n,
                                                                cs.BATCH))),
                           micro["target"]) * (1.0 / parts)
            part.backward()
            loss += part.item() / cs.TRAIN_A
    grads = {k: g * (1.0 / cs.TRAIN_A)
             for k, g in cs.whole_grads(torch, model).items()}
    del model
    torch.cuda.empty_cache()
    return loss, grads


def errors_against(torch, loss, grads, ref):
    """The loss's and each gradient group's relative error against
    ``ref`` = (loss, gradients), and the worst group."""
    errs = cs.relative_errors(torch, grads, ref[1])
    worst = max(errs, key=errs.get)
    return dict(loss_err=abs(loss - ref[0]) / abs(ref[0]),
                grad_err=errs[worst], worst_group=worst)


def step_one(torch, np, dist, rank, world, tag, exp, freqs, layout,
             use_fsdp, limits, exact, failures, want=None, plant=False):
    """Step 1 of ``exp``'s model from seed 0 on rank 0's card in one
    process (the trainer's step), and there again as the mesh's (data,
    fsdp) ranks split its rows (:func:`split_step`); then on the mesh of
    ``layout`` over every rank from the same weights, batch and dropout
    seeds.  The sharded step's relative errors against the one-process
    step are held to ``limits`` = (loss, gradient limit) (None: reported),
    or with ``plant`` (the ranks' dropout ignoring their rows' offset)
    must cross them; against the split step, to ``MESH_TOL``: the loss,
    and with ``exact`` "all" each gradient group too ("loss", None:
    reported).  Every rank's launch counters are held to the one-process
    step's (and to ``want``).  Returns the readings (rank 0) and the
    sharded step, to time."""
    from bpx_torch.parallel import sharding
    batch = global_batch(torch, np, exp, freqs, cs.BATCH, 300)
    parts = layout[0] * layout[1]
    ref = split = None
    if rank == 0:
        model, opt, step = model_and_step(torch, exp, freqs, None, False)
        cs.zero_launches()
        loss = step(batch)["loss"].item()
        ref = (loss, cs.whole_grads(torch, model), cs.read_launches())
        if want is not None:
            check(ref[2] == want, f"{tag}: one-process launches {ref[2]}, "
                                  f"expected {want}", failures)
        del model, opt, step
        torch.cuda.empty_cache()
        split = split_step(torch, exp, freqs, batch, parts) if parts > 1 \
            else ref[:2]
    dist.barrier()
    mesh = mesh_of(tuple(layout))
    model, opt, step = model_and_step(torch, exp, freqs, mesh, use_fsdp)
    place_batch = sharding.place_batch
    if plant:
        sharding.place_batch = unplaced_rows(place_batch)
    try:
        cs.zero_launches()
        loss = step(batch)["loss"].item()
    finally:
        sharding.place_batch = place_batch
    launches = [None] * world
    dist.all_gather_object(launches, cs.read_launches())
    grads = cs.whole_grads(torch, model)
    out = {}
    if rank == 0:
        one = errors_against(torch, loss, grads, ref)
        rows = errors_against(torch, loss, grads, split)
        out = dict(loss=loss, launches=launches[0], split=rows,
                   split_vs_one=errors_against(torch, *split, ref), **one)
        text = lambda e: (f"loss {e['loss_err']:.3g}, worst gradient group "
                          f"{e['worst_group']} {e['grad_err']:.3g}")
        print(f"[cards] {tag} on {world} rank(s), mesh {tuple(layout)} "
              f"({'FSDP2' if use_fsdp else 'DDP'}), loss {loss:.6f}; "
              f"relative errors: against the one-process step {text(one)} "
              f"(limits {limits}{'; a planted fault' if plant else ''}); "
              f"against it split as the ranks split the rows {text(rows)} "
              f"(limit {cs.MESH_TOL}: {exact or 'reported'}); the split "
              f"step against the one-process step "
              f"{text(out['split_vs_one'])}; launches per rank {launches}",
              flush=True)
        if limits is not None:
            sound = (math.isfinite(loss) and one["loss_err"] <= limits[0]
                     and one["grad_err"] <= limits[1])
            check(sound != plant,
                  f"{tag}: step 1 {'within' if plant else 'outside'} the "
                  f"limits {limits} against the one-process step "
                  f"({text(one)})", failures)
        if exact:
            check(rows["loss_err"] <= cs.MESH_TOL and (
                exact == "loss" or rows["grad_err"] <= cs.MESH_TOL),
                f"{tag}: step 1 against the split step ({text(rows)}) "
                f"outside {cs.MESH_TOL}", failures)
        check(all(g == ref[2] for g in launches),
              f"{tag}: launches per rank {launches}, the one-process "
              f"step's {ref[2]}", failures)
    del grads
    return out, (model, opt, step)


def run_case(torch, np, dist, rank, world, label, path, layout, failures,
             one_card):
    """Step 1 against one process in bf16 through the kernels, the same
    in fp32 on the einsum attention (cuDNN off: its convolution algorithm
    follows the batch, and its weight gradient's order moves between two
    runs of one process), at data=4 a planted placement fault, then the
    timing beside one card's (``one_card``: rank 0's readings by path,
    filled on first use)."""
    exp = cs.experiment(path)
    rng = np.random.RandomState(7)
    freqs = rng.randint(30, 400, size=exp.model.n_classes)
    want = dict(flash=path.flash * cs.TRAIN_A,
                dropout=path.dropout * cs.TRAIN_A,
                flash_bwd=path.flash * cs.TRAIN_A,
                ln=path.ln_train * cs.TRAIN_A,
                ln_bwd=path.ln_train * cs.TRAIN_A)
    use_fsdp = layout[1] > 1 or (world == 1 and label.endswith("fsdp4"))
    out = dict(case=label, layout=list(layout), world=world)
    # gradients are held exactly where no tensor split adds partial sums
    exact = "all" if layout[2] == 1 else "loss"
    with torch.backends.cudnn.flags(enabled=False):
        out["fp32"], _ = step_one(torch, np, dist, rank, world,
                                  f"{label} fp32", fp32_experiment(exp),
                                  freqs, layout, use_fsdp, None, exact,
                                  failures)
    limits = (path.loss_tol, path.grad_tol)
    if label == "mmtrvapt data4":
        out["planted"], _ = step_one(
            torch, np, dist, rank, world, f"{label} bf16, dropout unplaced",
            exp, freqs, layout, use_fsdp, limits, None, failures,
            plant=True)
    bf16, (model, opt, step) = step_one(
        torch, np, dist, rank, world, f"{label} bf16", exp, freqs, layout,
        use_fsdp, limits, "all" if layout[2] == 1 else None, failures, want)
    out.update(bf16)
    # the time at 8 rows a card, beside one card's
    data, fsdp, _ = layout
    big = global_batch(torch, np, exp, freqs, ROWS_PER_CARD * data * fsdp,
                       400)
    torch.cuda.reset_peak_memory_stats()
    dev, host = timed_steps(torch, step, big, TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    peaks = [None] * world
    dist.all_gather_object(peaks, peak)
    share = nccl_share(torch, step, big, rank == 0)
    del model, opt, step
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        if path.name not in one_card:
            model, opt, step = model_and_step(torch, exp, freqs, None, False)
            one = global_batch(torch, np, exp, freqs, ROWS_PER_CARD, 400)
            torch.cuda.reset_peak_memory_stats()
            d1, h1 = timed_steps(torch, step, one, TIMED_STEPS)
            one_card[path.name] = dict(
                one_card_device_ms=d1, one_card_host_ms=h1,
                one_card_device_median_ms=statistics.median(d1),
                one_card_host_median_ms=statistics.median(h1),
                one_card_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            del model, opt, step
            torch.cuda.empty_cache()
        out.update(one_card[path.name])
        out.update(device_ms=dev, host_ms=host,
                   device_median_ms=statistics.median(dev),
                   host_median_ms=statistics.median(host),
                   peak_gib=peaks, nccl=share, rows_per_card=ROWS_PER_CARD)
        print(f"[cards] {label}: {TIMED_STEPS} steps at {ROWS_PER_CARD} "
              f"rows a card x A={cs.TRAIN_A}: median "
              f"{out['device_median_ms']:.1f} ms (CUDA events) / "
              f"{out['host_median_ms']:.1f} ms (host clock); one card at "
              f"{ROWS_PER_CARD} rows {out['one_card_device_median_ms']:.1f}"
              f" / {out['one_card_host_median_ms']:.1f} ms; peak per card "
              + ", ".join(f"{p:.2f}" for p in peaks) + f" GiB (one card "
              f"{out['one_card_peak_gib']:.2f}); NCCL {share['share']:.1%} "
              f"of rank 0's device time ({share['nccl_ms']:.1f} of "
              f"{share['device_ms']:.1f} ms)", flush=True)
    dist.barrier()
    return out


def run_cli(np, dist, rank, world, failures):
    """The README's command on the world's ranks, on a moviescope dataset
    written from a seed (two steps an epoch): one epoch, then resumed to
    two."""
    from bpx_torch.cli.train import cli_main
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # every rank reads and writes under rank 0's directory
        shared = [tmp]
        dist.broadcast_object_list(shared, 0)
        root = Path(shared[0])
        if rank == 0:
            cs.write_moviescope(np, root / "data")
        dist.barrier()
        argv = CLI_ARGV + ["--data_path", str(root / "data"), "--savedir",
                           str(root / "runs"), "--name", "cards"]
        for epochs in (1, 2):
            t = time.time()
            cli_main(argv + ["--max_epochs", str(epochs)])
            out[f"epochs_{epochs}_s"] = time.time() - t
            dist.barrier()
        if rank == 0:
            run = root / "runs" / "cards_Seed1_run"
            log = (run / "logfile.log").read_text()
            host = json.loads((run / "host_state.json").read_text())
            out.update(resumed="resumed from epoch 1" in log,
                       epoch=host.get("epoch"),
                       mesh_line="mesh: {'data': 2, 'fsdp': 1, 'tensor': 2}"
                       in log, preds=(run / "preds_raw.npy").exists())
            print(f"[cards] the README's command (a moviescope dataset of "
                  f"{cs.LOOP_SPLITS} records, {cs.LOOP_STEPS} steps an "
                  f"epoch): {out}", flush=True)
            check(out["resumed"] and out["epoch"] == 2 and out["preds"]
                  and (out["mesh_line"] or world == 1),
                  f"the README's command did not train and resume: {out}",
                  failures)
        dist.barrier()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deadline", type=float, default=600.0,
                    help="seconds any collective may take")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        sys.exit("torch_mesh_cards: no CUDA device")
    # fp32 products in fp32, as chip_smoke.py runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bpx_torch.ops import _cuda
    from bpx_torch.parallel.mesh import initialize_distributed, local_rank
    t0 = time.time()
    world = initialize_distributed("cuda", init_method="env://",
                                   timeout_s=args.deadline)
    rank = dist.get_rank()
    say(rank, f"[cards] world {world}, NCCL {torch.cuda.nccl.version()}, "
              f"torch {torch.__version__}; cards:\n{cards_text()}")
    failures: list = []
    results = dict(world=world, cards=cards_text().splitlines(),
                   cases=[], cli=None)
    try:
        if rank == 0:
            t = time.time()
            _cuda.library()
            print(f"[cards] kernels built in {time.time() - t:.1f} s",
                  flush=True)
        dist.barrier()
        _cuda.library()
        print(f"[cards] rank {rank} on card {local_rank()} "
              f"({torch.cuda.get_device_name()}) loaded the kernels",
              flush=True)
        dist.barrier()
        one_card = {}
        for label, path, layout in CASES:
            placed = fit(layout, world)
            if placed is None:
                say(rank, f"[cards] {label}: no layout at {world} ranks")
                continue
            t = time.time()
            entry = run_case(torch, np, dist, rank, world, label, path,
                             placed, failures, one_card)
            entry["seconds"] = time.time() - t
            results["cases"].append(entry)
        if world in (1, 4):
            if world == 1:
                CLI_ARGV[CLI_ARGV.index("--mesh_data") + 1] = "1"
                CLI_ARGV[CLI_ARGV.index("--mesh_tensor") + 1] = "1"
            results["cli"] = run_cli(np, dist, rank, world, failures)
    except Exception as e:   # a failed phase fails the run, after the report
        failures.append(f"rank {rank}: {type(e).__name__}: {e}")
        print(f"FAIL: rank {rank}: {type(e).__name__}: {e}", flush=True)
        import traceback
        traceback.print_exc()
    finally:
        results["failures"] = failures
        results["seconds"] = time.time() - t0
        if rank == 0:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            (out / "mesh_cards.json").write_text(
                json.dumps(results, indent=1, default=str))
            print(json.dumps({k: v for k, v in results.items()
                              if k != "cases"}, default=str))
            print(json.dumps({"cases": [
                {k: c.get(k) for k in (
                    "case", "layout", "loss_err", "grad_err", "worst_group",
                    "split", "split_vs_one", "fp32", "planted",
                    "device_median_ms", "host_median_ms",
                    "one_card_device_median_ms", "one_card_host_median_ms",
                    "peak_gib", "one_card_peak_gib", "nccl")}
                for c in results["cases"]]}, default=str))
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
