"""Ranks of the port's multi-process CPU tests: gloo process groups on a
``file://`` store, spawned and joined under a deadline.

A rank imports only torch and the port (never jax), so it starts in a few
seconds.  :func:`spawn` starts ``world`` ranks of a worker function and
fails the test when one raises or the deadline passes (the ranks are
killed then, so a hung collective costs the deadline, not the suite's
limit).  The workers exchange their inputs and results with the test
through ``torch.save`` files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

#: seconds a spawned world may take
DEADLINE = 120.0


def _rank_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    from bpx_torch.parallel.mesh import initialize_distributed
    initialize_distributed("cpu", init_method=f"file://{store}", world=world,
                           rank_=rank, timeout_s=DEADLINE)
    import torch.distributed as dist
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn, tmp_path, *args, deadline: float = DEADLINE):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; raise if a
    rank fails or the ranks outlive ``deadline`` seconds."""
    import torch.multiprocessing as mp
    store = os.path.join(str(tmp_path), f"store_{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(world, store, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def build_step(spec, mesh=None):
    """(model, optimizer, train_step) of a spec: the model from its config
    and state dict, placed on ``mesh`` if given, SGD or the port's
    optimizer, the task's loss (the mesh's share), the seeded generator."""
    from bpx_torch.config import config_from_dict
    from bpx_torch.models import get_model
    from bpx_torch.parallel import sharding
    from bpx_torch.train import losses, optim
    from bpx_torch.train.steps import make_train_step

    exp = config_from_dict(spec["exp"])
    model = get_model(exp.model, device="cpu")
    model.load_state_dict(spec["state"])
    groups = ()
    if mesh is not None:
        model = sharding.shard_model(model, mesh, spec.get("use_fsdp"))
        groups = sharding.dp_groups(mesh)
    if spec["optimizer"] == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=spec["lr"])
    else:
        opt = optim.make_optimizer(model.parameters(), spec["lr"],
                                   spec["optimizer"])
    loss_fn = losses.make_loss_fn(spec["task"], spec["task_type"], True,
                                  spec["freqs"], 10, groups=groups)
    step = make_train_step(
        model, exp.model.model, loss_fn, opt, grad_accum=spec["accum"],
        with_grad_norm=True, accum_dtype=spec.get("accum_dtype"),
        generator=torch.Generator().manual_seed(spec.get("gen_seed", 0)),
        mesh=mesh)
    return model, opt, step


def run_steps(spec, mesh=None):
    """Take the spec's steps (one per super-batch); returns {"loss",
    "grad_norm" (lists), "state" (the whole model state, CPU)}."""
    from bpx_torch.parallel import sharding
    model, _, step = build_step(spec, mesh)
    out = {"loss": [], "grad_norm": []}
    for batch in spec["batches"]:
        m = step({k: torch.from_numpy(np.asarray(v)) for k, v in
                  batch.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["state"] = sharding.full_model_state(model)
    return out


def _run_on_mesh(rank, spec):
    """A spec's steps on its mesh (``spec["mesh"]`` the (data, fsdp,
    tensor) layout); every rank checks that its loss and gradient norm
    agree with rank 0's."""
    import torch.distributed as dist

    from bpx_torch.config import MeshConfig
    from bpx_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MeshConfig(*spec["mesh"]), "cpu")
    out = run_steps(spec, mesh)
    # every rank reports the same loss and the same whole weights
    mine = torch.tensor(out["loss"] + out["grad_norm"], dtype=torch.float64)
    ref = mine.clone()
    dist.broadcast(ref, 0)
    assert torch.equal(mine, ref), (rank, mine, ref)
    return out


def step_worker(rank, world, spec_path, out_path):
    """One rank of a sharded run of a spec; rank 0 saves the result."""
    out = _run_on_mesh(rank, torch.load(spec_path, weights_only=False))
    if rank == 0:
        torch.save(out, out_path)


def steps_worker(rank, world, specs_path, out_path):
    """One rank of the sharded runs of a dict of specs, each on its own
    mesh of the world's ranks, in turn (one spawn for several layouts or
    models); rank 0 saves the dict of results."""
    specs = torch.load(specs_path, weights_only=False)
    out = {key: _run_on_mesh(rank, spec) for key, spec in specs.items()}
    if rank == 0:
        torch.save(out, out_path)


def sharded_runs(tmp_path, specs):
    """Every spec of ``specs`` ({key: spec with its "mesh"}) on gloo ranks,
    one spawn per world size; {key: rank 0's result dict}."""
    by_world = {}
    for key, spec in specs.items():
        by_world.setdefault(int(np.prod(spec["mesh"])), {})[key] = spec
    out = {}
    for world, group in sorted(by_world.items()):
        specs_path = os.path.join(str(tmp_path), f"specs_{world}.pt")
        out_path = os.path.join(str(tmp_path), f"out_{world}.pt")
        torch.save(group, specs_path)
        spawn(world, steps_worker, tmp_path, specs_path, out_path,
              deadline=DEADLINE * len(group))
        out.update(torch.load(out_path, weights_only=False))
    return out


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------

def checkpoint_worker(rank, world, spec_path, savedir, out_path, mode):
    """``mode`` "save": one step of the spec on its mesh, then a
    checkpoint of the run; "restore": the checkpoint restored into the
    placed model and optimizer, their whole state saved by rank 0, then
    one more step, whose whole weights rank 0 saves too."""
    from bpx_torch.config import MeshConfig
    from bpx_torch.parallel import sharding
    from bpx_torch.parallel.mesh import make_mesh
    from bpx_torch.utils.checkpoint import CheckpointManager
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(MeshConfig(*spec["mesh"]), "cpu")
    model, opt, step = build_step(spec, mesh)
    batches = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
               for b in spec["batches"]]
    ckpt = CheckpointManager(savedir)
    if mode == "save":
        step(batches[0])
        ckpt.save(model, opt, 1, {"epoch": 1})
        return
    at, host = ckpt.restore(model, opt)
    restored = {"step": at, "host": host,
                "model": sharding.full_model_state(model),
                "optimizer": sharding.full_optimizer_state(model, opt)}
    step(batches[1])
    restored["after"] = sharding.full_model_state(model)
    if rank == 0:
        torch.save(restored, out_path)


def cli_worker(rank, world, argv, synthetic_len):
    """``cli_main(argv)`` on one rank, the synthetic task cut to
    ``synthetic_len`` training samples."""
    import dataclasses

    from bpx_torch.cli import train as cli
    to_config = cli.args_to_config

    def small(args):
        exp = to_config(args)
        return exp.replace(data=dataclasses.replace(
            exp.data, synthetic_len=synthetic_len))
    cli.args_to_config = small
    cli.cli_main(argv)
