"""Checkpoint / resume in the port's own format (counterpart:
``bpx/utils/checkpoint.py``, which writes orbax checkpoints; orbax needs
JAX, which the port does not import).

A checkpoint directory holds ``torch.save`` files of CPU copies:
``model.pt`` (the model's state dict and the optimizer step) and
``optimizer.pt`` (the optimizer's state dict), so serving reads the weights
alone.  The run directory keeps the JAX package's layout:

* ``latest/`` — written as ``latest.tmp/`` and moved into place with
  ``os.replace``, so a crash never leaves a half-written ``latest``;
* ``best/`` — a mirror of ``latest/`` refreshed on improvement (hard links:
  files are never rewritten in place, only replaced);
* ``host_state.json`` / ``best_host_state.json`` — the host-side state
  (epoch, early-stopping and plateau counters);
* ``config.json`` — the experiment config snapshot, loadable by either
  package's ``config_from_dict``.

``restore`` reads with ``torch.load(weights_only=True)``.

On a mesh (``bpx_torch/parallel/sharding.py``) the files hold the same
whole, unsharded state: ``save`` gathers every weight and moment whole
(FSDP2's shards and the tensor split's parts; a collective every rank
joins) and rank 0 writes it while the others wait; ``restore`` cuts and
shards what it reads as the model is placed.  So one process's checkpoint
restores into a sharded run and a sharded run's into one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from bpx_torch.parallel import sharding
from bpx_torch.parallel.mesh import barrier, rank

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"


def _to_cpu(obj):
    """Detached CPU copies of every tensor in a nested state dict."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, savedir: str):
        self.savedir = os.path.abspath(savedir)

    def _path(self, tag: str) -> str:
        return os.path.join(self.savedir, tag)

    def save(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             step: int, host_state: Dict[str, Any],
             is_best: bool = False) -> None:
        """Write ``latest`` (and mirror it to ``best`` on improvement); on
        a mesh every rank calls it and rank 0 writes."""
        if sharding.sharded(model):
            model_state = sharding.full_model_state(model)
            opt_state = sharding.full_optimizer_state(model, optimizer)
            if rank() == 0:
                self._write(model_state, opt_state, step, host_state, is_best)
            barrier()
            return
        self._write(_to_cpu(sharding.unwrap(model).state_dict()),
                    _to_cpu(optimizer.state_dict()), step, host_state,
                    is_best)

    def _write(self, model_state, opt_state, step: int,
               host_state: Dict[str, Any], is_best: bool) -> None:
        path = self._path("latest")
        tmp = self._path("latest.tmp")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)                # and the run directory, if new
        torch.save({"model": model_state, "step": int(step)},
                   os.path.join(tmp, MODEL_FILE))
        torch.save(opt_state, os.path.join(tmp, OPTIMIZER_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(os.path.join(self.savedir, "host_state.json"), "w") as f:
            json.dump(host_state, f, indent=2, default=float)
        if is_best:
            best = self._path("best")
            if os.path.exists(best):
                shutil.rmtree(best)
            shutil.copytree(path, best, copy_function=os.link)
            with open(os.path.join(self.savedir, "best_host_state.json"),
                      "w") as f:
                json.dump(host_state, f, indent=2, default=float)

    def has_checkpoint(self, tag: str = "latest") -> bool:
        return os.path.exists(self._path(tag))

    def load(self, tag: str = "latest",
             optimizer: bool = True) -> Dict[str, Any]:
        """The saved ``{"model", "step"}`` and, with ``optimizer``, the
        optimizer's ``"optimizer"`` state dict (CPU tensors)."""
        path = self._path(tag)
        state = torch.load(os.path.join(path, MODEL_FILE),
                           map_location="cpu", weights_only=True)
        if optimizer:
            state["optimizer"] = torch.load(
                os.path.join(path, OPTIMIZER_FILE), map_location="cpu",
                weights_only=True)
        return state

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                tag: str = "latest") -> Tuple[int, Dict[str, Any]]:
        """Load the model's (and the optimizer's) state in place, however
        the model is placed; return the optimizer step and the host state
        dict."""
        state = self.load(tag, optimizer is not None)
        if sharding.sharded(model):
            sharding.load_full_model_state(model, state["model"])
            if optimizer is not None:
                sharding.load_full_optimizer_state(model, optimizer,
                                                   state["optimizer"])
        else:
            sharding.unwrap(model).load_state_dict(state["model"],
                                                   strict=True)
            if optimizer is not None:
                optimizer.load_state_dict(state["optimizer"])
        host_file = ("best_host_state.json" if tag == "best"
                     else "host_state.json")
        host_path = os.path.join(self.savedir, host_file)
        host_state: Dict[str, Any] = {}
        if os.path.exists(host_path):
            with open(host_path) as f:
                host_state = json.load(f)
        return int(state["step"]), host_state

    def save_config(self, config) -> None:
        """Config snapshot (``dataclasses.asdict``, as the JAX package)."""
        os.makedirs(self.savedir, exist_ok=True)
        with open(os.path.join(self.savedir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2, default=str)
