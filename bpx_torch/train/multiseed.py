"""Vmapped multi-seed training (counterpart: ``bpx/train/multiseed.py``).

The reference reports means over five seeds, trained one process each;
this trains S seeds in one step on one card: every parameter is stacked
on a leading seed axis (``torch.func.stack_module_state``) and the forward
is ``torch.func.vmap`` of one seed's forward (``functional_call``) over
it, so each GEMM is one batched GEMM over the seeds and each kernel call
folds the seeds into its batch (the ops' vmap rules: one flash launch over
S·B·H with one dropout seed per seed, S LayerNorm launches).  The batch is
shared by the seeds (``in_dims=None``), the dropout seeds are per seed
(:class:`~bpx_torch.ops.dropout.SeedStreams`: seed s's masks are those its
own single-seed step draws), and the buffers are shared.

Usage::

    state = init_multi_seed(cfg, [1, 2, 3, 4, 5],
                            lambda ps: make_optimizer(ps, 1e-3))
    step = make_multi_seed_train_step(state, loss_fn)
    metrics = step(batch)                  # metrics["loss"]: (S,)
    model_sd, optimizer_sd = unstack_seed(state, 0)

The gradient is autograd's, not ``torch.func.grad``'s: the kernels are
``torch.library`` ops whose ``register_autograd`` builds an
``autograd.Function`` without ``setup_context``, which every ``torch.func``
transform rejects, so no module that attends or normalises can run under
``torch.func.grad``.  The step therefore vmaps the S losses and calls
``backward`` on their sum: the losses are independent, so each seed's
gradient is its own, and autograd runs each recorded (folded) launch's
backward formula once over the folded tensors.  This is the JAX package's
``vmap(value_and_grad)`` for any model, with the seed axis of the backward
written out by autograd.

The optimizer steps the stacked tensors.  Adam, AdamW and the port's RAdam
are elementwise with one step count per tensor (or group) that every seed
shares, since all seeds step together, so each seed's update is the one its
own optimizer makes.  (An optimizer that reduces over a tensor, such as a
norm-clipping one, would mix the seeds.)

``remat`` (and ``remat_policy``) recompute as on one seed, over the seed
axis: ``torch.utils.checkpoint`` inside the vmap would replay a layer in the
backward outside it, where ``functional_call`` no longer holds the stacked
weights, so ``ops/encoder.py::recomputed`` checkpoints the vmapped layer at
the unbatched level instead (an ``autograd.Function`` whose vmap rule takes
the layer's stacked weights, its inputs and the seed axis's carrier as
explicit tensors).  The first pass and the replay each run the layer under
a vmap of their own from the same dropout seeds, and ``"save_attn"`` keeps
each folded flash forward's outputs.  Every model of the registry runs,
the notebook-era ones too.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call, stack_module_state, vmap

from bpx_torch.config import ModelConfig
from bpx_torch.inputs import model_inputs
from bpx_torch.models import get_model
from bpx_torch.ops.dropout import SeedStreams, draw_base_seed
from bpx_torch.utils.seeding import set_seed


@dataclasses.dataclass
class MultiSeedState:
    """S models as one: ``params`` (name -> (S, ...) leaf tensors, the
    optimizer's), ``buffers`` (shared), ``optimizer`` over ``params`` in the
    models' parameter order, and ``template``, the model's structure on
    the meta device, which ``functional_call`` runs with them."""
    seeds: Tuple[int, ...]
    template: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer


def init_multi_seed(config: ModelConfig, seeds: Sequence[int],
                    optimizer_factory: Callable, device=None
                    ) -> MultiSeedState:
    """One model per seed, each drawn as the single-seed path draws it
    (``set_seed(seed)``, then ``get_model(config, seed=seed)``), stacked;
    ``optimizer_factory(params)`` builds the optimizer over the stacked
    tensors.  (The JAX package also takes the model's name and an example
    batch, for flax's shape inference; the port's modules need neither.)"""
    if not seeds:
        raise ValueError("init_multi_seed needs at least one seed")
    models = []
    for seed in seeds:
        set_seed(seed)
        models.append(get_model(config, device=device, seed=seed))
    params, buffers = stack_module_state(models)
    del models
    ordered = list(params.values())
    return MultiSeedState(
        seeds=tuple(seeds), template=get_model(config, device="meta"),
        params=params,
        buffers={k: v[0] for k, v in buffers.items()},
        optimizer=optimizer_factory(ordered))


def make_multi_seed_train_step(state: MultiSeedState, loss_fn: Callable,
                               generators: Optional[
                                   Sequence[torch.Generator]] = None,
                               with_grad_norm: bool = False):
    """``train_step(batch) -> {"loss": (S,)[, "grad_norm": (S,)]}``: one
    micro-batch (no accumulation, as in the JAX package's step) shared by
    every seed, in training mode with every configured dropout.  Seed s
    draws its dropout base seed from ``generators[s]`` (default: a CPU
    generator seeded with seed s) as the single-seed step draws it from
    its generator.  ``grad_norm`` is each seed's own global norm.  (The
    JAX package also takes the model's name; here the state's config
    holds it.)"""
    cfg = state.template.config
    n = len(state.seeds)
    gens = (list(generators) if generators is not None
            else [torch.Generator().manual_seed(s) for s in state.seeds])
    if len(gens) != n:
        raise ValueError(f"{len(gens)} generators for {n} seeds")
    template = state.template.train()
    names = list(state.params)

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        bases = [draw_base_seed(g) for g in gens]
        inputs = model_inputs(cfg.model, batch)
        # the seed axis's carrier: what lets a dropout site whose input is
        # shared by the seeds still take one mask per seed
        axis = torch.empty(n, 0)

        def loss_of(params, axis):
            logits = functional_call(
                template, (params, state.buffers), inputs,
                {"dropout_seed": SeedStreams(bases, axis)})
            return loss_fn(logits, batch["target"])

        state.optimizer.zero_grad(set_to_none=True)
        losses = vmap(loss_of)(state.params, axis)
        losses.sum().backward()
        metrics = {"loss": losses.detach()}
        if with_grad_norm:
            metrics["grad_norm"] = seed_grad_norms(
                [state.params[k].grad for k in names], n)
        state.optimizer.step()
        return metrics

    return train_step


def seed_grad_norms(grads: List[Optional[torch.Tensor]],
                    n: int) -> torch.Tensor:
    """(n,) global L2 norm of each seed's slice of the stacked gradients
    (a norm over the stacked tensors would mix the seeds)."""
    per_tensor = [g.reshape(n, -1).float().norm(dim=1)
                  for g in grads if g is not None]
    return torch.linalg.vector_norm(torch.stack(per_tensor), dim=0)


def unstack_seed(state: MultiSeedState, index: int
                 ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Seed ``index``'s (model state dict, optimizer state dict), as its
    single-seed model and optimizer would hold them: a model built from the
    config loads the first, an optimizer of the same kind over that model's
    parameters the second, and ``CheckpointManager`` and ``Predictor`` take
    them unchanged."""
    n = len(state.seeds)
    take = lambda t: t[index].detach().clone()
    model_sd = {k: take(v) for k, v in state.params.items()}
    model_sd.update({k: v.detach().clone() for k, v in state.buffers.items()})
    full = state.optimizer.state_dict()
    shapes = [tuple(p.shape) for p in state.params.values()]
    per_param = {}
    for i, entry in full["state"].items():
        per_param[i] = {
            k: (take(v) if isinstance(v, torch.Tensor)
                and tuple(v.shape) == shapes[i] and v.shape[0] == n
                else v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in entry.items()}
    return model_sd, {"state": per_param,
                      "param_groups": copy.deepcopy(full["param_groups"])}
