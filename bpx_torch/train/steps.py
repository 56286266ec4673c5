"""Train and eval steps with micro-batch gradient accumulation
(counterpart: ``bpx/train/steps.py``).

A train step takes a super-batch whose tensors are shaped ``(A, micro,
...)``, on the model's device.  It runs A forward/backward passes in
training mode, each with one dropout base seed drawn from an explicit CPU
``torch.Generator`` (the model derives a seed per dropout site from it), lets
autograd sum the fp32 gradients of the fp32 master weights, then multiplies
them by 1/A and averages the loss: the order of the JAX package's
accumulation scan.  Under ``freeze_bert`` the BERT gradients are zeroed
before the optimizer step, as the JAX package's gradient mask does.

``accum_dtype="bfloat16"`` accumulates as the JAX package's scan does at A
> 1: each micro-batch's fp32 gradient is cast to bf16 and added into a bf16
accumulator that starts at zero; after the last micro-batch the sum is cast
back to fp32 and multiplied by 1/A.  Each micro-batch's gradient is moved
out of ``.grad`` into the accumulator before the next backward.  At A = 1
nothing is rounded; ``"float32"`` and None accumulate exactly in fp32.

``accum_unroll``, ``accum_scan_unroll`` and ``donate`` steer XLA's program
in the JAX package and are accepted and inert here: the port runs the
micro-batches as a Python loop.

On a mesh (``mesh``, the model placed by
``bpx_torch/parallel/sharding.py::shard_model``) every rank takes the same
super-batch and keeps its rows of each micro-batch (``place_batch``).
Every rank draws the same base seeds from its identically seeded
generator, and the forward's stream places each dropout mask at the rows
the rank holds, so the masks are the one-process step's.  The loss
function must be the mesh's (``losses.make_loss_fn(..., groups=...)``):
DDP and FSDP2 average the gradients over the ``(data, fsdp)`` ranks.  The
loss reported is that average too, the global loss; ``grad_norm`` sums
each rank's squares once (``sharding.grad_sq_norm``).  Under FSDP2 each
micro-batch's gradient is reduced before the next, so bf16 accumulation
rounds the reduced gradients, which are what one process rounds.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from bpx_torch.inputs import model_inputs
from bpx_torch.ops.dropout import SeedStream, draw_base_seed


def make_train_step(model: torch.nn.Module, model_name: str,
                    loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    grad_accum: int = 1, freeze_bert: bool = False,
                    with_grad_norm: bool = False,
                    generator: Optional[torch.Generator] = None,
                    accum_dtype: Optional[str] = None,
                    accum_unroll: bool = False, accum_scan_unroll: int = 1,
                    donate: bool = True, mesh=None):
    """``train_step(batch) -> {"loss"[, "grad_norm"]}`` (0-dim fp32 device
    tensors; reading them is the caller's sync).  ``generator`` is the CPU
    generator of the dropout seeds (default: a new one seeded with 0).
    ``mesh``: the mesh ``model`` was placed on, or None for one
    process."""
    if accum_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown accum_dtype {accum_dtype!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    inner = model
    if mesh is not None:
        from bpx_torch.parallel import sharding
        inner = sharding.unwrap(model)
    frozen = ([p for n, p in inner.named_parameters()
               if n.startswith("bert.")] if freeze_bert else [])
    bf16_accum = accum_dtype == "bfloat16" and grad_accum > 1

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        rows = None
        if mesh is not None:
            batch, rows = sharding.place_batch(batch, mesh)
        loss_sum = None
        acc = {}
        for i in range(grad_accum):
            micro = {k: v[i] for k, v in batch.items()}
            base = draw_base_seed(gen)
            logits = model(*model_inputs(model_name, micro),
                           dropout_seed=base if rows is None
                           else SeedStream(base, rows))
            loss = loss_fn(logits, micro["target"])
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if bf16_accum:
                _accumulate_bf16(params, acc)
        if bf16_accum:
            for p, a in acc.items():
                p.grad = a.float()
        grads = [p.grad for p in params if p.grad is not None]
        if grad_accum > 1:
            torch._foreach_mul_(grads, 1.0 / grad_accum)
        for p in frozen:
            if p.grad is not None:
                p.grad.zero_()
        loss = loss_sum * (1.0 / grad_accum) if grad_accum > 1 else loss_sum
        if mesh is not None:
            from bpx_torch.parallel.collectives import all_reduce_over
            loss = all_reduce_over(loss.clone(), sharding.dp_groups(mesh))
            loss = loss * (1.0 / sharding.batch_rows(mesh)[1])
        metrics = {"loss": loss}
        if with_grad_norm and mesh is not None:
            metrics["grad_norm"] = sharding.grad_sq_norm(
                model, params, mesh).sqrt()
        elif with_grad_norm:
            metrics["grad_norm"] = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        optimizer.step()
        return metrics

    return train_step


def _accumulate_bf16(params, acc) -> None:
    """Add each parameter's fp32 ``.grad``, cast to bf16, into its bf16
    accumulator in ``acc`` (zeros at the first gradient, so a -0 gradient
    sums to +0 as in the JAX package's scan), then clear ``.grad``."""
    have = [p for p in params if p.grad is not None]
    for p in have:
        if p not in acc:
            acc[p] = torch.zeros_like(p, dtype=torch.bfloat16)
    torch._foreach_add_([acc[p] for p in have],
                        [p.grad.to(torch.bfloat16) for p in have])
    for p in have:
        p.grad = None


def make_eval_step(model: torch.nn.Module, model_name: str,
                   loss_fn: Optional[Callable] = None,
                   output_gates: bool = False, mesh=None):
    """``eval_step(batch) -> {"logits"[, "loss"][, "gates"]}`` in eval mode
    (no dropout), without autograd.  On a ``mesh`` each rank runs its rows
    of the batch (``place_batch``) and the logits and gates of every rank
    are gathered in rank order: every rank returns the whole batch's."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        whole = batch
        if mesh is not None:
            from bpx_torch.parallel import sharding
            batch, _ = sharding.place_batch(batch, mesh,
                                            has_accum_axis=False)
        inputs = model_inputs(model_name, batch)
        if output_gates:
            logits, gates = model(*inputs, output_gates=True)
        else:
            logits, gates = model(*inputs), None
        if mesh is not None:
            logits = sharding.gather_rows(logits, mesh)
            if gates is not None:
                gates = sharding.gather_rows(gates, mesh)
            batch = whole
        out = {"logits": logits}
        if loss_fn is not None:
            out["loss"] = loss_fn(logits, batch["target"])
        if gates is not None:
            out["gates"] = gates
        return out

    return eval_step
