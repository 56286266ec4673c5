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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from bpx_torch.inputs import model_inputs
from bpx_torch.ops.dropout import draw_base_seed


def make_train_step(model: torch.nn.Module, model_name: str,
                    loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    grad_accum: int = 1, freeze_bert: bool = False,
                    with_grad_norm: bool = False,
                    generator: Optional[torch.Generator] = None,
                    accum_dtype: Optional[str] = None,
                    accum_unroll: bool = False, accum_scan_unroll: int = 1,
                    donate: bool = True):
    """``train_step(batch) -> {"loss"[, "grad_norm"]}`` (0-dim fp32 device
    tensors; reading them is the caller's sync).  ``generator`` is the CPU
    generator of the dropout seeds (default: a new one seeded with 0)."""
    if accum_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown accum_dtype {accum_dtype!r}")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    params = [p for p in model.parameters() if p.requires_grad]
    frozen = ([p for n, p in model.named_parameters()
               if n.startswith("bert.")] if freeze_bert else [])
    bf16_accum = accum_dtype == "bfloat16" and grad_accum > 1

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        acc = {}
        for i in range(grad_accum):
            micro = {k: v[i] for k, v in batch.items()}
            logits = model(*model_inputs(model_name, micro),
                           dropout_seed=draw_base_seed(gen))
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
        metrics = {"loss": loss_sum * (1.0 / grad_accum)
                   if grad_accum > 1 else loss_sum}
        if with_grad_norm:
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
                   output_gates: bool = False):
    """``eval_step(batch) -> {"logits"[, "loss"][, "gates"]}`` in eval mode
    (no dropout), without autograd."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        inputs = model_inputs(model_name, batch)
        if output_gates:
            logits, gates = model(*inputs, output_gates=True)
        else:
            logits, gates = model(*inputs), None
        out = {"logits": logits}
        if loss_fn is not None:
            out["loss"] = loss_fn(logits, batch["target"])
        if gates is not None:
            out["gates"] = gates
        return out

    return eval_step
