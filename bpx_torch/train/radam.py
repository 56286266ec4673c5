"""Rectified Adam (counterpart: ``bpx/train/radam.py``).

:class:`RAdam` is a ``torch.optim.Optimizer`` with the JAX package's
arithmetic: Adam's moments, the variance rectification term, the adaptive
step only while the approximated SMA length ``n_sma`` exceeds 4, otherwise
the bias-corrected momentum step (the JAX package's ``degenerate_to_sgd``,
which every caller there leaves on), and ``eps`` added to ``sqrt(v /
bias2)``.  ``torch.optim.RAdam`` is not this optimizer: it switches to the
adaptive step at ``n_sma > 5`` (with beta2 = 0.999 ``n_sma`` is 4.996 at
step 5, where this one is adaptive and torch's is not), and it adds
``eps`` after the bias correction.

The per-step scalars (bias corrections, ``n_sma``, the rectification) are
computed on the host in fp32 0-dim CPU tensors in the JAX package's order
of operations, so they round as its fp32 arithmetic does: at step 5
``n_sma - 4`` is 0.996 out of a difference of two numbers near 2000, and a
different rounding of ``beta2**t`` moves the rectification by a percent.
The moments and the update are fp32 ``_foreach`` ops over the parameters,
in the order of the JAX package's expressions.

``plain_radam`` is the same class: in the reference the two differ only in
a host-side cache of the rectification term.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def step_coefficients(step: int, b1: float, b2: float
                      ) -> Tuple[float, float, float, bool]:
    """(bias1, bias2, rect, adaptive) of optimizer step ``step`` (from 1),
    each an fp32 value as a Python float: the JAX package's
    ``_radam_core`` scalars, rounded as there."""
    t = _f32(float(step))
    beta2_t = _f32(b2) ** t
    n_sma_max = 2.0 / (1.0 - b2) - 1.0
    n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
    bias1 = 1.0 - _f32(b1) ** t
    bias2 = 1.0 - beta2_t
    rect = torch.sqrt(torch.clamp(
        (n_sma - 4.0) / (n_sma_max - 4.0) * (n_sma - 2.0) / n_sma
        * n_sma_max / (n_sma_max - 2.0), min=0.0))
    return (bias1.item(), bias2.item(), rect.item(),
            bool((n_sma > 4.0).item()))


class RAdam(torch.optim.Optimizer):
    """Rectified Adam.  Each parameter group counts its steps in
    ``group["step"]`` (the JAX package keeps one count for all parameters),
    saved with the group in the state dict; the state per parameter is
    ``exp_avg`` and ``exp_avg_sq``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        if lr < 0.0:
            raise ValueError(f"invalid learning rate {lr}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, step=0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if p.grad.is_sparse:
                    raise RuntimeError("RAdam takes no sparse gradients")
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            group["step"] += 1
            self._update(group, params)
        return loss

    def _update(self, group, params):
        states = [self.state[p] for p in params]
        grads = [p.grad for p in params]
        m = [s["exp_avg"] for s in states]
        v = [s["exp_avg_sq"] for s in states]
        b1, b2 = group["betas"]
        # mu = b1 * m + (1 - b1) * g;  nu = b2 * v + (1 - b2) * g * g
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
        g2 = torch._foreach_mul(grads, 1.0 - b2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        del g2
        bias1, bias2, rect, adaptive = step_coefficients(group["step"], b1, b2)
        upd = torch._foreach_div(m, bias1)
        if adaptive:
            # rect * m_hat / (sqrt(v / bias2) + eps)
            den = torch._foreach_div(v, bias2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_mul_(upd, rect)
            torch._foreach_div_(upd, den)
            del den
        torch._foreach_mul_(upd, -group["lr"])
        torch._foreach_add_(params, upd)
