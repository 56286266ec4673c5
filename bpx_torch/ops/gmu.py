"""Gated Multimodal Units (counterpart: ``bpx/ops/gmu.py``).

All projections are bias-free.  Each layer returns ``(fused, gates)``, the
gates being the interpretability channel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bpx_torch.ops.init import linear


def _apply(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype))


class GatedBimodalFusionLayer(nn.Module):
    """``fused = z * tanh(W1 x1) * x1 + (1-z) * tanh(W2 x2) * x2`` with
    ``z = sigmoid(Wg [x1, x2])``; gates are ``[z, 1-z]``."""

    def __init__(self, size_out: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.dtype = dtype
        self.hidden1 = linear(size_out, size_out, False, "lecun", gen, device)
        self.hidden2 = linear(size_out, size_out, False, "lecun", gen, device)
        self.x_gate = linear(2 * size_out, size_out, False, "lecun", gen,
                             device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        dt = self.dtype
        h1 = torch.tanh(_apply(self.hidden1, x1, dt))
        h2 = torch.tanh(_apply(self.hidden2, x2, dt))
        z = torch.sigmoid(_apply(self.x_gate, torch.cat([x1, x2], -1), dt))
        fused = z * h1 * x1 + (1.0 - z) * h2 * x2
        return fused, torch.cat([z, 1.0 - z], -1)


class GatedNModalLayer(nn.Module):
    """``sum_i sigmoid(Wg_i [x1..xn]) * tanh(W_i x_i)``; the N gate
    projections are one fused (sum_in -> N*size_out) GEMM."""

    def __init__(self, n_inputs: int, size_out: int,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n_inputs = n_inputs
        self.dtype = dtype
        for i in range(n_inputs):
            setattr(self, f"hidden{i + 1}",
                    linear(size_out, size_out, False, "lecun", gen, device))
        self.x_gates = linear(n_inputs * size_out, n_inputs * size_out,
                              False, "lecun", gen, device)

    def forward(self, xs: Sequence[torch.Tensor]):
        assert len(xs) == self.n_inputs, \
            f"expected {self.n_inputs} inputs, got {len(xs)}"
        dt = self.dtype
        hs = [torch.tanh(_apply(getattr(self, f"hidden{i + 1}"), x, dt))
              for i, x in enumerate(xs)]
        z = torch.sigmoid(_apply(self.x_gates, torch.cat(list(xs), -1), dt))
        zs = torch.chunk(z, self.n_inputs, -1)
        fused = zs[0] * hs[0]
        for z_i, h_i in zip(zs[1:], hs[1:]):
            fused = fused + z_i * h_i
        return fused, z
