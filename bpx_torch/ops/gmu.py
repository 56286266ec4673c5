"""Gated Multimodal Units (counterpart: ``bpx/ops/gmu.py``).

All projections are bias-free.  Each layer returns ``(fused, gates)``, the
gates being the interpretability channel.  ``in_features`` gives the width
of each input where it is not ``size_out`` (flax infers a Dense layer's
input width from its first call; the port builds its layers up front):
the notebook-era models feed their GMUs 2E-wide summaries and BERT's
pooled output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bpx_torch.ops.init import linear


def _apply(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return nn.functional.linear(x.to(dtype), layer.weight.to(dtype))


def _widths(n: int, size_out: int,
            in_features: Optional[Sequence[int]]) -> list:
    widths = [size_out] * n if in_features is None else list(in_features)
    if len(widths) != n:
        raise ValueError(f"{len(widths)} input widths for {n} inputs")
    return widths


def _hidden(module: nn.Module, widths, size_out, gen, device) -> None:
    """``hidden1 .. hiddenN``: input i's tanh projection to ``size_out``."""
    for i, w in enumerate(widths):
        setattr(module, f"hidden{i + 1}",
                linear(w, size_out, False, "lecun", gen, device))


def _tanh_hidden(module: nn.Module, xs, dtype):
    return [torch.tanh(_apply(getattr(module, f"hidden{i + 1}"), x, dtype))
            for i, x in enumerate(xs)]


class GatedBimodalLayer(nn.Module):
    """``fused = z * tanh(W1 x1) + (1-z) * tanh(W2 x2)`` with
    ``z = sigmoid(Wg [x1, x2])``; gates are ``[z, 1-z]``."""

    def __init__(self, size_out: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 in_features: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = dtype
        widths = _widths(2, size_out, in_features)
        _hidden(self, widths, size_out, gen, device)
        self.x_gate = linear(sum(widths), size_out, False, "lecun", gen,
                             device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        h1, h2 = _tanh_hidden(self, (x1, x2), self.dtype)
        z = torch.sigmoid(_apply(self.x_gate, torch.cat([x1, x2], -1),
                                 self.dtype))
        fused = z * h1 + (1.0 - z) * h2
        return fused, torch.cat([z, 1.0 - z], -1)


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
                 gen: Optional[torch.Generator] = None, device=None,
                 in_features: Optional[Sequence[int]] = None):
        super().__init__()
        self.n_inputs = n_inputs
        self.dtype = dtype
        widths = _widths(n_inputs, size_out, in_features)
        _hidden(self, widths, size_out, gen, device)
        self.x_gates = linear(sum(widths), n_inputs * size_out, False,
                              "lecun", gen, device)

    def forward(self, xs: Sequence[torch.Tensor]):
        assert len(xs) == self.n_inputs, \
            f"expected {self.n_inputs} inputs, got {len(xs)}"
        hs = _tanh_hidden(self, xs, self.dtype)
        z = torch.sigmoid(_apply(self.x_gates, torch.cat(list(xs), -1),
                                 self.dtype))
        zs = torch.chunk(z, self.n_inputs, -1)
        fused = zs[0] * hs[0]
        for z_i, h_i in zip(zs[1:], hs[1:]):
            fused = fused + z_i * h_i
        return fused, z


class GatedHierarchicalLayer(nn.Module):
    """3-input hierarchical GMU, two gates from ``[x1, x2, x3]``:
    ``z1*h1 + (1-z1)*z2*h2 + (1-z1)*(1-z2)*h3``; gates are
    ``[z1, (1-z1)*z2, (1-z1)*(1-z2)]``."""

    def __init__(self, size_out: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 in_features: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = dtype
        widths = _widths(3, size_out, in_features)
        _hidden(self, widths, size_out, gen, device)
        self.x1_gate = linear(sum(widths), size_out, False, "lecun", gen,
                              device)
        self.x2_gate = linear(sum(widths), size_out, False, "lecun", gen,
                              device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor):
        dt = self.dtype
        h1, h2, h3 = _tanh_hidden(self, (x1, x2, x3), dt)
        x_cat = torch.cat([x1, x2, x3], -1)
        z1 = torch.sigmoid(_apply(self.x1_gate, x_cat, dt))
        z2 = torch.sigmoid(_apply(self.x2_gate, x_cat, dt))
        fused = z1 * h1 + (1 - z1) * z2 * h2 + (1 - z1) * (1 - z2) * h3
        gates = torch.cat([z1, (1 - z1) * z2, (1 - z1) * (1 - z2)], -1)
        return fused, gates


class GatedSoftmaxLayer(nn.Module):
    """3-input GMU with a per-feature softmax over the modalities: each
    input, mapped to ``size_out`` by ``transform_i`` where its width
    differs, goes through one shared ``x1_gate``; ``z = softmax`` over the
    three, ``fused = sum_i z_i * tanh(W_i x_i)``.  The per-modality stack
    (x1, x2, x3) is the JAX package's correction of the notebook, whose
    forward stacks x1 three times."""

    def __init__(self, size_out: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 in_features: Optional[Sequence[int]] = None):
        super().__init__()
        self.dtype = dtype
        widths = _widths(3, size_out, in_features)
        _hidden(self, widths, size_out, gen, device)
        self.transformed = [w != size_out for w in widths]
        for i, w in enumerate(widths):
            if self.transformed[i]:
                setattr(self, f"transform_{i + 1}",
                        linear(w, size_out, False, "lecun", gen, device))
        self.x1_gate = linear(size_out, size_out, False, "lecun", gen,
                              device)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, x3: torch.Tensor):
        dt = self.dtype
        xs = (x1, x2, x3)
        hs = _tanh_hidden(self, xs, dt)
        xs_t = [_apply(getattr(self, f"transform_{i + 1}"), x, dt)
                if self.transformed[i] else x for i, x in enumerate(xs)]
        stacked = torch.stack([_apply(self.x1_gate, x, dt) for x in xs_t])
        z = torch.softmax(stacked, dim=0)
        fused = z[0] * hs[0] + z[1] * hs[1] + z[2] * hs[2]
        return fused, torch.cat([z[0], z[1], z[2]], -1)
