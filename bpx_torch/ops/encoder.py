"""Pre-LN transformer encoder with self / crossmodal / biprojection modes
(counterpart: ``bpx/ops/encoder.py``).

* **self**: pre-LN self-attention block;
* **cross**: Q from ``x``, K/V from the other modality, the *shared*
  LayerNorm 0 applied to both streams;
* **biprojection**: a self-attention sublayer, residual, then a
  cross-attention sublayer re-using the same attention weights, whose query
  is the un-normalised sublayer output while K/V get LayerNorm 1; the FFN
  uses LayerNorm 2.

The stack scales inputs by ``sqrt(embed_dim)``, adds channel-0-keyed
sinusoidal positions, runs the layers (K/V embedded once and reused by every
layer) and ends with a final LayerNorm.  The serving forward has no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bpx_torch.ops.attention import MultiheadAttention
from bpx_torch.ops.init import linear
from bpx_torch.ops.norm import LayerNorm
from bpx_torch.ops.positions import positional_embedding


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4,
                 attn_mask: bool = False, biprojection: bool = False,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.attn_mask = attn_mask
        self.biprojection = biprojection
        self.attn = MultiheadAttention(embed_dim, num_heads, dtype, gen,
                                       device)
        self.ln0 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.ln1 = LayerNorm(embed_dim, dtype=dtype, device=device)
        if biprojection:
            self.ln2 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.fc1 = linear(embed_dim, 4 * embed_dim, True, "xavier", gen, device)
        self.fc2 = linear(4 * embed_dim, embed_dim, True, "xavier", gen, device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, x_k: Optional[torch.Tensor] = None,
                x_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x_v=None`` with ``x_k`` given means "V aliases K", so the
        attention fuses the k/v GEMMs."""
        residual = x
        if x_k is None:
            h = self.attn(self.ln0(x), masked=self.attn_mask)
        elif self.biprojection:
            h = self.attn(self.ln0(x), masked=self.attn_mask)
            x = residual + h
            residual = x
            k = self.ln1(x_k)
            v = k if x_v is None else self.ln1(x_v)
            h = self.attn(x, k, v, masked=self.attn_mask)
        else:
            q = self.ln0(x)
            k = self.ln0(x_k)
            v = k if x_v is None else self.ln0(x_v)
            h = self.attn(q, k, v, masked=self.attn_mask)
        x = residual + h

        ffn_ln = self.ln2 if self.biprojection else self.ln1
        residual = x
        dt = self.dtype
        h = nn.functional.linear(ffn_ln(x), self.fc1.weight.to(dt),
                                 self.fc1.bias.to(dt))
        h = nn.functional.linear(torch.relu(h), self.fc2.weight.to(dt),
                                 self.fc2.bias.to(dt))
        return residual + h


class TransformerEncoder(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, layers: int,
                 attn_mask: bool = False, biprojection: bool = False,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.embed_scale = math.sqrt(embed_dim)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dim, num_heads, attn_mask,
                                    biprojection, dtype, gen, device)
            for _ in range(layers)])
        self.final_norm = LayerNorm(embed_dim, dtype=dtype, device=device)

    def _embed(self, x_in: torch.Tensor) -> torch.Tensor:
        # the scale is cast to the stream's dtype first, as JAX does with a
        # weakly-typed Python scalar
        x = x_in * torch.tensor(self.embed_scale, dtype=x_in.dtype)
        return x + positional_embedding(x_in, dtype=x.dtype)

    def forward(self, x_in: torch.Tensor,
                x_in_k: Optional[torch.Tensor] = None,
                x_in_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._embed(x_in)
        x_k = x_v = None
        if x_in_k is not None and x_in_v is not None:
            x_k = self._embed(x_in_k)
            if x_in_v is not x_in_k:
                x_v = self._embed(x_in_v)
        for layer in self.layers:
            x = layer(x, x_k, x_v)
        return self.final_norm(x)
