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
sinusoidal positions, applies embedding dropout, runs the layers (K/V
embedded once and reused by every layer) and ends with a final LayerNorm.
``attention_impl`` picks each attention's path (``ops/attention.py``).  In
training mode the layers apply attention dropout, residual dropout after
each attention and after fc2, and ReLU dropout; with
embedding dropout, V is embedded separately from K with its own draw, so it
no longer aliases K (one more LayerNorm per layer, three projections).

``remat`` recomputes each layer's activations in the backward instead of
keeping them (``torch.utils.checkpoint``, as the JAX package wraps each layer
in ``jax.checkpoint``), in training with grad enabled only; ``remat_policy``
``"save_attn"`` keeps the flash forward's outputs across the recompute
boundary (:func:`resolve_remat_policy`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bpx_torch.ops.attention import MultiheadAttention
from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.init import linear
from bpx_torch.ops.norm import LayerNorm
from bpx_torch.ops.positions import positional_embedding


def _save_attn(ctx, op, *args, **kwargs):
    if op == torch.ops.bpx_torch.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: Optional[str]):
    """A config's ``remat_policy`` as a selective-checkpoint policy: None
    (full recompute) for None; for ``"save_attn"`` one that saves the
    outputs (out, lse) of ``bpx_torch::flash_fwd`` and recomputes every
    other op, so the backward reruns no flash forward (on the einsum
    attention no op is saved: full recompute, as in the JAX package)."""
    if name is None:
        return None
    if name == "save_attn":
        return _save_attn
    raise ValueError(f"unknown remat_policy: {name!r}")


def recomputed(layer: nn.Module, policy, seeds: Optional[SeedStream],
               *args) -> torch.Tensor:
    """``layer(*args, seeds)`` under ``torch.utils.checkpoint``: what it
    computes is dropped after the forward and recomputed in the backward,
    but for the ops that ``policy`` (:func:`resolve_remat_policy`) saves.

    The replay runs the layer's Python forward again, so it must draw the
    first pass's dropout seeds: the layer draws from a stream of its own
    that starts at ``seeds``' count, and ``seeds`` then moves past the
    seeds the layer drew."""
    start = None if seeds is None else seeds.count
    drawn = []

    def run(*a):
        own = None if seeds is None else seeds.at(start)
        out = layer(*a, own)
        drawn.append(None if own is None else own.count)
        return out

    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    out = checkpoint(run, *args, use_reentrant=False, **kw)
    if seeds is not None:
        seeds.count = drawn[0]
    return out


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4,
                 attn_mask: bool = False, biprojection: bool = False,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 attn_dropout: float = 0.0, relu_dropout: float = 0.0,
                 res_dropout: float = 0.0, attention_impl: str = "xla"):
        super().__init__()
        self.attn_mask = attn_mask
        self.biprojection = biprojection
        self.relu_dropout = relu_dropout
        self.res_dropout = res_dropout
        self.attn = MultiheadAttention(embed_dim, num_heads, dtype, gen,
                                       device, attn_dropout, attention_impl)
        self.ln0 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.ln1 = LayerNorm(embed_dim, dtype=dtype, device=device)
        if biprojection:
            self.ln2 = LayerNorm(embed_dim, dtype=dtype, device=device)
        self.fc1 = linear(embed_dim, 4 * embed_dim, True, "xavier", gen, device)
        self.fc2 = linear(4 * embed_dim, embed_dim, True, "xavier", gen, device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, x_k: Optional[torch.Tensor] = None,
                x_v: Optional[torch.Tensor] = None,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        """``x_v=None`` with ``x_k`` given means "V aliases K", so the
        attention fuses the k/v GEMMs."""
        drop = lambda h, rate: maybe_dropout(h, rate, self.training, seeds)
        attn = lambda q, k=None, v=None: self.attn(q, k, v, self.attn_mask,
                                                   seeds)
        residual = x
        if x_k is None:
            h = attn(self.ln0(x))
        elif self.biprojection:
            h = drop(attn(self.ln0(x)), self.res_dropout)
            x = residual + h
            residual = x
            k = self.ln1(x_k)
            v = k if x_v is None else self.ln1(x_v)
            h = attn(x, k, v)
        else:
            q = self.ln0(x)
            k = self.ln0(x_k)
            v = k if x_v is None else self.ln0(x_v)
            h = attn(q, k, v)
        x = residual + drop(h, self.res_dropout)

        ffn_ln = self.ln2 if self.biprojection else self.ln1
        residual = x
        dt = self.dtype
        h = nn.functional.linear(ffn_ln(x), self.fc1.weight.to(dt),
                                 self.fc1.bias.to(dt))
        h = drop(torch.relu(h), self.relu_dropout)
        h = nn.functional.linear(h, self.fc2.weight.to(dt),
                                 self.fc2.bias.to(dt))
        return residual + drop(h, self.res_dropout)


class TransformerEncoder(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, layers: int,
                 attn_mask: bool = False, biprojection: bool = False,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 attn_dropout: float = 0.0, relu_dropout: float = 0.0,
                 res_dropout: float = 0.0, embed_dropout: float = 0.0,
                 attention_impl: str = "xla", remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.embed_scale = math.sqrt(embed_dim)
        self.embed_dropout = embed_dropout
        self.remat = remat
        self.remat_policy = resolve_remat_policy(remat_policy)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(embed_dim, num_heads, attn_mask,
                                    biprojection, dtype, gen, device,
                                    attn_dropout, relu_dropout, res_dropout,
                                    attention_impl)
            for _ in range(layers)])
        self.final_norm = LayerNorm(embed_dim, dtype=dtype, device=device)

    def _embed(self, x_in: torch.Tensor,
               seeds: Optional[SeedStream]) -> torch.Tensor:
        # the scale is cast to the stream's dtype first, as JAX does with a
        # weakly-typed Python scalar
        x = x_in * torch.tensor(self.embed_scale, dtype=x_in.dtype)
        x = x + positional_embedding(x_in, dtype=x.dtype)
        return maybe_dropout(x, self.embed_dropout, self.training, seeds)

    def forward(self, x_in: torch.Tensor,
                x_in_k: Optional[torch.Tensor] = None,
                x_in_v: Optional[torch.Tensor] = None,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        x = self._embed(x_in, seeds)
        x_k = x_v = None
        if x_in_k is not None and x_in_v is not None:
            x_k = self._embed(x_in_k, seeds)
            # V aliases K unless embedding dropout draws it separately
            same = not self.training or self.embed_dropout <= 0.0
            if not (x_in_v is x_in_k and same):
                x_v = self._embed(x_in_v, seeds)
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if recompute:
                x = recomputed(layer, self.remat_policy, seeds, x, x_k, x_v)
            else:
                x = layer(x, x_k, x_v, seeds)
        return self.final_norm(x)
