"""Multi-head attention over batch-first streams (counterpart:
``bpx/ops/attention.py::MultiheadAttention``).

q/k/v/out are separate parameters; when the streams alias (q = k = v, or
k = v) their weights are concatenated and applied as one GEMM.  The
projections come out as (B, T, S, H, D) and the (B, H, T, D) views the
attention takes are strided views of that buffer: no transpose is copied.
q is scaled by ``head_dim**-0.5`` in the compute dtype.

``impl`` chooses the attention as the JAX package's ``attention_impl``
does: ``"pallas"`` the flash kernels (``ops/flash_attention.py``), anything
else :func:`dot_product_attention`, the plain einsum attention of the JAX
package's XLA path, which takes any dtype and head dim.  Only the config
chooses.  The flash kernels take bf16 and fp32 at any head dim
(``flash_attention.kernel_route``: the tabled kernels for bf16 at the
tabled head dims, their panel builds for bf16 at the rest up to 256, the
generic ones for fp32 up to 256, the chunked ones above 256); for another
dtype the flash wrappers raise, and nothing falls back to the einsum
attention.

In training mode (``module.training``, the JAX package's
``deterministic=False``) a per-module ``attn_dropout`` rate draws one seed
per call from the forward's :class:`SeedStream`: the flash kernels' fused
dropout, or the hash dropout on the einsum path's probabilities.

Under a tensor split (``bpx_torch/parallel/sharding.py``) a rank holds
``num_heads`` of the ``global_heads`` heads: its rows of q/k/v
(column-parallel) and its columns of ``out_proj`` (row-parallel), whose
partial sums are added over the ``tensor`` group before the bias.  The
dropout of either path hashes the local heads at their global index, and
the batch rows at the rows the forward's stream says its rank holds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.init import linear
from bpx_torch.ops.masks import band_bias
from bpx_torch.parallel.collectives import (TensorSplit, enter_split,
                                            leave_split)


def fused_projection(x: torch.Tensor, layers: Sequence[nn.Linear],
                     num_heads: int, dtype: torch.dtype):
    """``x @ [W1|W2|..]^T + [b1|b2|..]`` in ``dtype`` as one GEMM; returns
    one (B, H, T, D) view per layer."""
    w = torch.cat([l.weight for l in layers]).to(dtype)
    b = (torch.cat([l.bias for l in layers]).to(dtype)
         if layers[0].bias is not None else None)
    y = nn.functional.linear(x.to(dtype), w, b)
    B, T, _ = y.shape
    y = y.view(B, T, len(layers), num_heads, -1)
    return tuple(y[:, :, i].transpose(1, 2) for i in range(len(layers)))


def attention_dropout(rate: float, training: bool,
                      seeds: Optional[SeedStream]):
    """(dropout_rate, dropout_seed) for one flash call: the rate only in
    training mode, with the next seed of the forward's stream."""
    if rate <= 0.0 or not training:
        return 0.0, None
    if seeds is None:
        raise ValueError("attention dropout in training mode needs a "
                         "SeedStream")
    return rate, seeds.next()


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0, training: bool = False,
                          seeds: Optional[SeedStream] = None,
                          prescaled: bool = True,
                          heads: Optional[tuple] = None,
                          members: int = 1) -> torch.Tensor:
    """The einsum attention on (B, H, T, D) tensors (counterpart:
    ``bpx/ops/attention.py::dot_product_attention``): fp32 scores, an
    additive fp32 ``bias`` broadcast to (B, H, Tq, Tk), the softmax in fp32
    cast to q's dtype, hash dropout on the probabilities in training, then
    the product with V summed in fp32 and cast back.  With ``prescaled``
    False the scores are divided by sqrt(head_dim) in fp32 instead, as the
    JAX package's BERT does on this path.  ``heads`` = (h_off, H_g): q's
    heads are heads h_off.. of H_g, where their dropout hashes them.
    ``members`` 2: the batch folds a grouped pair's two members, whose
    dropout places each member's rows in its own part of the global
    batch."""
    dt = q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if not prescaled:
        scores = scores / torch.tensor(float(q.shape[-1])).sqrt()
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(dt)
    split = None if heads is None else (-3, *heads)
    probs = maybe_dropout(probs.unflatten(0, (members, -1)), dropout_rate,
                          training, seeds, split, batch_dim=1).flatten(0, 1)
    return torch.matmul(probs.float(), v.float()).to(dt)


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D); free on the flash kernel's output."""
    B, H, T, D = ctx.shape
    return ctx.transpose(1, 2).reshape(B, T, H * D)


def flash_place(seeds: Optional[SeedStream], split: Optional[TensorSplit],
                heads: int, global_heads: int, batch: int = 0,
                members: int = 1) -> Optional[tuple]:
    """A flash call's placement (b_off, h_off, H_g): the batch rows of the
    forward's stream and the rank's ``heads`` of ``global_heads``; None
    when neither is placed.  A call whose ``batch`` rows fold ``members``
    > 1 members of a grouped pair, each with its own part of the global
    batch, adds the stride between the members' first blocks, B_g * H_g
    (``ops/flash_attention.py``)."""
    rows = getattr(seeds, "rows", None)
    if rows is None and split is None:
        return None
    h_off = 0 if split is None else split.rank * heads
    place = (0 if rows is None else rows[0], h_off, global_heads)
    if members == 1:
        return place
    global_rows = batch // members if rows is None else rows[1]
    return (*place, global_rows * global_heads)


class MultiheadAttention(nn.Module):
    """Call with ``query`` only for self-attention, or ``query, key,
    value`` for cross-attention; ``masked`` applies the offset band."""

    _linear = staticmethod(linear)
    #: the rank's place in the tensor group when the heads are split
    split: Optional[TensorSplit] = None
    #: the members whose batches the attention call folds into one (a
    #: grouped pair's 2, ``ops/encoder.py::PairAttention``)
    members = 1

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 attn_dropout: float = 0.0, impl: str = "xla"):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.attn_dropout = attn_dropout
        self.impl = impl
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.global_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = self.head_dim ** -0.5
        self.dtype = dtype
        proj = lambda: self._linear(embed_dim, embed_dim, True, "xavier", gen,
                                    device)
        self.q_proj = proj()
        self.k_proj = proj()
        self.v_proj = proj()
        self.out_proj = proj()

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                masked: bool = False,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        dt = self.dtype
        proj = self._project
        if key is query and value is query:
            q, k, v = proj(query, (self.q_proj, self.k_proj, self.v_proj))
        elif value is key:
            (q,) = proj(query, (self.q_proj,))
            k, v = proj(key, (self.k_proj, self.v_proj))
        else:
            (q,) = proj(query, (self.q_proj,))
            (k,) = proj(key, (self.k_proj,))
            (v,) = proj(value, (self.v_proj,))
        q = q * torch.tensor(self.scaling, dtype=dt)
        place = flash_place(seeds, self.split, self.num_heads,
                            self.global_heads, q.shape[0], self.members)
        if self.impl == "pallas":
            rate, seed = attention_dropout(self.attn_dropout, self.training,
                                           seeds)
            if seed is not None and place is not None:
                # placed, each member is a seed group of its own
                seed = [seed] * self.members
            ctx = flash_attention(q, k, v, masked, None, rate, seed,
                                  place=place)
        else:
            bias = (band_bias(q.shape[2], k.shape[2], q.device) if masked
                    else None)
            ctx = dot_product_attention(
                q, k, v, bias, self.attn_dropout, self.training, seeds,
                heads=None if place is None else place[1:3],
                members=self.members)
        return self._output(ctx)

    def _project(self, x: torch.Tensor, layers: Sequence[nn.Linear]):
        """One (B, H, T, D) view per layer of ``layers`` (one GEMM)."""
        return fused_projection(enter_split(x, self.split), layers,
                                self.num_heads, self.dtype)

    def _output(self, ctx: torch.Tensor) -> torch.Tensor:
        """The (B, H, T, D) attention output through ``out_proj``."""
        dt = self.dtype
        if self.split is None:
            return nn.functional.linear(merge_heads(ctx),
                                        self.out_proj.weight.to(dt),
                                        self.out_proj.bias.to(dt))
        y = nn.functional.linear(merge_heads(ctx),
                                 self.out_proj.weight.to(dt))
        return leave_split(y, self.split) + self.out_proj.bias.to(dt)
