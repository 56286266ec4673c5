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

:class:`GroupedTransformerEncoder` runs two same-shape encoders as one over
(2, B, T, E) stacks, with a leading pair axis of 2 on every parameter (the
JAX package's ``group_encoders``).  On a mesh its dropouts place the
stacks' dim 1 as the batch (``batch_dim``), and its attention's flash call
places each member's rows in that member's part of the global batch
(``PairAttention``).

Under a tensor split (``bpx_torch/parallel/sharding.py``) a layer's
attention holds its rank's heads (``ops/attention.py``) and its FFN
(``ffn_split``) its rank's rows of fc1 (column-parallel) and columns of
fc2 (row-parallel): the ReLU dropout masks the rank's feature columns at
their global index, and fc2's partial sums are added over the ``tensor``
group before its bias and the residual dropout, which sees full rows.  A
pair's layers split the same way on each member's weights (the dims after
the pair axis).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call, vmap
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bpx_torch.ops.attention import MultiheadAttention, merge_heads
from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.init import linear
from bpx_torch.ops.norm import LayerNorm, layer_norm
from bpx_torch.ops.positions import positional_embedding
from bpx_torch.parallel.collectives import (TensorSplit, enter_split,
                                            leave_split)


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


def _checkpoint(fn, policy, *args):
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def recomputed(layer: nn.Module, policy, seeds: Optional[SeedStream],
               *args) -> torch.Tensor:
    """``layer(*args, seeds)`` under ``torch.utils.checkpoint``: what it
    computes is dropped after the forward and recomputed in the backward,
    but for the ops that ``policy`` (:func:`resolve_remat_policy`) saves.

    The replay runs the layer's Python forward again, so it must draw the
    first pass's dropout seeds: the layer draws from a stream of its own
    that starts at ``seeds``' count, and ``seeds`` then moves past the
    seeds the layer drew.  Under the multi-seed step's vmap the layer is
    checkpointed over the seed axis (:class:`_SeedAxisRecompute`)."""
    start = None if seeds is None else seeds.count
    drawn = []
    if torch._C._are_functorch_transforms_active():
        out = _recomputed_over_seeds(layer, policy, seeds, start, drawn,
                                     args)
    else:
        def run(*a):
            own = None if seeds is None else seeds.at(start)
            out = layer(*a, own)
            drawn.append(None if own is None else own.count)
            return out

        out = _checkpoint(run, policy, *args)
    if seeds is not None:
        seeds.count = drawn[0]
    return out


def _recomputed_over_seeds(layer, policy, seeds, start, drawn, args):
    """``recomputed`` inside ``torch.func.vmap`` over the seed axis, where
    ``functional_call`` has swapped the stacked weights into ``layer``.
    The checkpoint cannot sit inside the vmap: its replay runs in the
    backward, outside both, where the layer holds the meta template's
    weights again.  So the weights, the buffers, the inputs and the seed
    axis's carrier cross into :class:`_SeedAxisRecompute` as explicit
    tensors, and its vmap rule checkpoints ``vmap(layer)`` over the
    stacked tensors: the first pass and the replay each run the layer
    under a vmap of their own, with those tensors swapped in."""
    params = dict(layer.named_parameters())
    if not all(torch._C._functorch.is_batchedtensor(p)
               for p in params.values()):
        raise RuntimeError(
            "a layer recomputed under the seed vmap must hold the stacked "
            "weights on every parameter (functional_call's), not the "
            "template's")
    buffers = dict(layer.named_buffers())
    names, n_p, n_b = (list(params) + list(buffers), len(params),
                       len(buffers))
    axis = None if seeds is None else seeds.axis

    def run(*flat):
        own = (None if seeds is None else seeds.at(start) if axis is None
               else seeds.at(start, flat[-1]))
        state = (dict(zip(names[:n_p], flat[:n_p])),
                 dict(zip(names[n_p:], flat[n_p:n_p + n_b])))
        out = functional_call(layer, state, (*flat[n_p + n_b:-1], own))
        drawn.append(None if own is None else own.count)
        return out

    return _SeedAxisRecompute.apply(
        (run, policy), *params.values(), *buffers.values(), *args, axis)


class _SeedAxisRecompute(torch.autograd.Function):
    """A recomputed layer under the seed vmap: only its vmap rule runs.
    That rule receives the stacked tensors and their ``in_dims`` and
    checkpoints ``vmap(run, in_dims)`` over them, with the config's policy:
    autograd records the stacked ops (each kernel op's folded call), and
    the backward replays the vmapped layer from the saved inputs."""

    generate_vmap_rule = False

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, spec, *tensors):
        run, policy = spec
        stacked = lambda *t: vmap(run, in_dims=in_dims[1:])(*t)
        return _checkpoint(stacked, policy, *tensors), 0


class TransformerEncoderLayer(nn.Module):
    _attention = MultiheadAttention
    _norm = LayerNorm
    _linear = staticmethod(linear)
    #: the rank's place in the tensor group when the FFN is split
    ffn_split: Optional[TensorSplit] = None
    #: the dim of the streams that holds the batch
    batch_dim = 0

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
        self.attn = self._attention(embed_dim, num_heads, dtype, gen, device,
                                    attn_dropout, attention_impl)
        self.ln0 = self._norm(embed_dim, dtype=dtype, device=device)
        self.ln1 = self._norm(embed_dim, dtype=dtype, device=device)
        if biprojection:
            self.ln2 = self._norm(embed_dim, dtype=dtype, device=device)
        self.fc1 = self._linear(embed_dim, 4 * embed_dim, True, "xavier", gen,
                                device)
        self.fc2 = self._linear(4 * embed_dim, embed_dim, True, "xavier", gen,
                                device)
        self.dtype = dtype

    def _dense(self, layer: nn.Linear, x: torch.Tensor,
               split: Optional[TensorSplit] = None) -> torch.Tensor:
        """``layer`` on ``x``; with ``split`` a row-parallel product, its
        partial sums added over the group before the bias."""
        dt = self.dtype
        if split is None:
            return nn.functional.linear(x, layer.weight.to(dt),
                                        layer.bias.to(dt))
        return (leave_split(nn.functional.linear(x, layer.weight.to(dt)),
                            split) + layer.bias.to(dt))

    def forward(self, x: torch.Tensor, x_k: Optional[torch.Tensor] = None,
                x_v: Optional[torch.Tensor] = None,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        """``x_v=None`` with ``x_k`` given means "V aliases K", so the
        attention fuses the k/v GEMMs."""
        drop = lambda h, rate, split=None: maybe_dropout(
            h, rate, self.training, seeds, split, self.batch_dim)
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
        split = self.ffn_split
        if split is None:
            h = drop(torch.relu(self._dense(self.fc1, ffn_ln(x))),
                     self.relu_dropout)
            return residual + drop(self._dense(self.fc2, h),
                                   self.res_dropout)
        h = torch.relu(self._dense(self.fc1, enter_split(ffn_ln(x), split)))
        width = h.shape[-1]
        h = drop(h, self.relu_dropout,
                 (-1, split.rank * width, split.size * width))
        return residual + drop(self._dense(self.fc2, h, split),
                               self.res_dropout)


class TransformerEncoder(nn.Module):
    _layer = TransformerEncoderLayer
    _norm = LayerNorm
    #: the dim of the streams that holds the batch
    batch_dim = 0

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
            self._layer(embed_dim, num_heads, attn_mask, biprojection, dtype,
                        gen, device, attn_dropout, relu_dropout, res_dropout,
                        attention_impl)
            for _ in range(layers)])
        self.final_norm = self._norm(embed_dim, dtype=dtype, device=device)

    def _embed(self, x_in: torch.Tensor,
               seeds: Optional[SeedStream]) -> torch.Tensor:
        # the scale is cast to the stream's dtype first, as JAX does with a
        # weakly-typed Python scalar
        x = x_in * torch.tensor(self.embed_scale, dtype=x_in.dtype)
        # positions per sequence: a grouped pair's (2, B, T, E) as (2B, T, E)
        pos = positional_embedding(x_in.reshape(-1, *x_in.shape[-2:]),
                                   dtype=x.dtype)
        x = x + pos.view(x.shape)
        return maybe_dropout(x, self.embed_dropout, self.training, seeds,
                             batch_dim=self.batch_dim)

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


# ---------------------------------------------------------------------------
# grouped pairs: two same-shape encoders as one
# ---------------------------------------------------------------------------

class PairLinear(nn.Module):
    """Two same-shape ``nn.Linear`` layers on a leading pair axis: ``weight``
    (2, out, in), ``bias`` (2, out) or None; each member initialised as
    :func:`~bpx_torch.ops.init.linear` initialises one."""

    def __init__(self, in_f: int, out_f: int, bias: bool, init: str,
                 gen: Optional[torch.Generator], device=None):
        super().__init__()
        members = [linear(in_f, out_f, bias, init, gen, device)
                   for _ in range(2)]
        self.weight = nn.Parameter(torch.stack(
            [m.weight.detach() for m in members]))
        self.bias = (nn.Parameter(torch.stack(
            [m.bias.detach() for m in members])) if bias else None)


def pair_dense(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], dtype: torch.dtype,
               split: Optional[TensorSplit] = None) -> torch.Tensor:
    """(2, ..., in) -> (2, ..., out): member i through ``weight[i]`` and
    ``bias[i]``, one batched GEMM in ``dtype``; with ``split`` a
    row-parallel product, its partial sums added over the group before
    the bias."""
    x2 = x.reshape(2, -1, x.shape[-1]).to(dtype)
    w = weight.to(dtype).transpose(1, 2)
    if split is not None:
        y = leave_split(torch.bmm(x2, w), split)
        if bias is not None:
            y = y + bias.to(dtype)[:, None, :]
    else:
        y = (torch.bmm(x2, w) if bias is None
             else torch.baddbmm(bias.to(dtype)[:, None, :], x2, w))
    return y.view(*x.shape[:-1], weight.shape[1])


class PairLayerNorm(nn.Module):
    """Two LayerNorms on a leading pair axis, ``weight`` and ``bias`` (2,
    dim): one kernel call per member (the kernel takes one weight row),
    the outputs stacked."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(2, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(2, dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([layer_norm(x[i], self.weight[i], self.bias[i],
                                       self.eps, self.dtype)
                            for i in range(2)])


class PairAttention(MultiheadAttention):
    """:class:`MultiheadAttention` over a pair's (2, B, T, E) streams: each
    projection one batched GEMM over the pair axis, the pair folded into
    the batch of one attention call, (2B, H, T, D) strided views of the
    projection's output (no copy).

    Placed (a mesh's rows or heads), the flash call runs as two seed
    groups of B·H blocks sharing the stream's seed, member m's group
    moved on by ``m * B_g * H_g`` global blocks: row b of member m hashes
    as global row ``m * B_g + b_off + b``, the row it is in the
    one-process call over 2·B_g rows.  Under a tensor split each member
    keeps its rank's heads, as :class:`MultiheadAttention` does."""

    _linear = staticmethod(PairLinear)
    members = 2

    def _project(self, x, layers):
        w = torch.cat([l.weight for l in layers], dim=1)
        b = torch.cat([l.bias for l in layers], dim=1)
        y = pair_dense(enter_split(x, self.split), w, b, self.dtype)
        P, B, T, _ = y.shape
        y = y.view(P * B, T, len(layers), self.num_heads, -1)
        return tuple(y[:, :, i].transpose(1, 2) for i in range(len(layers)))

    def _output(self, ctx):
        h = merge_heads(ctx)
        h = h.view(2, h.shape[0] // 2, *h.shape[1:])
        return pair_dense(h, self.out_proj.weight, self.out_proj.bias,
                          self.dtype, self.split)


class PairEncoderLayer(TransformerEncoderLayer):
    _attention = PairAttention
    _norm = PairLayerNorm
    _linear = staticmethod(PairLinear)
    batch_dim = 1

    def _dense(self, layer, x, split=None):
        return pair_dense(x, layer.weight, layer.bias, self.dtype, split)


class GroupedTransformerEncoder(TransformerEncoder):
    """Two same-shape encoders (one ``attn_dropout``) as one: every
    parameter has a leading pair axis of 2 (the JAX package's ``nn.vmap``
    pair, ``bpx/models/bpmult.py``), the inputs are (2, B, T, E) stacks,
    member i of the output is encoder i on member i of the inputs.
    ``remat`` recomputes each layer in full (``remat_policy`` None, as the
    JAX package states for a pair).  Each attention is one call over the
    pair folded into the batch, at the configured ``attention_impl``; in
    training the two members draw distinct dropout masks from the same
    seeds (the flash mask hashes the batch index)."""

    _layer = PairEncoderLayer
    _norm = PairLayerNorm
    batch_dim = 1

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.remat_policy = None
