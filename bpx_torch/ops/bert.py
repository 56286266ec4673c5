"""BERT text encoder (counterpart: ``bpx/ops/bert.py``).

Embeddings (word + learned position + token type) and LayerNorm, then
post-LN layers: fused-QKV self-attention, add & LN, GELU FFN ("erf" or
"tanh" per the config), add & LN.  Returns the last layer's hidden states.
``attention_impl`` chooses the attention as the JAX package's does:
``"pallas"`` the flash kernels with per-sample key lengths ``kv_lens =
mask.sum(-1)`` (padding is a contiguous suffix) and q pre-scaled; anything
else the einsum attention with the additive key-padding bias, its scores
divided by sqrt(head_dim) in fp32.  In training mode: attention dropout (in
the flash kernel, or on the einsum path's probabilities), and hidden
dropout after the embedding LN and on the attention and FFN outputs before
their residual LNs.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bpx_torch.config import BertConfig
from bpx_torch.ops.attention import (attention_dropout,
                                     dot_product_attention, fused_projection,
                                     merge_heads)
from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.init import embed_normal_, linear
from bpx_torch.ops.masks import key_padding_bias
from bpx_torch.ops.norm import LayerNorm


class _Embedding(nn.Module):
    """A ``weight`` table initialised like flax's ``nn.Embed``."""

    def __init__(self, num: int, dim: int, gen, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device))
        embed_normal_(self.weight, gen)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return nn.functional.embedding(ids, self.weight).to(dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, gen, device=None):
        super().__init__()
        E = cfg.hidden_size
        self.query = linear(E, E, True, "lecun", gen, device)
        self.key = linear(E, E, True, "lecun", gen, device)
        self.value = linear(E, E, True, "lecun", gen, device)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype, gen, device=None,
                 attention_impl: str = "xla"):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.attention = BertSelfAttention(cfg, gen, device)
        self.attention_output = linear(E, E, True, "lecun", gen, device)
        self.attention_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)
        self.intermediate = linear(E, cfg.intermediate_size, True, "lecun",
                                   gen, device)
        self.output = linear(cfg.intermediate_size, E, True, "lecun", gen,
                             device)
        self.output_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)

    def forward(self, hidden: torch.Tensor, keys: torch.Tensor,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        """``keys``: the (B,) int32 key lengths for the flash kernels, or
        the (B, 1, 1, T) key-padding bias for the einsum attention."""
        cfg, dt = self.cfg, self.dtype
        head_dim = cfg.hidden_size // cfg.num_heads
        a = self.attention
        q, k, v = fused_projection(hidden, (a.query, a.key, a.value),
                                   cfg.num_heads, dt)
        if self.attention_impl == "pallas":
            q = q * torch.tensor(head_dim ** -0.5, dtype=dt)
            ctx = flash_attention(
                q, k, v, False, keys,
                *attention_dropout(cfg.attention_dropout, self.training,
                                   seeds))
        else:
            ctx = dot_product_attention(q, k, v, keys, cfg.attention_dropout,
                                        self.training, seeds,
                                        prescaled=False)
        ctx = merge_heads(ctx)
        lin = lambda mod, x: nn.functional.linear(x, mod.weight.to(dt),
                                                  mod.bias.to(dt))
        drop = lambda x: maybe_dropout(x, cfg.hidden_dropout, self.training,
                                       seeds)
        hidden = self.attention_norm(
            hidden + drop(lin(self.attention_output, ctx)))
        inter = nn.functional.gelu(
            lin(self.intermediate, hidden),
            approximate="tanh" if cfg.gelu == "tanh" else "none")
        return self.output_norm(hidden + drop(lin(self.output, inter)))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 attention_impl: str = "xla"):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.word_embeddings = _Embedding(cfg.vocab_size, E, gen, device)
        self.position_embeddings = _Embedding(cfg.max_position_embeddings, E,
                                              gen, device)
        if cfg.use_token_type:
            self.token_type_embeddings = _Embedding(cfg.type_vocab_size, E,
                                                    gen, device)
        self.embeddings_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList([
            BertLayer(cfg, dtype, gen, device, attention_impl)
            for _ in range(cfg.num_layers)])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                seeds: Optional[SeedStream] = None) -> torch.Tensor:
        dt = self.dtype
        input_ids = input_ids.long()
        T = input_ids.shape[1]
        pos_ids = torch.arange(T, device=input_ids.device)[None, :]
        hidden = (self.word_embeddings(input_ids, dt)
                  + self.position_embeddings(pos_ids, dt))
        if self.cfg.use_token_type:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            hidden = hidden + self.token_type_embeddings(
                token_type_ids.long(), dt)
        hidden = maybe_dropout(self.embeddings_norm(hidden),
                               self.cfg.hidden_dropout, self.training, seeds)
        if self.attention_impl == "pallas":
            keys = attention_mask.sum(-1).to(torch.int32)
        else:
            keys = key_padding_bias(attention_mask)
        for layer in self.layers:
            hidden = layer(hidden, keys, seeds)
        return hidden
