"""BERT text encoder (counterpart: ``bpx/ops/bert.py``).

Embeddings (word + learned position + token type) and LayerNorm, then
post-LN layers: fused-QKV self-attention through the flash kernel with
per-sample key lengths ``kv_lens = mask.sum(-1)`` (padding is a contiguous
suffix), add & LN, GELU FFN ("erf" or "tanh" per the config), add & LN.
Returns the last layer's hidden states.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bpx_torch.config import BertConfig
from bpx_torch.ops.attention import fused_projection, merge_heads
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.init import embed_normal_, linear
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
    def __init__(self, cfg: BertConfig, dtype: torch.dtype, gen, device=None):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.attention = BertSelfAttention(cfg, gen, device)
        self.attention_output = linear(E, E, True, "lecun", gen, device)
        self.attention_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)
        self.intermediate = linear(E, cfg.intermediate_size, True, "lecun",
                                   gen, device)
        self.output = linear(cfg.intermediate_size, E, True, "lecun", gen,
                             device)
        self.output_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)

    def forward(self, hidden: torch.Tensor,
                kv_lens: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        head_dim = cfg.hidden_size // cfg.num_heads
        a = self.attention
        q, k, v = fused_projection(hidden, (a.query, a.key, a.value),
                                   cfg.num_heads, dt)
        q = q * torch.tensor(head_dim ** -0.5, dtype=dt)
        ctx = merge_heads(flash_attention(q, k, v, masked=False,
                                          kv_lens=kv_lens))
        lin = lambda mod, x: nn.functional.linear(x, mod.weight.to(dt),
                                                  mod.bias.to(dt))
        hidden = self.attention_norm(hidden + lin(self.attention_output, ctx))
        inter = nn.functional.gelu(
            lin(self.intermediate, hidden),
            approximate="tanh" if cfg.gelu == "tanh" else "none")
        return self.output_norm(hidden + lin(self.output, inter))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.word_embeddings = _Embedding(cfg.vocab_size, E, gen, device)
        self.position_embeddings = _Embedding(cfg.max_position_embeddings, E,
                                              gen, device)
        if cfg.use_token_type:
            self.token_type_embeddings = _Embedding(cfg.type_vocab_size, E,
                                                    gen, device)
        self.embeddings_norm = LayerNorm(E, cfg.layer_norm_eps, dtype, device)
        self.layers = nn.ModuleList([BertLayer(cfg, dtype, gen, device)
                                     for _ in range(cfg.num_layers)])

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
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
        hidden = self.embeddings_norm(hidden)
        kv_lens = attention_mask.sum(-1).to(torch.int32)
        for layer in self.layers:
            hidden = layer(hidden, kv_lens)
        return hidden
