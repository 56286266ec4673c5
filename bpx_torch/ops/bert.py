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
their residual LNs.  ``remat`` recomputes each layer in the backward
(``ops/encoder.py::recomputed``), as the JAX package's ``remat`` does.
Under a tensor split (``bpx_torch/parallel/sharding.py``) a layer keeps
its rank's heads of ``query/key/value`` and rows of ``intermediate``
(column-parallel) and its columns of ``attention_output`` and ``output``
(row-parallel), whose partial sums are added over the ``tensor`` group
before the bias: the hidden dropout after them sees full rows.
``with_pooler`` adds Hugging Face's pooler, ``pooler`` (a Dense with bias,
flax's default init), and the forward then returns ``(hidden, tanh(W
hidden[:, 0] + b))``: the [CLS] summary of the notebook-era classifiers.

:func:`load_hf_bert_params` and :func:`maybe_load_pretrained` carry a local
Hugging Face checkpoint (BERT or DistilBERT layout; ``pytorch_model.bin`` or
``model.safetensors``) into the encoder's state dict.  No weights are
downloaded; ``.safetensors`` files are read with numpy.  The pooler is not
loaded, as the JAX package's loader does not load it: a model with a
pooler keeps its own ``pooler`` weights.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from bpx_torch.config import BertConfig
from bpx_torch.ops.attention import (attention_dropout,
                                     dot_product_attention, flash_place,
                                     fused_projection, merge_heads)
from bpx_torch.ops.dropout import SeedStream, maybe_dropout
from bpx_torch.ops.encoder import recomputed, resolve_remat_policy
from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.init import embed_normal_, linear
from bpx_torch.ops.masks import key_padding_bias
from bpx_torch.ops.norm import LayerNorm
from bpx_torch.parallel.collectives import (TensorSplit, enter_split,
                                            leave_split)


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
    #: the rank's place in the tensor group when the heads (``split``) or
    #: the FFN (``ffn_split``) are split
    split: Optional[TensorSplit] = None
    ffn_split: Optional[TensorSplit] = None

    def __init__(self, cfg: BertConfig, dtype: torch.dtype, gen, device=None,
                 attention_impl: str = "xla"):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.num_heads = cfg.num_heads
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
        q, k, v = fused_projection(enter_split(hidden, self.split),
                                   (a.query, a.key, a.value), self.num_heads,
                                   dt)
        place = flash_place(seeds, self.split, self.num_heads, cfg.num_heads)
        if self.attention_impl == "pallas":
            q = q * torch.tensor(head_dim ** -0.5, dtype=dt)
            ctx = flash_attention(
                q, k, v, False, keys,
                *attention_dropout(cfg.attention_dropout, self.training,
                                   seeds), place=place)
        else:
            ctx = dot_product_attention(
                q, k, v, keys, cfg.attention_dropout, self.training, seeds,
                prescaled=False, heads=None if place is None else place[1:])
        ctx = merge_heads(ctx)
        lin = lambda mod, x: nn.functional.linear(x, mod.weight.to(dt),
                                                  mod.bias.to(dt))

        def row_parallel(mod, x, split):
            if split is None:
                return lin(mod, x)
            return (leave_split(nn.functional.linear(x, mod.weight.to(dt)),
                                split) + mod.bias.to(dt))
        drop = lambda x: maybe_dropout(x, cfg.hidden_dropout, self.training,
                                       seeds)
        hidden = self.attention_norm(
            hidden + drop(row_parallel(self.attention_output, ctx,
                                       self.split)))
        inter = nn.functional.gelu(
            lin(self.intermediate, enter_split(hidden, self.ffn_split)),
            approximate="tanh" if cfg.gelu == "tanh" else "none")
        return self.output_norm(
            hidden + drop(row_parallel(self.output, inter, self.ffn_split)))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None,
                 attention_impl: str = "xla", remat: bool = False,
                 remat_policy: Optional[str] = None,
                 with_pooler: bool = False):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.remat = remat
        self.remat_policy = resolve_remat_policy(remat_policy)
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
        self.with_pooler = with_pooler
        if with_pooler:
            self.pooler = linear(E, E, True, "lecun", gen, device)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                seeds: Optional[SeedStream] = None):
        """The last layer's hidden states (B, T, E); with the pooler,
        ``(hidden, pooled)``, pooled (B, E)."""
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
        recompute = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.layers:
            if recompute:
                hidden = recomputed(layer, self.remat_policy, seeds, hidden,
                                    keys)
            else:
                hidden = layer(hidden, keys, seeds)
        if self.with_pooler:
            p = self.pooler
            pooled = torch.tanh(nn.functional.linear(
                hidden[:, 0], p.weight.to(dt), p.bias.to(dt)))
            return hidden, pooled
        return hidden


# ---------------------------------------------------------------------------
# Hugging Face checkpoint import
# ---------------------------------------------------------------------------

def load_hf_bert_params(state_dict: Mapping, config: BertConfig
                        ) -> Dict[str, torch.Tensor]:
    """:class:`BertEncoder`'s state dict (fp32) from a Hugging Face one.

    Both layouts the reference CLI names (``bert-base-uncased``,
    ``distilbert-base-uncased``) are read, with or without their model
    prefix:

    * BertModel: ``[bert.]encoder.layer.{i}.attention.self.query...``
    * DistilBertModel: ``[distilbert.]transformer.layer.{i}.attention.q_lin...``
      (detected from the keys; pair it with ``BertConfig.distil()``, which
      has no token types).

    Both store ``Linear`` weights as (out, in), the port's layout, so
    nothing is transposed.  Values may be torch tensors or numpy arrays.
    """
    distil = any("transformer.layer." in k for k in state_dict)
    prefixes = ("", "distilbert.") if distil else ("", "bert.")

    def get(name):
        for pre in prefixes:
            if pre + name in state_dict:
                v = state_dict[pre + name]
                if isinstance(v, torch.Tensor):
                    return v.detach().to(torch.float32)
                return torch.from_numpy(np.array(v, dtype=np.float32))
        raise KeyError(name)

    out: Dict[str, torch.Tensor] = {}

    def copy(dst, src):
        out[f"{dst}.weight"] = get(f"{src}.weight")
        out[f"{dst}.bias"] = get(f"{src}.bias")

    out["word_embeddings.weight"] = get("embeddings.word_embeddings.weight")
    out["position_embeddings.weight"] = get(
        "embeddings.position_embeddings.weight")
    if config.use_token_type:
        out["token_type_embeddings.weight"] = get(
            "embeddings.token_type_embeddings.weight")
    copy("embeddings_norm", "embeddings.LayerNorm")
    for i in range(config.num_layers):
        d = f"layers.{i}"
        if distil:
            p = f"transformer.layer.{i}"
            names = {"attention.query": "attention.q_lin",
                     "attention.key": "attention.k_lin",
                     "attention.value": "attention.v_lin",
                     "attention_output": "attention.out_lin",
                     "attention_norm": "sa_layer_norm",
                     "intermediate": "ffn.lin1", "output": "ffn.lin2",
                     "output_norm": "output_layer_norm"}
        else:
            p = f"encoder.layer.{i}"
            names = {"attention.query": "attention.self.query",
                     "attention.key": "attention.self.key",
                     "attention.value": "attention.self.value",
                     "attention_output": "attention.output.dense",
                     "attention_norm": "attention.output.LayerNorm",
                     "intermediate": "intermediate.dense",
                     "output": "output.dense",
                     "output_norm": "output.LayerNorm"}
        for dst, src in names.items():
            copy(f"{d}.{dst}", f"{p}.{src}")
    return out


_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2",
                       "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
                       "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array: an 8-byte
    little-endian header length, a JSON header of name -> dtype, shape and
    byte range, then the raw buffers.  BF16 is widened to fp32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw, dtype = data[begin:end], info["dtype"]
        if dtype == "BF16":
            arr = (np.frombuffer(raw, "<u2").astype(np.uint32)
                   << 16).view(np.float32)
        elif dtype in _SAFETENSORS_DTYPES:
            arr = np.frombuffer(raw, _SAFETENSORS_DTYPES[dtype])
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}, "
                             f"which this reader does not take")
        out[name] = arr.reshape(info["shape"])
    return out


def maybe_load_pretrained(state_dict: Dict[str, torch.Tensor],
                          config: BertConfig,
                          weights_path: Optional[str]
                          ) -> Dict[str, torch.Tensor]:
    """A model's state dict with its ``bert.*`` entries replaced by the
    Hugging Face weights at ``weights_path``: a ``pytorch_model.bin`` or
    ``model.safetensors`` file, or a directory holding one.  Returns the
    state dict unchanged when no checkpoint is found there, as the JAX
    package does."""
    if not weights_path:
        return state_dict
    path = weights_path
    if os.path.isdir(path):
        for cand in ("model.safetensors", "pytorch_model.bin"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
    if not os.path.isfile(path):
        return state_dict
    if path.endswith(".safetensors"):
        hf = read_safetensors(path)
    else:
        hf = torch.load(path, map_location="cpu", weights_only=True)
    new = dict(state_dict)
    for k, v in load_hf_bert_params(hf, config).items():
        new[f"bert.{k}"] = v
    return new
