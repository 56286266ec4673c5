"""Multi-head attention over batch-first streams (counterpart:
``bpx/ops/attention.py::MultiheadAttention``).

q/k/v/out are separate parameters; when the streams alias (q = k = v, or
k = v) their weights are concatenated and applied as one GEMM.  The
projections come out as (B, T, S, H, D) and the (B, H, T, D) views the
flash kernel takes are strided views of that buffer: no transpose is
copied.  q is scaled by ``head_dim**-0.5`` in the compute dtype before the
kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bpx_torch.ops.flash_attention import flash_attention
from bpx_torch.ops.init import linear


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


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D); free on the flash kernel's output."""
    B, H, T, D = ctx.shape
    return ctx.transpose(1, 2).reshape(B, T, H * D)


class MultiheadAttention(nn.Module):
    """Call with ``query`` only for self-attention, or ``query, key,
    value`` for cross-attention; ``masked`` applies the offset band."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must be divisible by num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = self.head_dim ** -0.5
        self.dtype = dtype
        proj = lambda: linear(embed_dim, embed_dim, True, "xavier", gen, device)
        self.q_proj = proj()
        self.k_proj = proj()
        self.v_proj = proj()
        self.out_proj = proj()

    def forward(self, query: torch.Tensor,
                key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                masked: bool = False) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        H, dt = self.num_heads, self.dtype
        if key is query and value is query:
            q, k, v = fused_projection(
                query, (self.q_proj, self.k_proj, self.v_proj), H, dt)
        elif value is key:
            (q,) = fused_projection(query, (self.q_proj,), H, dt)
            k, v = fused_projection(key, (self.k_proj, self.v_proj), H, dt)
        else:
            (q,) = fused_projection(query, (self.q_proj,), H, dt)
            (k,) = fused_projection(key, (self.k_proj,), H, dt)
            (v,) = fused_projection(value, (self.v_proj,), H, dt)
        q = q * torch.tensor(self.scaling, dtype=dt)
        ctx = flash_attention(q, k, v, masked=masked)
        return nn.functional.linear(merge_heads(ctx),
                                    self.out_proj.weight.to(dt),
                                    self.out_proj.bias.to(dt))
