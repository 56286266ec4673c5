"""Attention masks (counterpart: ``bpx/ops/masks.py``).

The rectangular offset future-mask of the crossmodal encoders: for a
(Tq, Tk) score matrix, query step ``i`` may attend key steps
``j <= i + |Tk - Tq|``; the square case is the causal mask.  The flash
kernel applies this rule analytically; :func:`band_allowed` is the same rule
as a boolean matrix for the plain versions, :func:`band_bias` as the
additive bias of the einsum attention.  BERT's key padding on that path is
:func:`key_padding_bias`.
"""

from __future__ import annotations

import torch


def band_allowed(tq: int, tk: int, device=None) -> torch.Tensor:
    """(Tq, Tk) bool: True where ``col <= row + |Tk - Tq|``."""
    offset = abs(tk - tq)
    row = torch.arange(tq, device=device)[:, None]
    col = torch.arange(tk, device=device)[None, :]
    return col <= row + offset


def band_bias(tq: int, tk: int, device=None) -> torch.Tensor:
    """Additive (Tq, Tk) fp32 bias: 0 where allowed, -inf above the offset
    diagonal (``offset_future_mask``)."""
    return torch.zeros(tq, tk, device=device).masked_fill(
        ~band_allowed(tq, tk, device), float("-inf"))


def key_padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) 1/0 validity mask -> additive (B, 1, 1, Tk) fp32 bias, -inf
    at padding (``key_padding_bias``)."""
    bias = torch.zeros(mask.shape, device=mask.device).masked_fill(
        ~mask.bool(), float("-inf"))
    return bias[:, None, None, :]
