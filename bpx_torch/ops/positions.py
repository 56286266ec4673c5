"""Sinusoidal positional embeddings with padding-aware position ids.

The tensor2tensor table ``[sin(p*f) | cos(p*f)]`` (concatenated, not
interleaved), and position ids keyed off feature channel 0: a step whose
channel 0 equals 0.0 is padding and gets the all-zero row 0, the step at
index ``j`` otherwise gets ``j + 1``.  The counterpart is
``bpx/ops/positions.py``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def sinusoidal_table_np(num_embeddings: int, embedding_dim: int,
                        padding_idx: int | None = 0) -> np.ndarray:
    """The table in float64 on the host; row ``padding_idx`` is zero."""
    half_dim = embedding_dim // 2
    if half_dim > 1:
        freq = np.exp(np.arange(half_dim, dtype=np.float64)
                      * -(math.log(10000) / (half_dim - 1)))
    else:
        freq = np.ones((half_dim,), dtype=np.float64)
    angles = np.arange(num_embeddings, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(angles), np.cos(angles)], axis=1)
    if embedding_dim % 2 == 1:
        table = np.concatenate(
            [table, np.zeros((num_embeddings, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx, :] = 0.0
    return table


@functools.lru_cache(maxsize=64)
def sinusoidal_table(num_embeddings: int, embedding_dim: int,
                     dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The table in ``dtype`` on ``device``, built once per shape."""
    table = sinusoidal_table_np(num_embeddings, embedding_dim)
    return torch.as_tensor(table, dtype=dtype, device=device)


def padding_aware_positions(channel0: torch.Tensor) -> torch.Tensor:
    """(B, T) channel-0 values -> int64 position ids (0 for pad steps)."""
    T = channel0.shape[1]
    pos = torch.arange(1, T + 1, device=channel0.device)[None, :]
    return torch.where(channel0 == 0.0, torch.zeros_like(pos), pos)


def positional_embedding(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """(B, T, E) lookup keyed off channel 0 of ``x``; the table is built in
    ``dtype`` (default: x's dtype), as the JAX package builds it."""
    B, T, E = x.shape
    table = sinusoidal_table(T + 1, E, dtype or x.dtype, x.device)
    return table[padding_aware_positions(x[:, :, 0])]
