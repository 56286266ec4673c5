"""Audio conv encoder (counterpart: ``bpx/ops/audio.py``).

Two VALID strided Conv1d layers and an adaptive average pool, on
time-major ``(B, T, C)`` streams.  The convolutions go to
``F.conv1d``: the JAX package leaves them to XLA as well (no TPU kernel).
The pool is a static (T_out, T_in) averaging matrix with torch's
``AdaptiveAvgPool1d`` bins (bin i averages ``[floor(i*L/out),
ceil((i+1)*L/out))``); at moviescope it up-samples 137 frames to 200.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from bpx_torch.ops.init import lecun_normal_

AUDIO_ENCODER_VARIANTS = {
    # name -> (channels, kernel, stride); the pool target is num_vectors_a
    "moviescope": (96, 128, 2),
    "cmumosei": (74, 5, 2),
    "cmumosi": (5, 20, 1),
}


def adaptive_avg_pool_matrix_np(t_in: int, t_out: int) -> np.ndarray:
    """(t_out, t_in) float64 matrix M with M @ x == AdaptiveAvgPool1d(x)."""
    m = np.zeros((t_out, t_in), dtype=np.float64)
    for i in range(t_out):
        start = (i * t_in) // t_out
        end = -(-((i + 1) * t_in) // t_out)      # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


@functools.lru_cache(maxsize=16)
def adaptive_avg_pool_matrix(t_in: int, t_out: int, dtype: torch.dtype,
                             device: torch.device) -> torch.Tensor:
    # a normal tensor even when first built under inference_mode (serving),
    # so that a later training forward may save it for the backward
    with torch.inference_mode(False):
        return torch.as_tensor(adaptive_avg_pool_matrix_np(t_in, t_out),
                               dtype=dtype, device=device)


def adaptive_avg_pool1d(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """(B, T, C) -> (B, t_out, C) via the static pooling matrix."""
    t_in = x.shape[1]
    if t_in == t_out:
        return x
    return torch.matmul(adaptive_avg_pool_matrix(t_in, t_out, x.dtype,
                                                 x.device), x)


class Conv1d(nn.Module):
    """VALID Conv1d on (B, T, C) with a torch (Cout, Cin, K) weight,
    initialised like flax's ``lecun_normal`` over a (K, Cin, Cout) kernel."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 dtype: torch.dtype, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        lecun_normal_(self.weight, kernel_size * cin, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = nn.functional.conv1d(x.to(dt).transpose(1, 2),
                                 self.weight.to(dt), self.bias.to(dt),
                                 stride=self.stride)
        return y.transpose(1, 2)


class AudioEncoder(nn.Module):
    """Two strided Conv1d layers (channels == in-channels) + adaptive pool
    to ``pool_target`` frames."""

    def __init__(self, channels: int, kernel_size: int, stride: int,
                 pool_target: int, dtype: torch.dtype = torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.pool_target = pool_target
        self.conv1 = Conv1d(channels, channels, kernel_size, stride, dtype,
                            gen, device)
        self.conv2 = Conv1d(channels, channels, kernel_size, stride, dtype,
                            gen, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, C) -> (B, pool_target, C)."""
        t = x.shape[1]
        min_t = self.kernel_size + self.stride * (self.kernel_size - 1) + 1
        if t < min_t:
            raise ValueError(
                f"audio stream of {t} frames is too short for two "
                f"Conv1d(k={self.kernel_size}, s={self.stride}) layers; "
                f"need >= {min_t} (set data.audio_raw_len accordingly)")
        x = self.conv2(self.conv1(x))
        return adaptive_avg_pool1d(x, self.pool_target)


def make_audio_encoder(variant: str, channels: int, pool_target: int,
                       dtype=torch.float32, gen=None,
                       device=None) -> AudioEncoder:
    if variant not in AUDIO_ENCODER_VARIANTS:
        raise KeyError(f"unknown audio encoder variant {variant!r}")
    _, kernel, stride = AUDIO_ENCODER_VARIANTS[variant]
    return AudioEncoder(channels, kernel, stride, pool_target, dtype, gen,
                        device)
