"""The flax initializers' distributions, drawn from a seeded generator.

Random weights of the port follow the JAX package's initializers so that
activations at full width sit at the scale they have there.  Fans are
computed from the JAX (in, out) layout of each kernel.  Draws differ from
JAX's (another generator), the distributions do not.
"""

from __future__ import annotations

import math

import torch

# standard deviation of a unit normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _skip(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    if _skip(t):
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, fan_in: int, fan_out: int,
                    gen: torch.Generator):
    """flax ``xavier_uniform``: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    if _skip(t):
        return t
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=gen)


@torch.no_grad()
def embed_normal_(t: torch.Tensor, gen: torch.Generator):
    """flax ``nn.Embed`` default: normal with variance 1 / features."""
    if _skip(t):
        return t
    return t.normal_(0.0, math.sqrt(1.0 / t.shape[-1]), generator=gen)


def linear(in_f: int, out_f: int, bias: bool, init: str,
           gen: torch.Generator, device=None) -> torch.nn.Linear:
    """An ``nn.Linear`` initialised like a flax Dense with a (in, out)
    kernel: ``init`` is "lecun" or "xavier"; the bias is zero."""
    layer = torch.nn.Linear(in_f, out_f, bias=bias, device=device)
    if init == "lecun":
        lecun_normal_(layer.weight, in_f, gen)
    elif init == "xavier":
        xavier_uniform_(layer.weight, in_f, out_f, gen)
    else:
        raise ValueError(f"unknown init {init!r}")
    if bias and not _skip(layer.bias):
        torch.nn.init.zeros_(layer.bias)
    return layer
