"""Hash dropout of the residual, embedding and hidden streams, and the
per-site dropout seeds (counterpart: ``bpx/ops/dropout.py``).

The keep mask is a pure function of (seed, linear element index): a 3-round
murmur3 finalizer over the row-major index plus a uint32 seed, thresholded
at ``min(int(rate * 2**32), 2**32 - 1)``, bit-identical to the JAX package's
``_hash_keep`` for the same seed.  The backward regenerates the mask from
the seed instead of saving it.  torch has no full uint32 arithmetic, so the
hash runs in int64 with every product and sum cut to 32 bits.

This is plain PyTorch on every device: the JAX package computes it with XLA
outside any Pallas kernel, so there is no TPU kernel to port here.

Seeds: the JAX package draws a key per call site with ``make_rng``; those
bits cannot be reproduced without JAX.  The port's training step draws one
base seed per micro-batch from an explicit ``torch.Generator`` and hands the
model a :class:`SeedStream`, which gives every dropout site of the forward,
in call order, a distinct uint32 derived from (base, site counter) in Python:
no device sync per site, and the same generator state gives the same masks.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of a Bernoulli(1 - rate) keep test."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    uint32 ``c``, split in 16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_keep(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask of ``shape`` (bool), the JAX package's
    ``_hash_keep``: murmur3 finalizer over the linear index plus ``seed``."""
    n = 1
    for d in shape:
        n *= d
    x = torch.arange(n, dtype=torch.int64, device=device)
    x = (mul32(x, 0x9E3779B9) + (seed & _M32)) & _M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >= keep_threshold(rate)).reshape(shape)


def _scale(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    # the divisor in x's dtype first, as JAX does with a weakly-typed
    # Python scalar
    div = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


class _HashDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _scale(x, hash_keep(seed, x.shape, rate, x.device), rate)

    @staticmethod
    def backward(ctx, g):
        keep = hash_keep(ctx.seed, g.shape, ctx.rate, g.device)
        return _scale(g, keep, ctx.rate), None, None


def hash_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout with the hash mask; ``seed`` a Python int in
    [0, 2**32).  Callers gate on ``rate > 0`` and training mode."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be a uint32, got {seed}")
    return _HashDropout.apply(x, float(rate), int(seed))


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class SeedStream:
    """Distinct uint32 seeds for the dropout sites of one forward, in call
    order, derived from a uint32 ``base`` (splitmix64 of base and counter)."""

    def __init__(self, base: int):
        if not 0 <= base <= _M32:
            raise ValueError(f"base seed must be a uint32, got {base}")
        self.base = base
        self.count = 0

    def next(self) -> int:
        self.count += 1
        return _splitmix64((self.base << 32) | self.count) & _M32

    def at(self, count: int) -> "SeedStream":
        """A stream of the same base whose next seed is the one this
        stream gave after ``count`` draws: a recomputed layer replays its
        first pass's seeds from it (``ops/encoder.py::recomputed``)."""
        stream = SeedStream(self.base)
        stream.count = count
        return stream


def step_seed(run_seed: int, step: int) -> int:
    """The seed of one optimizer step's base-seed generator: splitmix64 of
    (run seed, step), as the JAX package folds the step into its dropout
    key, so a resumed run's step draws the uninterrupted run's seeds."""
    return _splitmix64(((run_seed & _M32) << 32) | (step & _M32))


def draw_base_seed(generator: torch.Generator) -> int:
    """One uint32 base seed from a CPU generator (no device involved)."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator,
                             dtype=torch.int64))


def maybe_dropout(x: torch.Tensor, rate: float, training: bool,
                  seeds: Optional[SeedStream]) -> torch.Tensor:
    """``hash_dropout`` in training mode with ``rate > 0``, else ``x``."""
    if rate <= 0.0 or not training:
        return x
    if seeds is None:
        raise ValueError("dropout in training mode needs a SeedStream")
    return hash_dropout(x, rate, seeds.next())
