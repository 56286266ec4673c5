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

Seeds per seed (the vmapped multi-seed step, ``train/multiseed.py``): under
``torch.func.vmap`` the forward's Python runs once for all S seeds, so one
stream would give every seed the same masks.  :class:`SeedStreams` holds S
streams and gives each site the S seeds as a host list, seed s's entry
exactly what ``SeedStream(base_s)`` gives; :func:`hash_dropout` takes such a
list under vmap and masks slice s of the seed axis with seed s.  The
stream also carries the seed axis itself (``axis``, an empty tensor of
S rows mapped over by the vmap), so that a site whose input does not
depend on the per-seed weights, which vmap would hand over unbatched,
still reaches the per-seed rule.  The seeds never reach the device.

Placement (the sharded step, ``bpx_torch/parallel``): a rank of a mesh
holds a block of each global tensor, some of the batch's rows and, under a
tensor split, some heads or feature columns.  The JAX package hashes the
global tensor's linear index under GSPMD, so the port hashes each element
of a block at its index in the global tensor: ``place`` gives, per dim,
None (the whole dim) or ``(offset, global size)``.  A stream carries the
rows of the batch its rank holds (:attr:`SeedStream.rows`) and every site
places its tensor's batch dim with them: dim 0, or dim 1 of a grouped
pair's (2, B, ...) stacks (``batch_dim``), whose global tensor is (2,
B_g, ...); a site on a feature-split tensor adds its column offset and
global width (``split``).  Without placement the index is
``arange(numel)``, as before.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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


#: a block's place in its global tensor: per dim None or (offset, size)
Place = Optional[Tuple[Optional[Tuple[int, int]], ...]]


def global_index(shape, place: Place = None, device=None) -> torch.Tensor:
    """Each element's linear index in the global tensor of which a
    ``shape`` block sits at ``place`` (int64, flat); ``arange(numel)``
    without a place."""
    if place is None or all(p is None for p in place):
        n = 1
        for d in shape:
            n *= d
        return torch.arange(n, dtype=torch.int64, device=device)
    if len(place) != len(shape):
        raise ValueError(f"place {place} for a tensor of {len(shape)} dims")
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(shape))):
        off, size = place[d] if place[d] is not None else (0, shape[d])
        if off < 0 or off + shape[d] > size:
            raise ValueError(f"dim {d}: {shape[d]} from {off} exceeds the "
                             f"global {size}")
        ar = torch.arange(off, off + shape[d], dtype=torch.int64,
                          device=device)
        idx = idx + ar.view(-1, *([1] * (len(shape) - 1 - d))) * stride
        stride *= size
    return idx.reshape(-1)


def hash_keep(seed: int, shape, rate: float, device=None,
              place: Place = None) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask of ``shape`` (bool), the JAX package's
    ``_hash_keep``: murmur3 finalizer over the linear index plus ``seed``;
    with ``place``, the index in the global tensor (:func:`global_index`),
    so a block's mask is the slice of the global mask."""
    x = global_index(shape, place, device) & _M32
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
    """Inverted hash dropout with one uint32 seed (``seeds`` a 1-tuple) or,
    under vmap, one seed per slice of the seed axis.  The backward is the
    same function of the output gradient (the mask is regenerated, not
    saved): with a seed axis it goes through this function again, so that
    it too takes the per-seed rule under ``vmap(grad(...))``."""

    @staticmethod
    def forward(x, axis, rate, seeds, place):
        if len(seeds) != 1:
            raise ValueError(
                f"{len(seeds)} dropout seeds outside torch.func.vmap: a "
                f"seed list masks the slices of a vmapped seed axis")
        return _scale(x, hash_keep(seeds[0], x.shape, rate, x.device, place),
                      rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, axis, rate, seeds, place = inputs
        ctx.rate, ctx.seeds, ctx.place = rate, seeds, place
        ctx.save_for_backward(axis)

    @staticmethod
    def backward(ctx, g):
        (axis,) = ctx.saved_tensors
        if axis is None and len(ctx.seeds) == 1:
            # one seed: its mask, directly (under a vmap, every slice's)
            keep = hash_keep(ctx.seeds[0], g.shape, ctx.rate, g.device,
                             ctx.place)
            return _scale(g, keep, ctx.rate), None, None, None, None
        return (_HashDropout.apply(g, axis, ctx.rate, ctx.seeds, ctx.place),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, axis, rate, seeds, place):
        n = info.batch_size
        if place is not None:
            raise NotImplementedError("placed hash dropout under vmap: the "
                                      "multi-seed step takes no mesh")
        if len(seeds) not in (1, n):
            raise ValueError(f"{len(seeds)} dropout seeds for a vmapped "
                             f"axis of {n}")
        xd = in_dims[0]
        x = x.movedim(xd, 0) if xd is not None else x.expand(n, *x.shape)
        return _SliceDropout.apply(x, rate, seeds * (n // len(seeds))), 0


class _SliceDropout(torch.autograd.Function):
    """Slice s of ``x``'s leading axis through hash dropout with
    ``seeds[s]``: each slice's mask is the one ``hash_keep`` gives that
    seed over the slice's shape.  The vmap rule of :class:`_HashDropout`
    calls it on the unbatched tensor."""

    @staticmethod
    def forward(x, rate, seeds):
        keep = torch.stack([hash_keep(s, x.shape[1:], rate, x.device)
                            for s in seeds])
        return _scale(x, keep, rate)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rate, ctx.seeds = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _SliceDropout.apply(g, ctx.rate, ctx.seeds), None, None


def seed_list(seed: Union[int, Sequence[int], None]) -> Optional[List[int]]:
    """A dropout seed argument as the kernels' ops and :func:`hash_dropout`
    take it: None, or a list of uint32 seeds (an int is a list of one)."""
    if seed is None:
        return None
    seeds = ([int(s) for s in seed] if isinstance(seed, (list, tuple))
             else [int(seed)])
    if not seeds or not all(0 <= s <= _M32 for s in seeds):
        raise ValueError(f"dropout_seed must be a uint32 or a list of "
                         f"them, got {seed}")
    return seeds


def hash_dropout(x: torch.Tensor, rate: float,
                 seed: Union[int, Sequence[int]],
                 axis: Optional[torch.Tensor] = None,
                 place: Place = None) -> torch.Tensor:
    """Inverted dropout with the hash mask; ``seed`` a Python int in
    [0, 2**32), or under ``torch.func.vmap`` a list of one per seed of the
    vmapped axis, with that axis's carrier ``axis``
    (:class:`SeedStreams`).  ``place``: where ``x`` sits in the global
    tensor (:func:`global_index`).  Callers gate on ``rate > 0`` and
    training mode."""
    if seed is None:
        raise ValueError("hash_dropout needs a uint32 seed")
    return _HashDropout.apply(x, axis, float(rate), seed_list(seed), place)


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class SeedStream:
    """Distinct uint32 seeds for the dropout sites of one forward, in call
    order, derived from a uint32 ``base`` (splitmix64 of base and counter).
    ``rows``: ``(offset, global batch)`` of the batch rows the forward's
    inputs hold, on a rank of a mesh; None for the whole batch."""

    #: no seed axis: one stream is one seed
    axis = None

    def __init__(self, base: int, rows: Optional[Tuple[int, int]] = None):
        if not 0 <= base <= _M32:
            raise ValueError(f"base seed must be a uint32, got {base}")
        self.base = base
        self.rows = rows
        self.count = 0

    def next(self) -> int:
        self.count += 1
        return _splitmix64((self.base << 32) | self.count) & _M32

    def at(self, count: int) -> "SeedStream":
        """A stream of the same base whose next seed is the one this
        stream gave after ``count`` draws: a recomputed layer replays its
        first pass's seeds from it (``ops/encoder.py::recomputed``)."""
        stream = SeedStream(self.base, self.rows)
        stream.count = count
        return stream


class SeedStreams:
    """S seed streams drawn in step, one per seed of a vmapped multi-seed
    step: ``next()`` gives each dropout site the S seeds as a host list,
    entry s exactly what ``SeedStream(bases[s])`` gives at that site.
    ``axis`` is the vmapped seed axis's carrier (an empty tensor of S rows
    the vmap maps over), which every site hands to :func:`hash_dropout`."""

    def __init__(self, bases: Sequence[int],
                 axis: Optional[torch.Tensor] = None):
        self.streams = [SeedStream(b) for b in bases]
        self.axis = axis

    #: the multi-seed step holds the whole batch
    rows = None

    def next(self) -> List[int]:
        return [s.next() for s in self.streams]

    @property
    def count(self) -> int:
        """Draws so far, the same for every stream (they draw in step)."""
        return self.streams[0].count

    @count.setter
    def count(self, value: int) -> None:
        for s in self.streams:
            s.count = value

    def at(self, count: int, axis: Optional[torch.Tensor] = None
           ) -> "SeedStreams":
        """Streams of the same bases whose next seeds are the ones these
        gave after ``count`` draws, carried by ``axis`` (default: this
        carrier): a recomputed layer replays its first pass's seeds from
        them, under a vmap of its own (``ops/encoder.py::recomputed``)."""
        streams = SeedStreams([s.base for s in self.streams],
                              self.axis if axis is None else axis)
        streams.count = count
        return streams


def step_seed(run_seed: int, step: int) -> int:
    """The seed of one optimizer step's base-seed generator: splitmix64 of
    (run seed, step), as the JAX package folds the step into its dropout
    key, so a resumed run's step draws the uninterrupted run's seeds."""
    return _splitmix64(((run_seed & _M32) << 32) | (step & _M32))


def draw_base_seed(generator: torch.Generator) -> int:
    """One uint32 base seed from a CPU generator (no device involved)."""
    return int(torch.randint(0, 2 ** 32, (), generator=generator,
                             dtype=torch.int64))


def seed_stream(dropout_seed) -> Union[SeedStream, SeedStreams, None]:
    """A forward's stream from its ``dropout_seed``: a uint32 base seed, or
    a stream handed over as it is (the multi-seed step's
    :class:`SeedStreams`); None stays None."""
    if dropout_seed is None or isinstance(dropout_seed,
                                          (SeedStream, SeedStreams)):
        return dropout_seed
    return SeedStream(dropout_seed)


def block_place(ndim: int, rows: Optional[Tuple[int, int]] = None,
                split: Optional[Tuple[int, int, int]] = None,
                batch_dim: int = 0) -> Place:
    """The place of an ``ndim``-dim block whose batch is dim ``batch_dim``:
    that dim at ``rows`` (offset, global batch), and ``split`` = (dim,
    offset, global size) for a dim a tensor split cuts; None when neither
    is given."""
    if rows is None and split is None:
        return None
    place = [None] * ndim
    if rows is not None:
        place[batch_dim] = tuple(rows)
    if split is not None:
        place[split[0] % ndim] = (split[1], split[2])
    return tuple(place)


def maybe_dropout(x: torch.Tensor, rate: float, training: bool,
                  seeds: Union[SeedStream, SeedStreams, None],
                  split: Optional[Tuple[int, int, int]] = None,
                  batch_dim: int = 0) -> torch.Tensor:
    """``hash_dropout`` in training mode with ``rate > 0``, else ``x``;
    ``x``'s dim ``batch_dim`` (0, or a pair's 1) is placed at the stream's
    ``rows`` and, on a feature-split tensor, ``split`` = (dim, offset,
    global size)."""
    if rate <= 0.0 or not training:
        return x
    if seeds is None:
        raise ValueError("dropout in training mode needs a SeedStream")
    return hash_dropout(x, rate, seeds.next(), seeds.axis,
                        block_place(x.dim(), seeds.rows, split, batch_dim))
