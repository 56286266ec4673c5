"""The tensor split's collectives, as the model's modules call them.

A module split over the mesh's ``tensor`` dim holds a :class:`TensorSplit`
and enters and leaves its split region through two autograd functions,
Megatron's pair (no counterpart in the JAX package, where GSPMD inserts
the collectives):

* :func:`enter_split` before a column-parallel product: the identity
  forward, and in the backward the all-reduce of the input's gradient,
  each rank's part of it coming from its own output features;
* :func:`leave_split` after a row-parallel product: the all-reduce of the
  ranks' partial sums forward, the identity backward.

Both are the identity without a split.  This module imports no model
code, so the ops can import it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class TensorSplit:
    """A rank's place in its ``tensor`` group: the group, the rank's index
    in it and its size."""

    group: object
    rank: int
    size: int

    def part(self, n: int):
        """(offset, length) of this rank's part of ``n`` split evenly."""
        if n % self.size:
            raise ValueError(f"{n} does not split {self.size} ways")
        length = n // self.size
        return self.rank * length, length


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.split.group)
        return g, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        x = x.contiguous()
        dist.all_reduce(x, group=split.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter_split(x: torch.Tensor, split: Optional[TensorSplit]
                ) -> torch.Tensor:
    """``x`` into a split region: its gradient summed over the group."""
    return x if split is None else _Enter.apply(x, split)


def leave_split(x: torch.Tensor, split: Optional[TensorSplit]
                ) -> torch.Tensor:
    """The ranks' partial sums ``x`` added over the group."""
    return x if split is None else _Leave.apply(x, split)


def all_reduce_over(x: torch.Tensor, groups: Sequence[object]
                    ) -> torch.Tensor:
    """``x`` summed in place over each process group of ``groups`` in turn
    (the sum over their product when they are a mesh's dims)."""
    for group in groups:
        dist.all_reduce(x, group=group)
    return x
