"""Which version a kernel wrapper computes.

A wrapper launches its kernel for a CUDA tensor and computes its plain
PyTorch version for a CPU tensor; any other device raises.  The only other
way to the plain version is the explicit :func:`plain_versions` context,
with which a caller holds the kernels' path against the plain path on the
same card.  Nothing falls back on its own.
"""

from __future__ import annotations

import contextlib

import torch

_force_plain = False


@contextlib.contextmanager
def plain_versions():
    """Every wrapper computes its plain version inside this context, on any
    device (the kernels' launch counters do not move)."""
    global _force_plain
    prev, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = prev


def use_kernel(x: torch.Tensor) -> bool:
    """True when ``x`` goes to the kernel, False for the plain version."""
    if x.device.type == "cpu" or _force_plain:
        return False
    if x.device.type == "cuda":
        return True
    raise RuntimeError(f"no kernel for tensors on {x.device}")
