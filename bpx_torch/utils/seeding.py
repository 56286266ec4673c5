"""Determinism hygiene (counterpart: ``bpx/utils/seeding.py``).

Seeds the host RNGs the data pipeline uses (Python's and numpy's global
state) and torch's, and returns the run's own ``torch.Generator``: the
port's explicit counterpart of the JAX package's root PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed ``random``, numpy and torch; return a CPU generator seeded with
    ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
