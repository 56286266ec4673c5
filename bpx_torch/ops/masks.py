"""The rectangular offset future-mask of the crossmodal encoders.

For a (Tq, Tk) score matrix, query step ``i`` may attend key steps
``j <= i + |Tk - Tq|``; the square case is the causal mask.  The flash
kernel applies this rule analytically; :func:`band_allowed` is the same rule
as a boolean matrix for the plain versions.
"""

from __future__ import annotations

import torch


def band_allowed(tq: int, tk: int, device=None) -> torch.Tensor:
    """(Tq, Tk) bool: True where ``col <= row + |Tk - Tq|``."""
    offset = abs(tk - tq)
    row = torch.arange(tq, device=device)[:, None]
    col = torch.arange(tk, device=device)[None, :]
    return col <= row + offset
