"""Environment-variable knobs (counterpart: ``bpx/utils/env.py``).

Every ``BPX_*`` boolean knob reads the same convention through
:func:`env_flag`: unset -> the knob's default; ``"0"`` -> off; anything
else -> on.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: bool) -> bool:
    """Boolean ``BPX_*`` knob: unset -> ``default``, "0" -> False,
    any other value -> True."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val != "0"
