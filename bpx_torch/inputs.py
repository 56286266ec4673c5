"""Model input order per model name (the port's copy of the JAX package's
``bpx/train/steps.py::_INPUT_KEYS``)."""

from __future__ import annotations

from typing import Dict

_INPUT_KEYS = {
    "mmtrvapt": ("txt", "mask", "segment", "video", "audio", "poster"),
    "mmtrvat": ("txt", "mask", "segment", "video", "audio"),
    "mmtrvpa": ("txt", "mask", "segment", "video", "audio"),
    "tmmtrvpa": ("txt", "mask", "segment", "video", "audio"),
    "gmu": ("txt", "mask", "segment", "video", "audio"),
    "gmu_bi": ("txt", "mask", "segment", "video"),
    "gmu_hier": ("txt", "mask", "segment", "video", "audio"),
    "gmu_softmax": ("txt", "mask", "segment", "video", "audio"),
    "bertclf": ("txt", "mask", "segment"),
    "bert": ("txt", "mask", "segment"),
}


def model_inputs(model_name: str, batch: Dict):
    return tuple(batch[k] for k in _INPUT_KEYS[model_name])
