"""Model registry (counterpart: ``bpx/models/__init__.py``), with the JAX
package's ten names: the two BPMulT models, ``mmtrvapt`` and ``mmtrvat``,
and the notebook-era models of ``models/legacy.py`` (``mmtrvpa``,
``tmmtrvpa``, ``gmu``, ``gmu_bi``, ``gmu_hier``, ``gmu_softmax``, and the
text-only baseline as ``bertclf`` and ``bert``)."""

from __future__ import annotations

from functools import partial
from typing import Optional, Union

import torch

from bpx_torch.config import ModelConfig
from bpx_torch.models.bpmult import BPMulTVAPT, BPMulTVAT
from bpx_torch.models.legacy import (BertClf, GMUBimodalClf, GMUClf,
                                     MulTGMUClf, TranslatingMMTGMUClf)

MODELS = {
    "mmtrvapt": BPMulTVAPT,   # 4-input: video, audio, poster, text
    "mmtrvat": BPMulTVAT,     # 3-input: video, audio, text
    # the notebook-era models
    "mmtrvpa": MulTGMUClf,             # MulT + GMU late fusion
    "tmmtrvpa": TranslatingMMTGMUClf,  # Translating MMT + GMU
    "gmu": GMUClf,                     # trimodal GMU classifier
    "gmu_bi": GMUBimodalClf,           # text + video GMU classifier
    "gmu_hier": partial(GMUClf, gmu_variant="hierarchical"),
    "gmu_softmax": partial(GMUClf, gmu_variant="softmax"),
    # the text-only BERT baseline, under both of its names
    "bertclf": BertClf,
    "bert": BertClf,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means "cuda"; asking for CUDA without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bpx_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the host")
    return device


def get_model(config: ModelConfig, device=None, seed: int = 0):
    """The configured model in eval mode on ``device`` (default "cuda"),
    with random weights drawn from ``seed`` (flax initializers'
    distributions).  A trainer calls ``.train()`` on it."""
    if config.model not in MODELS:
        raise KeyError(f"unknown model {config.model!r}; available: "
                       f"{sorted(MODELS)}")
    device = resolve_device(device)
    return MODELS[config.model](config, seed=seed, device=device).eval()
