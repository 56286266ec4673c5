"""Model registry (counterpart: ``bpx/models/__init__.py``): the two BPMulT
models, ``mmtrvapt`` and ``mmtrvat``; the notebook-era models are not
ported yet."""

from __future__ import annotations

from typing import Optional, Union

import torch

from bpx_torch.config import ModelConfig
from bpx_torch.models.bpmult import BPMulTVAPT, BPMulTVAT

MODELS = {
    "mmtrvapt": BPMulTVAPT,   # 4-input: video, audio, poster, text
    "mmtrvat": BPMulTVAT,     # 3-input: video, audio, text
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
        raise NotImplementedError(
            f"model {config.model!r} is not ported yet; ported: "
            f"{sorted(MODELS)} (ROADMAP.md lists the queue)")
    device = resolve_device(device)
    return MODELS[config.model](config, seed=seed, device=device).eval()
