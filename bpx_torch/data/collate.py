"""Static-shape batching (counterpart: ``bpx/data/collate.py``).

Every stream is padded/truncated to the static lengths from the config
(text -> ``max_seq_len``, video -> ``video_len``, audio ->
``audio_raw_len``), as the model zero-pads every stream to its
``num_vectors_*`` anyway.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bpx_torch.config import DataConfig, ModelConfig


def _stack_padded(items: List[Dict[str, np.ndarray]], key: str,
                  length: int) -> np.ndarray:
    """Single-copy pad+stack: write each (T, d) item straight into the
    preallocated (B, length, d) fp32 output."""
    d = items[0][key].shape[-1]
    out = np.zeros((len(items), length, d), dtype=np.float32)
    for i, item in enumerate(items):
        arr = item[key][:length]
        out[i, : arr.shape[0]] = arr
    return out


def collate(items: List[Dict[str, np.ndarray]], data_cfg: DataConfig,
            model_cfg: ModelConfig) -> Dict[str, np.ndarray]:
    B = len(items)
    L = data_cfg.max_seq_len

    txt = np.zeros((B, L), dtype=np.int32)
    mask = np.zeros((B, L), dtype=np.int32)
    segment = np.zeros((B, L), dtype=np.int32)
    for i, item in enumerate(items):
        ids = item["txt"][:L]
        txt[i, : len(ids)] = ids
        mask[i, : len(ids)] = 1

    batch: Dict[str, np.ndarray] = {
        "txt": txt, "mask": mask, "segment": segment}

    if "video" in items[0]:
        batch["video"] = _stack_padded(items, "video", data_cfg.video_len)
    if "audio" in items[0]:
        batch["audio"] = _stack_padded(items, "audio",
                                       data_cfg.audio_raw_len)
    if "poster" in items[0]:
        poster = np.stack([item["poster"] for item in items])
        if poster.dtype != np.float32:
            poster = poster.astype(np.float32)
        batch["poster"] = poster

    targets = [item["target"] for item in items]
    if data_cfg.task_type == "multilabel":
        batch["target"] = np.stack(targets).astype(np.float32)
    elif data_cfg.task == "cmu-mosi":
        batch["target"] = np.asarray(targets, dtype=np.float32)
    else:
        batch["target"] = np.asarray(targets, dtype=np.int32)
    return batch
