"""Synthetic dataset for tests and benches (counterpart:
``bpx/data/synthetic.py``).

Deterministic multimodal samples (text ids, video/audio features, poster,
labels) with a learnable signal: the label is a linear function of
per-modality statistics.  Serves the same dict contract as
:class:`bpx_torch.data.dataset.JsonlDataset`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from bpx_torch.config import DataConfig, ModelConfig
from bpx_torch.inputs import _INPUT_KEYS


class SyntheticDataset:
    def __init__(self, data_cfg: DataConfig, model_cfg: ModelConfig,
                 length: int = None, seed: int = None, split: str = "train"):
        self.cfg = data_cfg
        self.mcfg = model_cfg
        self.length = length or data_cfg.synthetic_len
        base = seed if seed is not None else data_cfg.synthetic_seed
        self.seed = base + {"train": 0, "dev": 1, "test": 2}.get(split, 0)
        self.n_classes = model_cfg.n_classes
        rng = np.random.RandomState(self.seed + 999)
        # fixed projection defining the label signal
        self._w_v = rng.randn(model_cfg.orig_d_v, self.n_classes) * 0.5
        self._w_a = rng.randn(model_cfg.orig_d_a, self.n_classes) * 0.5

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        cfg, mcfg = self.cfg, self.mcfg
        rng = np.random.RandomState(self.seed * 100003 + index)
        L = rng.randint(4, cfg.max_seq_len + 1)
        txt = np.concatenate([[2], rng.randint(
            5, mcfg.bert.vocab_size, (L - 1,))]).astype(np.int32)
        t_v = rng.randint(2, cfg.video_len + 1)
        video = rng.randn(t_v, mcfg.orig_d_v).astype(np.float32)
        t_a = rng.randint(max(2, cfg.audio_raw_len // 2),
                          cfg.audio_raw_len + 1)
        audio = rng.randn(t_a, mcfg.orig_d_a).astype(np.float32)

        score = video.mean(0) @ self._w_v + audio.mean(0) @ self._w_a
        if cfg.task_type == "multilabel":
            target = (score > 0).astype(np.float32)
        elif cfg.task == "cmu-mosi":
            target = np.float32(np.tanh(score[0]) * 3)
        else:
            target = np.int32(np.argmax(score))

        item = {"txt": txt, "video": video, "audio": audio, "target": target}
        if mcfg.use_poster:
            item["poster"] = rng.randn(mcfg.orig_d_p).astype(np.float32)
        return item


def synthetic_label_freqs(n_classes: int):
    """Uniform label frequencies for the synthetic task."""
    return list(range(n_classes)), {i: 1 for i in range(n_classes)}


def example_batch(exp, batch: int) -> Dict[str, np.ndarray]:
    """One collated device-shaped batch made from the config's shapes
    alone (no data files), the JAX package's ``example_batch``: the same
    arrays from ``RandomState(0)``.  The export CLI traces the serving
    forward on it."""
    mc, dc = exp.model, exp.data
    rng = np.random.RandomState(0)
    L = dc.max_seq_len
    streams = {
        "txt": rng.randint(1, mc.bert.vocab_size, (batch, L)).astype(np.int32),
        "mask": np.ones((batch, L), np.int32),
        "segment": np.zeros((batch, L), np.int32),
        "video": rng.randn(batch, dc.video_len,
                           mc.orig_d_v).astype(np.float32),
        "audio": rng.randn(batch, dc.audio_raw_len,
                           mc.orig_d_a).astype(np.float32),
        "poster": rng.randn(batch, mc.orig_d_p).astype(np.float32),
    }
    out = {k: streams[k] for k in _INPUT_KEYS[mc.model]}
    if dc.task == "cmu-mosi":
        out["target"] = rng.randn(batch).astype(np.float32)
    elif dc.task_type == "multilabel":
        out["target"] = (rng.rand(batch, mc.n_classes)
                         > 0.5).astype(np.float32)
    else:
        out["target"] = rng.randint(0, mc.n_classes, batch).astype(np.int32)
    return out
