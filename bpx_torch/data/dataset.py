"""Jsonl dataset (counterpart: ``bpx/data/dataset.py``).

Reads a ``{split}.jsonl`` of ``{"id", "synopsis"|"text", "label", ...}``
records, tokenizes text to ``[CLS]``-prefixed wordpiece ids and loads
per-sample features through :class:`bpx_torch.data.features.FeatureAdapter`.
Everything is numpy; batching and static padding happen in
:mod:`bpx_torch.data.collate`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from bpx_torch.config import DataConfig, ModelConfig
from bpx_torch.data.features import FeatureAdapter


class JsonlDataset:
    def __init__(self, data_path: str, tokenizer, labels: Sequence,
                 data_cfg: DataConfig, model_cfg: ModelConfig,
                 data_list: Optional[List[Dict]] = None):
        if data_list is not None:
            self.data = data_list
        else:
            with open(data_path) as f:
                self.data = [json.loads(line) for line in f]
        self.data_dir = os.path.dirname(data_path)
        self.tokenizer = tokenizer
        self.labels = list(labels)
        self.n_classes = len(self.labels)
        self.cfg = data_cfg
        self.model_cfg = model_cfg
        self.features = FeatureAdapter(
            data_cfg.task, self.data_dir, model_cfg.orig_d_v,
            model_cfg.orig_d_a, data_cfg.visual)

    def __len__(self):
        return len(self.data)

    def _text_ids(self, sample: Dict) -> List[int]:
        text = sample.get("synopsis", sample.get("text", ""))
        return self.tokenizer.encode(text, self.cfg.max_seq_len)

    def _label(self, sample: Dict):
        if self.cfg.task_type == "multilabel":
            vec = np.zeros((self.n_classes,), dtype=np.float32)
            label = sample["label"]
            if isinstance(label, list):
                for tgt in label:
                    vec[self.labels.index(tgt)] = 1.0
            else:
                vec[self.labels.index(label)] = 1.0
            return vec
        if self.cfg.task == "cmu-mosi":
            return np.float32(sample["label"])
        return np.int32(self.labels.index(sample["label"]))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = self.data[index]
        item: Dict[str, np.ndarray] = {
            "txt": np.asarray(self._text_ids(sample), dtype=np.int32),
            "target": self._label(sample),
        }
        video = self.features.load_video(sample)
        if video is not None:
            item["video"] = video
        audio = self.features.load_audio(sample)
        if audio is not None:
            item["audio"] = audio
        poster = self.features.load_poster(sample)
        if poster is not None:
            item["poster"] = poster
        return item
