"""Precollated feature cache: collate-ready per-split memmaps (counterpart:
``bpx/data/cache.py``).

The direct host path re-unpickles every sample's feature files each epoch
and re-pads them into batch arrays.  Here each key of
:func:`bpx_torch.data.collate.collate`'s output becomes an ``(N, ...)``
on-disk memmap built once (first use), and batch assembly becomes one
fancy-index gather per stream.

Layout: ``<jsonl dir>/.bpx_cache/<split>_<digest>/{key}.npy`` +
``meta.json``, the JAX package's layout and digest (so either package
reads a cache the other built).  The digest covers the jsonl's identity
(size + mtime) and every shape-determining config field, so a stale cache
misses and rebuilds; builds are atomic (tmp dir + ``os.replace``), so
concurrent jobs can share one cache: the loser of the rename race reads the
winner's copy.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np

from bpx_torch.config import DataConfig, ModelConfig
from bpx_torch.data.collate import collate


def _digest(jsonl_path: str, data_cfg: DataConfig,
            model_cfg: ModelConfig, n_classes: int) -> str:
    st = os.stat(jsonl_path)
    key = json.dumps({
        "size": st.st_size, "mtime": int(st.st_mtime),
        "task": data_cfg.task, "task_type": data_cfg.task_type,
        "visual": data_cfg.visual,
        "max_seq_len": data_cfg.max_seq_len,
        "video_len": data_cfg.video_len,
        "audio_raw_len": data_cfg.audio_raw_len,
        "orig_d_v": model_cfg.orig_d_v, "orig_d_a": model_cfg.orig_d_a,
        "orig_d_p": model_cfg.orig_d_p, "n_classes": n_classes,
        "vocab": data_cfg.bert_vocab_path or "",
    }, sort_keys=True)
    return hashlib.sha1(key.encode()).hexdigest()[:16]


class PrecollatedStore:
    """Collate-ready per-split arrays, memmapped from disk."""

    def __init__(self, path: str, meta: Dict):
        self.path = path
        self.meta = meta
        self.arrays: Dict[str, np.ndarray] = {}
        for key in meta["keys"]:
            self.arrays[key] = np.load(os.path.join(path, f"{key}.npy"),
                                       mmap_mode="r")

    def __len__(self) -> int:
        return int(self.meta["n"])

    def gather(self, indices) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        # fancy-indexing a memmap materializes an in-memory batch copy —
        # the only per-step host work left on this path
        return {k: np.ascontiguousarray(a[idx])
                for k, a in self.arrays.items()}

    # -- construction -------------------------------------------------------

    @staticmethod
    def build_or_load(dataset, jsonl_path: str, data_cfg: DataConfig,
                      model_cfg: ModelConfig,
                      log=None) -> Optional["PrecollatedStore"]:
        """Return the split's store, building it on first use.  Any build
        failure (read-only data dir, exotic dtypes) returns None and the
        caller stays on the direct per-sample path (host code: the same
        batches either way)."""
        try:
            digest = _digest(jsonl_path, data_cfg, model_cfg,
                             dataset.n_classes)
            split = os.path.splitext(os.path.basename(jsonl_path))[0]
            root = os.path.join(os.path.dirname(jsonl_path), ".bpx_cache")
            final = os.path.join(root, f"{split}_{digest}")
            meta_path = os.path.join(final, "meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    return PrecollatedStore(final, json.load(f))

            n = len(dataset)
            if n == 0:
                return None
            os.makedirs(root, exist_ok=True)
            tmp = tempfile.mkdtemp(prefix=f".build_{split}_", dir=root)
            if log:
                log("building precollated cache for %s (%d samples) ...",
                    split, n)
            first = collate([dataset[0]], data_cfg, model_cfg)
            writers = {}
            for key, arr in first.items():
                shape = (n,) + arr.shape[1:]
                writers[key] = np.lib.format.open_memmap(
                    os.path.join(tmp, f"{key}.npy"), mode="w+",
                    dtype=arr.dtype, shape=shape)
                writers[key][0] = arr[0]
            for i in range(1, n):
                row = collate([dataset[i]], data_cfg, model_cfg)
                for key, arr in row.items():
                    writers[key][i] = arr[0]
            for w in writers.values():
                w.flush()
            del writers
            meta = {"n": n, "keys": sorted(first.keys()),
                    "digest": digest}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            try:
                os.replace(tmp, final)
            except OSError:
                # lost the build race (non-empty target): read the winner
                shutil.rmtree(tmp, ignore_errors=True)
            with open(meta_path) as f:
                return PrecollatedStore(final, json.load(f))
        except Exception as e:  # the cache is an optimisation, never a failure
            if log:
                log("precollated cache unavailable (%s); using the "
                    "direct path", e)
            return None
