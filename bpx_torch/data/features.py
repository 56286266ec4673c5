"""Per-task feature-file adapters (counterpart: ``bpx/data/features.py``).

Each adapter reads the reference's on-disk layouts (per-sample pickles,
hdf5, torch .pt pickles) and returns numpy arrays in one orientation:
**time-major, feature-last** ``(T, d)`` for streams, ``(d,)`` for the
poster vector.

Directory layouts handled (relative to the jsonl's directory):
* moviescope: ``200F_VGG16/{id}.p`` video, ``PosterFeatures/{id}.p`` poster,
  ``Melspectrogram/{id}.p`` (orig_d_a==96) or ``MelgramPorcessed/{id}.p``
  with first-4-frame concat;
* mmimdb: ``glove/{id}.p`` as the video slot, ``multimodal_imdb.hdf5``
  ``vgg_features`` via ``indices.pkl`` as the poster, ``BoW/{id}.p`` in the
  audio slot;
* cmu-mosei / iemocap: ``Vision/{split}/{id}.p``, ``Audio/{split}/{id}.p``
  torch pickles;
* cmu-mosi: whole-dataset ``mosi_data.pkl`` indexed by (part, id);
* counseling: ``glove/{id}.p`` + ``fasttext/{id}.p``.

``h5py`` is imported only where mmimdb's hdf5 file is read: it is not
needed by any other task.
"""

from __future__ import annotations

import functools
import os
import pickle
import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch


def _load_pickle(path: str, encoding: str = "bytes"):
    with open(path, "rb") as f:
        return pickle.load(f, encoding=encoding)


def _load_torch(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu").float().numpy()


def _as_time_major(arr: np.ndarray, feat_dim: int) -> np.ndarray:
    """Normalise a 2-D array to (T, feat_dim) given the known feature dim."""
    arr = np.asarray(arr, dtype=np.float32)
    arr = np.squeeze(arr)
    if arr.ndim == 1:
        return arr[:, None] if feat_dim == 1 else arr[None, :]
    if arr.shape[-1] == feat_dim:
        return arr
    if arr.shape[0] == feat_dim:
        return arr.T
    raise ValueError(f"cannot orient array {arr.shape} to feature dim {feat_dim}")


@functools.lru_cache(maxsize=4)
def _mosi_table(path: str):
    return _load_pickle(path, encoding="latin1")


@functools.lru_cache(maxsize=4)
def _imdb_indices(path: str):
    return _load_pickle(path, encoding="ASCII")


_IMDB_H5_CACHE: "OrderedDict" = OrderedDict()
_IMDB_H5_LOCK = threading.Lock()


def _imdb_h5(path: str):
    """Keep the mmimdb HDF5 open across samples (one handle per path, at
    most two open; evicted handles are closed).  h5py serialises HDF5 calls
    under its global lock, so loader threads may share a handle."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading mmimdb's multimodal_imdb.hdf5 needs the h5py package, "
            "which is not installed") from e
    with _IMDB_H5_LOCK:
        f = _IMDB_H5_CACHE.get(path)
        if f is not None and f.id.valid:
            _IMDB_H5_CACHE.move_to_end(path)
            return f
        f = h5py.File(path, "r")
        _IMDB_H5_CACHE[path] = f
        while len(_IMDB_H5_CACHE) > 2:
            _, old = _IMDB_H5_CACHE.popitem(last=False)
            old.close()
        return f


class FeatureAdapter:
    """Loads (video, audio, poster) for one sample of one task."""

    def __init__(self, task: str, data_dir: str, orig_d_v: int,
                 orig_d_a: int, visual: str = "both"):
        self.task = task
        self.data_dir = data_dir
        self.orig_d_v = orig_d_v
        self.orig_d_a = orig_d_a
        self.visual = visual

    # -- video ---------------------------------------------------------------

    def load_video(self, sample: Dict) -> Optional[np.ndarray]:
        if self.visual not in ("video", "both"):
            return None
        sid = str(sample["id"])
        d = self.data_dir
        if self.task == "moviescope":
            data = _load_pickle(os.path.join(d, "200F_VGG16", f"{sid}.p"))
            return _as_time_major(data, self.orig_d_v)
        if self.task in ("mmimdb", "counseling"):
            data = _load_pickle(os.path.join(d, "glove", f"{sid}.p"),
                                encoding="ASCII")["glove"]
            return _as_time_major(data, self.orig_d_v)
        if self.task in ("cmu-mosei", "iemocap"):
            data = _load_torch(os.path.join(d, "Vision",
                                            str(sample["task"]), f"{sid}.p"))
            return _as_time_major(data, self.orig_d_v)
        if self.task == "cmu-mosi":
            table = _mosi_table(os.path.join(d, "mosi_data.pkl"))
            data = np.array(table[sample["part"]]["vision"][sample["id"]],
                            dtype=np.float32)
            return _as_time_major(data, self.orig_d_v)
        raise KeyError(self.task)

    # -- audio ---------------------------------------------------------------

    def load_audio(self, sample: Dict) -> Optional[np.ndarray]:
        sid = str(sample["id"])
        d = self.data_dir
        if self.task == "moviescope":
            if self.orig_d_a == 96:
                data = _load_pickle(os.path.join(d, "Melspectrogram",
                                                 f"{sid}.p"))
                # stored (96 mel bins, T) -> (T, 96)
                return _as_time_major(data, self.orig_d_a)
            data = _load_pickle(os.path.join(d, "MelgramPorcessed",
                                             f"{sid}.p"))
            data = np.squeeze(np.asarray(data, dtype=np.float32), 0)
            # first 4 frames concatenated on time
            data = np.concatenate(list(data[:4]), axis=1)
            return _as_time_major(data, self.orig_d_a)
        if self.task in ("cmu-mosei", "iemocap"):
            data = _load_torch(os.path.join(d, "Audio",
                                            str(sample["task"]), f"{sid}.p"))
            return _as_time_major(data, self.orig_d_a)
        if self.task == "cmu-mosi":
            table = _mosi_table(os.path.join(d, "mosi_data.pkl"))
            data = np.array(table[sample["part"]]["audio"][sample["id"]],
                            dtype=np.float32)
            return _as_time_major(data, self.orig_d_a)
        if self.task == "mmimdb":
            data = _load_pickle(os.path.join(d, "BoW", f"{sid}.p"),
                                encoding="ASCII")["bow"]
            # BoW vector rides the audio slot: (T=bow_dim, 1)
            return np.asarray(data, dtype=np.float32).reshape(-1, 1)
        if self.task == "counseling":
            data = _load_pickle(os.path.join(d, "fasttext", f"{sid}.p"),
                                encoding="ASCII")["fastText"]
            return _as_time_major(data, self.orig_d_a)
        raise KeyError(self.task)

    # -- poster --------------------------------------------------------------

    def load_poster(self, sample: Dict) -> Optional[np.ndarray]:
        if self.visual not in ("poster", "both"):
            return None
        sid = str(sample["id"])
        d = self.data_dir
        if self.task == "moviescope":
            data = _load_pickle(os.path.join(d, "PosterFeatures", f"{sid}.p"))
            return np.asarray(data, dtype=np.float32).reshape(-1)
        if self.task == "mmimdb":
            ind = _imdb_indices(os.path.join(d, "indices.pkl"))
            f = _imdb_h5(os.path.join(d, "multimodal_imdb.hdf5"))
            data = f["vgg_features"][ind[sample["id"]]]
            return np.asarray(data, dtype=np.float32).reshape(-1)
        return None
