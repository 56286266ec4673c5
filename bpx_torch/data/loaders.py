"""Loader factory, batch iteration and host prefetch (counterpart:
``bpx/data/loaders.py``).

* label/vocab metadata returns in a :class:`DataMeta` record;
* static-shape collate (see :mod:`bpx_torch.data.collate`);
* a background thread assembles batches ahead of the consumer.  It only
  builds numpy arrays: the training loop moves each batch to the device on
  its own thread, so only the main thread touches CUDA.

Epoch order: ``RandomState(seed + epoch)`` shuffles, with ``epoch`` counted
per ``__iter__`` (a started-and-abandoned iteration counts too, as in the
JAX package).  Cross-validation splits: the k-th 80/20 partition with 10%
of train held out as test, the JAX package's arithmetic.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from bpx_torch.config import DataConfig, ModelConfig
from bpx_torch.data.cache import PrecollatedStore
from bpx_torch.data.collate import collate
from bpx_torch.data.dataset import JsonlDataset
from bpx_torch.data.synthetic import SyntheticDataset, synthetic_label_freqs
from bpx_torch.data.tokenization import build_tokenizer
from bpx_torch.data.vocab import Vocab


@dataclass
class DataMeta:
    """Dataset metadata: labels, their frequencies in train, vocab."""
    labels: List[Any]
    label_freqs: Dict[Any, int]
    n_classes: int
    vocab: Vocab
    vocab_sz: int
    train_data_len: int = 0


def get_labels_and_frequencies(path: str) -> Tuple[List[Any], Counter]:
    """Scan train.jsonl for the label set + frequencies."""
    label_freqs = Counter()
    with open(path) as f:
        data_labels = [json.loads(line)["label"] for line in f]
    if data_labels and isinstance(data_labels[0], list):
        for row in data_labels:
            label_freqs.update(row)
    else:
        label_freqs.update(data_labels)
    return list(label_freqs.keys()), label_freqs


class BatchIterator:
    """Epoch iterator: shuffle, fixed batch size, optional drop_last, static
    collate; ``prefetch`` batches assembled ahead on a worker thread."""

    def __init__(self, dataset, data_cfg: DataConfig, model_cfg: ModelConfig,
                 batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 prefetch: int = 2, n_workers: int = 0, store=None):
        self.dataset = dataset
        self.data_cfg = data_cfg
        self.model_cfg = model_cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        # item-loading thread pool (feature unpickling is file IO that
        # releases the GIL)
        self.n_workers = n_workers
        self._pool = None
        # precollated memmap store (bpx_torch.data.cache): batches assemble
        # by fancy-index gather instead of item loads + collate
        self.store = store
        self.epoch = 0

    def _load_items(self, indices):
        if self.n_workers and len(indices) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(max_workers=self.n_workers)
            return list(self._pool.map(
                lambda j: self.dataset[int(j)], indices))
        return [self.dataset[int(j)] for j in indices]

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def _assemble(self, chunk) -> Dict[str, np.ndarray]:
        if self.store is not None:
            return self.store.gather(chunk)
        items = self._load_items(chunk)
        return collate(items, self.data_cfg, self.model_cfg)

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._index_order()
        n_full = len(idx) // self.batch_size
        ends = n_full * self.batch_size
        for i in range(n_full):
            chunk = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield self._assemble(chunk)
        if not self.drop_last and ends < len(idx):
            # final partial batch padded to full size by wrapping (static
            # shapes); callers use `valid` to mask padded rows.
            chunk = list(idx[ends:])
            valid = len(chunk)
            while len(chunk) < self.batch_size:
                chunk.append(idx[len(chunk) % max(ends, 1) if ends else 0])
            batch = self._assemble(chunk)
            batch["valid"] = np.arange(self.batch_size) < valid
            yield batch

    def __iter__(self):
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def worker():
            # Worker failures must surface in the consumer (a swallowed
            # loading error would silently truncate the epoch), and an
            # abandoned iterator (consumer breaks early) must not leave
            # the thread blocked forever on a full queue — hence the
            # (kind, payload) protocol and the timeout/stop polling.
            def put(item):
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                for batch in self._batches():
                    if not put(("batch", batch)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put(("error", e))
                return
            put(("done", sentinel))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    break
                if kind == "error":
                    raise item
                yield item
            t.join()
        finally:
            stop.set()      # unblock (and retire) the worker on early exit


def get_data_loaders(data_cfg: DataConfig, model_cfg: ModelConfig,
                     seed: int = 0,
                     data_all: Optional[List[Dict]] = None,
                     partition_index: Optional[int] = None
                     ) -> Tuple[BatchIterator, BatchIterator, BatchIterator,
                                DataMeta]:
    """Build (train, val, test) iterators + metadata."""
    if data_cfg.task == "synthetic":
        labels, freqs = synthetic_label_freqs(model_cfg.n_classes)
        meta = DataMeta(labels=labels, label_freqs=dict(freqs),
                        n_classes=model_cfg.n_classes,
                        vocab=Vocab(), vocab_sz=model_cfg.bert.vocab_size)
        mk = lambda split, n: SyntheticDataset(data_cfg, model_cfg,
                                               length=n, split=split)
        train = mk("train", data_cfg.synthetic_len)
        dev = mk("dev", max(8, data_cfg.synthetic_len // 4))
        test = mk("test", max(8, data_cfg.synthetic_len // 4))
        meta.train_data_len = len(train)
    else:
        tokenizer, vocab = build_tokenizer(data_cfg.bert_vocab_path,
                                           model_cfg.bert.vocab_size)
        task_dir = os.path.join(data_cfg.data_path, data_cfg.task)
        labels, freqs = get_labels_and_frequencies(
            os.path.join(task_dir, "train.jsonl"))
        meta = DataMeta(labels=labels, label_freqs=dict(freqs),
                        n_classes=len(labels), vocab=vocab,
                        vocab_sz=vocab.vocab_sz)

        mk = lambda split, data_list=None: JsonlDataset(
            os.path.join(task_dir, f"{split}.jsonl"), tokenizer, labels,
            data_cfg, model_cfg, data_list)

        if data_all is not None and partition_index is not None:
            # k-fold cross-validation partition
            dev_size = int(len(data_all) * 0.2)
            k = partition_index
            dev_start, dev_end = k * dev_size, (k + 1) * dev_size
            train_data = data_all[:dev_start] + data_all[dev_end:]
            dev_data = data_all[dev_start:dev_end]
            test_size = int(len(train_data) * 0.1)
            train = mk("train", train_data[test_size:])
            dev = mk("dev", dev_data)
            test = mk("test", train_data[:test_size])
        else:
            train = mk("train")
            dev = mk("dev")
            test = mk("test")
        meta.train_data_len = len(train)

    def _store(ds, split):
        # precollated memmap cache for jsonl splits; cross-validation
        # data_list subsets index differently and stay on the direct path
        if (data_cfg.task == "synthetic" or not data_cfg.feature_cache
                or getattr(ds, "data", None) is None
                or data_all is not None):
            return None
        log = logging.getLogger("bpx_torch.data").info
        return PrecollatedStore.build_or_load(
            ds, os.path.join(data_cfg.data_path, data_cfg.task,
                             f"{split}.jsonl"),
            data_cfg, model_cfg, log=log)

    bs = data_cfg.batch_sz
    it = lambda ds, shuffle, drop, split: BatchIterator(
        ds, data_cfg, model_cfg, bs, shuffle=shuffle, drop_last=drop,
        seed=seed, prefetch=2, n_workers=data_cfg.n_workers,
        store=_store(ds, split))
    return (it(train, True, True, "train"), it(dev, False, False, "dev"),
            it(test, False, False, "test"), meta)
