"""The port's data pipeline against the JAX package's: the same batches,
bit for bit.

For the synthetic task and for jsonl fixtures the tests write in each
task's on-disk layout (moviescope pickles; mmimdb's GloVe/BoW pickles and
hdf5 posters; cmu-mosei's and iemocap's torch-saved .pt features;
counseling's GloVe/fastText pickles; cmu-mosi's whole-dataset table), made
with numpy from a seed: two epochs of shuffled train batches, the
wrap-padded final batch with its ``valid`` mask, the precollated memmap
cache against the direct path (and its reuse on a second build), fold ``k``
of the cross-validation split, and ``DataMeta``.  Tokenizers: WordPiece ids
on a vocab file the test writes, the hash tokenizer, and the native
tokenizer (built with ``g++``).
"""

import dataclasses
import json
import pickle
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from bpx import config as jconfig
from bpx.data import cache as jcache
from bpx.data import loaders as jloaders
from bpx.data import tokenization as jtok
from bpx.data.vocab import Vocab as JVocab

from bpx_torch.config import config_from_dict
from bpx_torch.data import cache, loaders, synthetic, tokenization
from bpx_torch.data.native import NativeWordPieceTokenizer
from bpx_torch.data.vocab import Vocab

N_RECORDS = 11          # batches of 4: two full, one wrap-padded with 3
BATCH = 4
GENRES = ["Drama", "Action", "Comedy", "Horror", "Romance"]


def _port(jexp):
    return config_from_dict(dataclasses.asdict(jexp))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for b_got, b_want in zip(got, want):
        assert set(b_got) == set(b_want)
        for k in b_want:
            assert b_got[k].dtype == b_want[k].dtype, k
            np.testing.assert_array_equal(b_got[k], b_want[k], err_msg=k)


def _all_batches(train, val, test, epochs=2):
    """Two epochs of the shuffled train loader, then val and test."""
    return ([b for _ in range(epochs) for b in train]
            + list(val) + list(test))


def _assert_meta_equal(got, want):
    assert got.labels == want.labels
    assert got.label_freqs == want.label_freqs
    assert (got.n_classes, got.vocab_sz, got.train_data_len) == \
        (want.n_classes, want.vocab_sz, want.train_data_len)
    assert got.vocab.itos == want.vocab.itos


# ---------------------------------------------------------------------------
# the synthetic task
# ---------------------------------------------------------------------------

def _synthetic_exp():
    jexp = jconfig.get_preset("synthetic-tiny")
    return jexp.replace(data=dataclasses.replace(
        jexp.data, synthetic_len=2 * N_RECORDS, batch_sz=BATCH))


def test_synthetic_batches_match_bpx():
    jexp = _synthetic_exp()
    exp = _port(jexp)
    *want, jmeta = jloaders.get_data_loaders(jexp.data, jexp.model, seed=5)
    *got, meta = loaders.get_data_loaders(exp.data, exp.model, seed=5)
    _assert_meta_equal(meta, jmeta)
    _assert_batches_equal(_all_batches(*got), _all_batches(*want))


def test_shuffle_order_counts_every_iteration():
    """An abandoned iteration counts as an epoch of the shuffle."""
    jexp = _synthetic_exp()
    exp = _port(jexp)
    jtrain = jloaders.get_data_loaders(jexp.data, jexp.model, seed=2)[0]
    train = loaders.get_data_loaders(exp.data, exp.model, seed=2)[0]
    for it in (jtrain, train):
        next(iter(it))
    assert train.epoch == jtrain.epoch == 1
    _assert_batches_equal(list(train), list(jtrain))
    first = list(train)
    assert train.epoch == 3
    assert not np.array_equal(first[0]["txt"], list(train)[0]["txt"])


def test_prefetch_thread_surfaces_errors_and_retires():
    jexp = _synthetic_exp()
    exp = _port(jexp)

    class Failing(synthetic.SyntheticDataset):
        def __getitem__(self, index):
            if index == 6:
                raise OSError("feature file missing")
            return super().__getitem__(index)

    ds = Failing(exp.data, exp.model, length=N_RECORDS)
    it = loaders.BatchIterator(ds, exp.data, exp.model, BATCH, prefetch=2)
    with pytest.raises(OSError, match="feature file missing"):
        list(it)
    # an abandoned iteration stops its worker instead of blocking on a full
    # queue
    before = threading.active_count()
    ok = loaders.BatchIterator(
        synthetic.SyntheticDataset(exp.data, exp.model, length=8 * BATCH),
        exp.data, exp.model, BATCH, prefetch=1)
    gen = iter(ok)
    next(gen)
    gen.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        time.sleep(0.05)
    assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# jsonl fixtures in each task's layout
# ---------------------------------------------------------------------------

def _dump(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _labels(task, rng):
    if task == "cmu-mosi":
        return float(np.round(rng.uniform(-3, 3), 1))
    if task == "counseling":
        return ["good", "bad"][rng.randint(2)]
    k = rng.randint(1, 3)
    return [GENRES[j] for j in rng.choice(len(GENRES), k, replace=False)]


def _write_task(root, task, seed=0, n=N_RECORDS):
    """``{split}.jsonl`` (``n`` records each) and per-sample features in
    ``task``'s layout under ``root/task``; returns the train records."""
    rng = np.random.RandomState(seed)
    d = root / task
    d.mkdir(parents=True)
    mosi = {}
    imdb_rows = []
    splits = {}
    for split in ("train", "dev", "test"):
        records = []
        for i in range(n):
            sid = f"{split[0]}{i}"
            r = {"id": sid, "synopsis": f"a {split} plot number {i} "
                 + " ".join(f"w{rng.randint(50)}" for _ in range(
                     rng.randint(1, 12))),
                 "label": _labels(task, rng)}
            t = rng.randint(3, 14)
            if task == "moviescope":
                _dump(d / "200F_VGG16" / f"{sid}.p",
                      rng.randn(1, t, 48).astype(np.float32))
                _dump(d / "PosterFeatures" / f"{sid}.p",
                      rng.randn(1, 40).astype(np.float32))
                _dump(d / "Melspectrogram" / f"{sid}.p",
                      rng.randn(96, rng.randint(20, 40)).astype(np.float32))
            elif task == "mmimdb":
                _dump(d / "glove" / f"{sid}.p",
                      {"glove": rng.randn(1, t, 30).astype(np.float32)})
                _dump(d / "BoW" / f"{sid}.p",
                      {"bow": rng.randn(24).astype(np.float32)})
                imdb_rows.append(sid)
            elif task in ("cmu-mosei", "iemocap"):
                r["task"] = split
                for sub, dim in (("Vision", 35), ("Audio", 74)):
                    p = d / sub / split / f"{sid}.p"
                    p.parent.mkdir(parents=True, exist_ok=True)
                    torch.save(torch.from_numpy(
                        rng.randn(t, dim).astype(np.float32)), p)
            elif task == "counseling":
                _dump(d / "glove" / f"{sid}.p",
                      {"glove": rng.randn(1, t, 30).astype(np.float32)})
                _dump(d / "fasttext" / f"{sid}.p",
                      {"fastText": rng.randn(1, t, 20).astype(np.float32)})
            elif task == "cmu-mosi":
                r["id"], r["part"] = i, split
                part = mosi.setdefault(split, {"vision": [], "audio": []})
                part["vision"].append(rng.randn(t, 35).astype(np.float32))
                part["audio"].append(rng.randn(t, 5).astype(np.float32))
            records.append(r)
        with open(d / f"{split}.jsonl", "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
        splits[split] = records
    if task == "mmimdb":
        import h5py
        with h5py.File(d / "multimodal_imdb.hdf5", "w") as f:
            f.create_dataset("vgg_features", data=rng.randn(
                len(imdb_rows), 40).astype(np.float32))
        _dump(d / "indices.pkl", {sid: i for i, sid in enumerate(imdb_rows)})
    if task == "cmu-mosi":
        _dump(d / "mosi_data.pkl", mosi)
    return splits["train"]


def _task_exp(task, data_path, feature_cache=False):
    """The synthetic-tiny preset pointed at ``task``'s fixture, with the
    fixture's feature widths."""
    jexp = jconfig.get_preset("synthetic-tiny")
    dcfg = dataclasses.replace(
        jexp.data, task=task, data_path=str(data_path), batch_sz=BATCH,
        audio_raw_len=12, video_len=10, feature_cache=feature_cache,
        n_workers=2)
    m = jexp.model
    if task == "moviescope":
        m = m.replace(orig_d_v=48, orig_d_a=96, orig_d_p=40)
    elif task == "mmimdb":
        m = m.replace(orig_d_v=30, orig_d_a=1, orig_d_p=40,
                      use_audio_encoder=False)
    else:
        dims = {"cmu-mosei": (35, 74), "iemocap": (35, 74),
                "counseling": (30, 20), "cmu-mosi": (35, 5)}[task]
        m = m.replace(model="mmtrvat", orig_d_v=dims[0], orig_d_a=dims[1],
                      use_audio_encoder=False, use_poster=False)
    if task == "cmu-mosi":
        dcfg = dataclasses.replace(dcfg, task_type="classification")
        m = m.replace(n_classes=1)
    return jexp.replace(model=m, data=dcfg)


TASKS = ["moviescope", "mmimdb", "cmu-mosei", "iemocap", "counseling",
         "cmu-mosi"]


@pytest.mark.parametrize("task", TASKS)
def test_task_layout_batches_match_bpx(task, tmp_path):
    _write_task(tmp_path, task)
    jexp = _task_exp(task, tmp_path)
    exp = _port(jexp)
    *want, jmeta = jloaders.get_data_loaders(jexp.data, jexp.model, seed=7)
    *got, meta = loaders.get_data_loaders(exp.data, exp.model, seed=7)
    _assert_meta_equal(meta, jmeta)
    w, g = _all_batches(*want), _all_batches(*got)
    # two shuffled train epochs of 2 full batches (drop_last), then dev and
    # test: 2 full batches and one wrap-padded with 3 valid rows each
    assert len(w) == 2 * 2 + 3 + 3
    assert w[-1]["valid"].tolist() == [True] * 3 + [False]
    assert not np.array_equal(w[0]["txt"], w[2]["txt"])
    _assert_batches_equal(g, w)


@pytest.mark.parametrize("task", TASKS)
def test_cache_matches_direct_path_and_is_reused(task, tmp_path):
    """The port's precollated memmap store gives the direct path's batches
    bit for bit, under the JAX package's digest, and a second build reuses
    it."""
    _write_task(tmp_path, task)
    jexp = _task_exp(task, tmp_path)
    exp = _port(jexp)
    direct = _all_batches(*loaders.get_data_loaders(
        exp.data, exp.model, seed=1)[:3])
    cached_exp = _port(_task_exp(task, tmp_path, feature_cache=True))
    train, val, test, meta = loaders.get_data_loaders(
        cached_exp.data, cached_exp.model, seed=1)
    assert train.store is not None and test.store is not None
    _assert_batches_equal(_all_batches(train, val, test), direct)

    root = tmp_path / task / ".bpx_cache"
    dirs = sorted(p.name for p in root.iterdir())
    jsonl = str(tmp_path / task / "train.jsonl")
    want = jcache._digest(jsonl, jexp.data, jexp.model, meta.n_classes)
    assert f"train_{want}" in dirs
    assert cache._digest(jsonl, cached_exp.data, cached_exp.model,
                         meta.n_classes) == want
    again = loaders.get_data_loaders(cached_exp.data, cached_exp.model,
                                     seed=1)[0]
    assert again.store.path == train.store.path
    assert sorted(p.name for p in root.iterdir()) == dirs


@pytest.mark.parametrize("k", [0, 3])
def test_cross_validation_fold_matches_bpx(k, tmp_path):
    records = _write_task(tmp_path, "moviescope")
    jexp = _task_exp("moviescope", tmp_path, feature_cache=True)
    exp = _port(jexp)
    *want, _ = jloaders.get_data_loaders(jexp.data, jexp.model, seed=4,
                                         data_all=records,
                                         partition_index=k)
    *got, _ = loaders.get_data_loaders(exp.data, exp.model, seed=4,
                                       data_all=records, partition_index=k)
    # folds stay on the direct path; the fold's split sizes
    assert all(it.store is None for it in got)
    dev_size = int(N_RECORDS * 0.2)
    test_size = int((N_RECORDS - dev_size) * 0.1)
    assert [len(it.dataset) for it in got] == \
        [N_RECORDS - dev_size - test_size, dev_size, test_size]
    assert got[1].dataset.data == records[k * dev_size:(k + 1) * dev_size]
    _assert_batches_equal(_all_batches(*got), _all_batches(*want))


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

VOCAB_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
               "the", "cat", "sat", "on", "mat", "un", "##aff", "##able",
               "##s", "##ing", "movie", "plot", "drama", ",", ".", "!",
               "a", "b", "c", "é", "##é"]
TEXTS = ["The cats sat on the mat.", "unaffable movies, drama plots!",
         "THE CAT!!! sat... unaffables", "zzz unknown wordzz",
         "a b c " * 40, "", "the\x01cat sat", "the\tcat\nsat\rmat",
         "Café déjà vu — the cat", "中文 the cat"]


@pytest.fixture
def vocab_file(tmp_path):
    p = tmp_path / "vocab.txt"
    p.write_text("\n".join(VOCAB_WORDS), encoding="utf-8")
    return str(p)


def test_wordpiece_ids_match_bpx(vocab_file):
    tok = tokenization.WordPieceTokenizer(Vocab.from_bert_vocab_file(
        vocab_file))
    jtok_ = jtok.WordPieceTokenizer(JVocab.from_bert_vocab_file(vocab_file))
    for text in TEXTS:
        assert tok.tokenize(text) == jtok_.tokenize(text), text
        for max_len in (3, 16, 512):
            assert tok.encode(text, max_len) == jtok_.encode(text, max_len)


def test_hash_tokenizer_matches_bpx():
    tok, vocab = tokenization.build_tokenizer(None, 1024)
    jt, jvocab = jtok.build_tokenizer(None, 1024)
    assert isinstance(tok, tokenization.HashTokenizer)
    assert vocab.vocab_sz == jvocab.vocab_sz == 1024
    for text in TEXTS:
        assert tok.encode(text, 12) == jt.encode(text, 12)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ here")
def test_native_tokenizer_builds_and_matches(vocab_file):
    tok, _ = tokenization.build_tokenizer(vocab_file)
    assert isinstance(tok, NativeWordPieceTokenizer) and tok.is_native
    from bpx_torch.data import native
    assert native.BUILD_DIR in native._build_lib().parents
    py = tokenization.WordPieceTokenizer(Vocab.from_bert_vocab_file(
        vocab_file))
    jt, _ = jtok.build_tokenizer(vocab_file)
    for text in TEXTS:     # ASCII natively; the rest through Python
        for max_len in (4, 16, 128):
            ids = tok.encode(text, max_len)
            assert ids == py.encode(text, max_len) == \
                jt.encode(text, max_len), (text, max_len)
