"""The port's training loop against the JAX package's.

Every run is the ``synthetic-tiny`` preset in fp32 on the CPU, cut to one
encoder layer and one BERT layer (XLA's compile time of bpx's step grows
with depth), 48 training samples (three accumulation steps of 2 x 8 per
epoch) and 12 for dev and test, so each evaluation ends on a wrap-padded
batch.

* Lockstep: dropout off and bpx's initial weights injected into the port
  (``params_from_flax``); ``train`` for 3 epochs with ``lr_patience`` 0, so
  the plateau acts, against ``bpx.train.loop.train``: per-epoch train loss
  and validation metrics within rtol 2e-3 / atol 2e-4 (as
  tests/test_train_parity.py); the learning rate after each epoch, the
  stopper's and the plateau's state and which epochs saved ``best``: equal
  (their metric values within the same tolerance).
* ``test`` writes the JAX package's files, with agreeing predictions.
* ``Predictor.from_checkpoint`` reproduces ``test``'s probabilities, and a
  ragged client batch gives the same rows.
* bpx's run directory, restored with orbax here and carried over with
  ``params_from_flax``, serves through the port.
* ``seed_sweep`` names its runs as bpx does; ``maybe_load_pretrained``
  reads both Hugging Face layouts in both file formats; the checkpoint
  manager, the artifacts writer and the small utilities.

Resume runs are in tests/test_torch_resume.py (their bpx runs compile
their own steps, and a file of their own runs on its own worker).
"""

import dataclasses
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import bpx.train.loop as jloop
from bpx import config as jconfig
from bpx.train import optim as joptim
from bpx.utils import checkpoint as jcheckpoint

import bpx_torch.train.loop as loop
from bpx_torch.config import config_from_dict
from bpx_torch.data.loaders import get_data_loaders
from bpx_torch.interop import flax_to_state_dict, params_from_flax
from bpx_torch.serve import Predictor
from bpx_torch.train import optim
from bpx_torch.utils import checkpoint

TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's CPU training: the suite runs
    several pytest workers side by side, and torch's default of one thread
    per core oversubscribes the cores (its threads then wait on each
    other)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ARTIFACTS = ["test_labels_pred.txt", "test_labels_gold.txt",
             "test_labels.txt", "preds_raw.npy", "gates.npy"]


def tiny_experiment(savedir, name, max_epochs=3, dropout=False):
    """synthetic-tiny at depth 1, 48/12/12 samples, A = 2, lr_patience 0;
    every dropout rate 0 unless ``dropout``."""
    jexp = jconfig.get_preset("synthetic-tiny")
    m = jexp.model
    m = m.replace(layers=1, bert=dataclasses.replace(m.bert, num_layers=1))
    if not dropout:
        m = m.replace(attn_dropout=0.0, attn_dropout_a=0.0,
                      attn_dropout_v=0.0, relu_dropout=0.0, res_dropout=0.0,
                      out_dropout=0.0, embed_dropout=0.0,
                      bert=dataclasses.replace(m.bert, hidden_dropout=0.0,
                                               attention_dropout=0.0))
    return jexp.replace(
        model=m,
        data=dataclasses.replace(jexp.data, synthetic_len=48),
        train=dataclasses.replace(
            jexp.train, savedir=str(savedir), name=name, seed=3,
            max_epochs=max_epochs, gradient_accumulation_steps=2,
            lr_patience=0, patience=10, output_gates=True))


def with_epochs(exp, max_epochs):
    return exp.replace(train=dataclasses.replace(exp.train,
                                                 max_epochs=max_epochs))


class Record:
    """What one package's loop did, per epoch: train loss, validation
    metrics, the plateau's and the stopper's state after their update, the
    learning rate, and the epochs that saved ``best``."""

    def __init__(self):
        self.train_loss, self.val, self.plateau, self.stopper = [], [], [], []
        self.saved = []


def record(monkeypatch, module, optim_module, ckpt_cls) -> Record:
    """Spy on ``module``'s loop (bpx's or the port's)."""
    rec = Record()

    class Capture(logging.Handler):
        def emit(self, r):
            if isinstance(r.msg, str) and r.msg.startswith("Epoch %d"):
                rec.train_loss.append(float(r.args[1]))

    create = module.create_logger

    def create_logger(*a, **k):
        logger = create(*a, **k)
        logger.addHandler(Capture())
        return logger

    log_metrics = module.log_metrics

    def spy_log_metrics(prefix, metrics, task, logger):
        if prefix.startswith("Val"):
            rec.val.append({k: float(v) for k, v in metrics.items()})
        return log_metrics(prefix, metrics, task, logger)

    step, update = (optim_module.PlateauScheduler.step,
                    optim_module.EarlyStopping.update)

    def spy_step(self, metric):
        lr = step(self, metric)
        rec.plateau.append(dict(self.state_dict()))
        return lr

    def spy_update(self, metric):
        improved = update(self, metric)
        rec.stopper.append(dict(self.state_dict()))
        return improved

    save = ckpt_cls.save

    def spy_save(self, *args, **kw):
        rec.saved.append(args[-1]["epoch"])     # the host state
        return save(self, *args, **kw)

    monkeypatch.setattr(module, "create_logger", create_logger)
    monkeypatch.setattr(module, "log_metrics", spy_log_metrics)
    monkeypatch.setattr(optim_module.PlateauScheduler, "step", spy_step)
    monkeypatch.setattr(optim_module.EarlyStopping, "update", spy_update)
    monkeypatch.setattr(ckpt_cls, "save", spy_save)
    return rec


def one_device(monkeypatch):
    """bpx's loop on one CPU device (the suite forces 8 virtual ones): no
    SPMD partitioning, much shorter compiles, the same arithmetic."""
    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])


def inject_bpx_weights(monkeypatch, jrec):
    """The port's ``init_model_and_state`` loads bpx's initial weights
    (recorded by :func:`record_bpx_init`)."""
    init = loop.init_model_and_state

    def init_model_and_state(exp, seed, device=None):
        model, opt = init(exp, seed, device)
        model.load_state_dict(params_from_flax(jrec.params, exp.model))
        return model, opt

    monkeypatch.setattr(loop, "init_model_and_state", init_model_and_state)


def record_bpx_init(monkeypatch, jrec):
    init = jloop.init_model_and_state

    def init_model_and_state(exp, example, key):
        model, tx, state = init(exp, example, key)
        jrec.params = jax.tree.map(np.asarray, state.params)
        jrec.state = state
        return model, tx, state

    monkeypatch.setattr(jloop, "init_model_and_state", init_model_and_state)


def run_bpx(monkeypatch, jexp, test=False) -> Record:
    one_device(monkeypatch)
    jrec = record(monkeypatch, jloop, joptim, jcheckpoint.CheckpointManager)
    record_bpx_init(monkeypatch, jrec)
    jloop.train(jexp)
    if test:
        jrec.test = jloop.test(jexp)
    return jrec


def run_port(monkeypatch, exp, jrec, test=False) -> Record:
    rec = record(monkeypatch, loop, optim, checkpoint.CheckpointManager)
    inject_bpx_weights(monkeypatch, jrec)
    loop.train(exp, device="cpu")
    if test:
        rec.test = loop.test(exp, device="cpu")
    return rec


def assert_lockstep(rec: Record, jrec: Record):
    """Per-epoch numbers within TOL; the schedule's decisions equal."""
    assert len(rec.train_loss) == len(jrec.train_loss) > 0
    np.testing.assert_allclose(rec.train_loss, jrec.train_loss, **TOL,
                               err_msg="train loss")
    assert len(rec.val) == len(jrec.val)
    for got, want in zip(rec.val, jrec.val):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    for got, want in zip(rec.plateau + rec.stopper,
                         jrec.plateau + jrec.stopper):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], float) and k == "best":
                np.testing.assert_allclose(got[k], want[k], **TOL)
            else:
                assert got[k] == want[k], k
    assert [p["lr"] for p in rec.plateau] == [p["lr"] for p in jrec.plateau]
    assert rec.saved == jrec.saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """bpx's 3-epoch run and test, and the port's from bpx's weights."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("loop")
    jexp = tiny_experiment(root / "bpx", "run")
    exp = config_from_dict(dataclasses.asdict(jexp))
    exp = exp.replace(train=dataclasses.replace(exp.train,
                                                savedir=str(root / "port")))
    try:
        jrec = run_bpx(mp, jexp, test=True)
        rec = run_port(mp, exp, jrec, test=True)
    finally:
        mp.undo()
    return dict(jexp=jexp, exp=exp, jrec=jrec, rec=rec,
                jdir=root / "bpx" / "run", dir=root / "port" / "run")


def test_train_lockstep_with_bpx(runs):
    rec, jrec = runs["rec"], runs["jrec"]
    assert len(rec.val) == 3
    # the plateau acted at least once (lr_patience 0)
    assert any(p["lr"] < runs["exp"].train.lr for p in rec.plateau)
    assert_lockstep(rec, jrec)
    for f in ("latest", "best", "host_state.json", "best_host_state.json",
              "config.json", "logfile.log"):
        assert (runs["dir"] / f).exists(), f
    with open(runs["dir"] / "host_state.json") as f:
        host = json.load(f)
    with open(runs["jdir"] / "host_state.json") as f:
        jhost = json.load(f)
    assert host["epoch"] == jhost["epoch"] == rec.saved[-1]
    assert config_from_dict(json.loads(
        (runs["dir"] / "config.json").read_text())) == runs["exp"]


def test_test_writes_bpx_artifacts(runs):
    d, jd = runs["dir"], runs["jdir"]
    for name in ARTIFACTS:
        assert (d / name).exists() and (jd / name).exists(), name
    for name in ("test_labels_gold.txt", "test_labels.txt"):
        assert (d / name).read_text() == (jd / name).read_text(), name
    raw, jraw = np.load(d / "preds_raw.npy"), np.load(jd / "preds_raw.npy")
    assert raw.shape == jraw.shape == (12, runs["exp"].model.n_classes)
    np.testing.assert_allclose(raw, jraw, **TOL)
    np.testing.assert_allclose(np.load(d / "gates.npy"),
                               np.load(jd / "gates.npy"), **TOL)
    pred = np.loadtxt(d / "test_labels_pred.txt")
    jpred = np.loadtxt(jd / "test_labels_pred.txt")
    sure = np.abs(jraw - 0.5) > 1e-3
    np.testing.assert_array_equal(pred[sure], jpred[sure])
    for k, v in runs["jrec"].test.items():
        np.testing.assert_allclose(runs["rec"].test[k], v, **TOL, err_msg=k)


def serve_test_set(pred, exp):
    """``pred``'s probabilities over the test split's valid rows."""
    _, _, test_loader, _ = get_data_loaders(exp.data, exp.model,
                                            seed=exp.train.seed)
    out = []
    for batch in test_loader:
        valid = batch.pop("valid", None)
        probs = pred(batch)
        out.append(probs if valid is None else probs[:int(valid.sum())])
    return np.concatenate(out), batch


def test_from_checkpoint_reproduces_test(runs):
    exp = runs["exp"]
    pred = Predictor.from_checkpoint(exp, str(runs["dir"]), batch_size=8,
                                     device="cpu")
    probs, last = serve_test_set(pred, exp)
    np.testing.assert_allclose(probs, np.load(runs["dir"] / "preds_raw.npy"),
                               rtol=0, atol=1e-6)
    # a ragged client batch gives the same rows
    probs5, gates5 = pred({k: v[:5] for k, v in last.items()},
                          return_gates=True)
    np.testing.assert_allclose(probs5, pred(last)[:5], rtol=0, atol=1e-6)
    assert gates5.shape[0] == 5
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(exp, str(runs["dir"]), tag="nope",
                                  device="cpu")
    missing = runs["dir"].parent / "no_such_run"
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(exp, str(missing), device="cpu")
    assert not missing.exists()


def test_bpx_run_directory_serves_through_the_port(runs):
    """bpx's best checkpoint, orbax-restored here, carried over with
    params_from_flax: the port serves bpx's test probabilities."""
    jexp, exp = runs["jexp"], runs["exp"]
    state, _ = jcheckpoint.CheckpointManager(str(runs["jdir"])).restore(
        runs["jrec"].state, "best")
    sd = params_from_flax(jax.tree.map(np.asarray, state.params), exp.model)
    pred = Predictor(exp, sd, batch_size=8, device="cpu")
    probs, _ = serve_test_set(pred, exp)
    np.testing.assert_allclose(probs, np.load(runs["jdir"] / "preds_raw.npy"),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inverse,just_test", [(False, False), (True, False),
                                               (False, True)])
def test_seed_sweep_uses_bpx_run_names(monkeypatch, tmp_path, inverse,
                                       just_test):
    jexp = tiny_experiment(tmp_path, "sweep")
    jexp = jexp.replace(train=dataclasses.replace(
        jexp.train, from_seed=2, to_seed=4, inverse_seed=inverse,
        just_test=just_test))
    calls = {}
    for mod, key in ((jloop, "bpx"), (loop, "port")):
        seen = calls[key] = []
        monkeypatch.setattr(mod, "train", lambda e, *a, s=seen, **k:
                            s.append(("train", e.train.name, e.train.seed)))
        monkeypatch.setattr(mod, "test", lambda e, *a, s=seen, **k:
                            s.append(("test", e.train.name, e.train.seed))
                            or {"seed": e.train.seed})
    jout = jloop.seed_sweep(jexp)
    out = loop.seed_sweep(config_from_dict(dataclasses.asdict(jexp)),
                          device="cpu")
    assert calls["port"] == calls["bpx"]
    assert out == jout
    assert all(name == f"sweep_Seed{seed}_run"
               for _, name, seed in calls["port"])
    assert [c[0] for c in calls["port"]].count("train") == \
        (0 if just_test else 3)


# ---------------------------------------------------------------------------
# checkpoints, artifacts, utilities
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_is_bitwise(tmp_path):
    exp = config_from_dict(dataclasses.asdict(tiny_experiment(tmp_path, "c")))
    model, opt = loop.init_model_and_state(exp, 0, "cpu")
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    optim.set_lr(opt, 2.5e-4)
    ckpt = checkpoint.CheckpointManager(str(tmp_path / "run"))
    ckpt.save(model, opt, 7, {"epoch": 2, "stopper": {"best": 0.5}},
              is_best=True)
    ckpt.save(model, opt, 9, {"epoch": 3})
    assert sorted(os.listdir(tmp_path / "run")) == [
        "best", "best_host_state.json", "host_state.json", "latest"]
    model2, opt2 = loop.init_model_and_state(exp, 1, "cpu")
    step, host = ckpt.restore(model2, opt2, "latest")
    assert (step, host) == (9, {"epoch": 3})
    assert ckpt.restore(model2, tag="best")[1]["epoch"] == 2
    for (n, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), n
    for p, p2 in zip(model.parameters(), model2.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key])
    assert optim.get_current_lr(opt2) == 2.5e-4


def test_store_preds_to_disk_matches_bpx(tmp_path):
    from bpx.utils.artifacts import store_preds_to_disk as jstore
    from bpx_torch.utils.artifacts import store_preds_to_disk
    rng = np.random.RandomState(0)
    for task_type, tgts, preds in (
            ("multilabel", rng.rand(5, 3) > 0.5, rng.rand(5, 3) > 0.5),
            ("classification", rng.randint(0, 4, 5), rng.randint(0, 4, 5))):
        raw, gates = rng.rand(5, 3), rng.rand(5, 2)
        for fn, d in ((store_preds_to_disk, "port"), (jstore, "bpx")):
            fn(tgts, preds, str(tmp_path / task_type / d), ["a", "b", 7],
               task_type, preds_raw=raw, gates=gates)
        for name in ARTIFACTS:
            got = (tmp_path / task_type / "port" / name).read_bytes()
            assert got == (tmp_path / task_type / "bpx" / name).read_bytes()


def test_profile_dir_writes_a_trace(tmp_path):
    from bpx_torch.utils import profiling
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(4).add_(1)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_small_utilities_match_bpx(monkeypatch):
    from bpx.utils import env as jenv, profiling as jprof, seeding as jseed
    from bpx_torch.utils import env, profiling, seeding
    for val in (None, "0", "1", "yes"):
        if val is None:
            monkeypatch.delenv("BPX_X", raising=False)
        else:
            monkeypatch.setenv("BPX_X", val)
        for default in (True, False):
            assert env.env_flag("BPX_X", default) == \
                jenv.env_flag("BPX_X", default)
    jseed.set_seed(11)
    want = np.random.rand(3)
    gen = seeding.set_seed(11)
    np.testing.assert_array_equal(np.random.rand(3), want)
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(11)))
    t, jt = profiling.StepTimer(), jprof.StepTimer()
    t.times = [0.3, 0.1, 0.2, 0.4]
    jt.times = list(t.times)
    assert (t.p50, t.p90) == (jt.p50, jt.p90)
    assert t.summary(8) == jt.summary(8)


# ---------------------------------------------------------------------------
# Hugging Face BERT weights
# ---------------------------------------------------------------------------

def _hf_state_dict(cfg, distil: bool, prefix: str, seed=0):
    """A random Hugging Face state dict in the BERT or DistilBERT layout."""
    rng = np.random.RandomState(seed)
    E, F = cfg.hidden_size, cfg.intermediate_size
    t = lambda *s: rng.randn(*s).astype(np.float32)
    sd = {"embeddings.word_embeddings.weight": t(cfg.vocab_size, E),
          "embeddings.position_embeddings.weight":
              t(cfg.max_position_embeddings, E),
          "embeddings.LayerNorm.weight": t(E),
          "embeddings.LayerNorm.bias": t(E)}
    if not distil:
        sd["embeddings.token_type_embeddings.weight"] = t(2, E)
    for i in range(cfg.num_layers):
        if distil:
            p = f"transformer.layer.{i}"
            shapes = {"attention.q_lin": (E, E), "attention.k_lin": (E, E),
                      "attention.v_lin": (E, E), "attention.out_lin": (E, E),
                      "sa_layer_norm": (E,), "ffn.lin1": (F, E),
                      "ffn.lin2": (E, F), "output_layer_norm": (E,)}
        else:
            p = f"encoder.layer.{i}"
            shapes = {"attention.self.query": (E, E),
                      "attention.self.key": (E, E),
                      "attention.self.value": (E, E),
                      "attention.output.dense": (E, E),
                      "attention.output.LayerNorm": (E,),
                      "intermediate.dense": (F, E), "output.dense": (E, F),
                      "output.LayerNorm": (E,)}
        for name, shape in shapes.items():
            sd[f"{p}.{name}.weight"] = t(*shape)
            sd[f"{p}.{name}.bias"] = t(shape[0])
    return {prefix + k: v for k, v in sd.items()}


@pytest.mark.parametrize("fmt", ["bin", "safetensors", "bf16-safetensors",
                                 "directory"])
@pytest.mark.parametrize("layout", ["bert", "distilbert"])
def test_maybe_load_pretrained_matches_bpx(tmp_path, layout, fmt):
    from safetensors.torch import save_file
    from bpx.ops.bert import maybe_load_pretrained as jload
    from bpx_torch.ops.bert import maybe_load_pretrained

    jexp = tiny_experiment(tmp_path, "bert")
    bert = jexp.model.bert
    if layout == "distilbert":
        bert = dataclasses.replace(bert, use_token_type=False)
    distil = layout == "distilbert"
    hf = {k: torch.from_numpy(v) for k, v in _hf_state_dict(
        bert, distil, f"{layout}.").items()}
    ref = tmp_path / "ref" / "pytorch_model.bin"    # what bpx reads
    ref.parent.mkdir()
    if fmt == "bin":
        path = tmp_path / "pytorch_model.bin"
        torch.save(hf, path)
    else:
        path = tmp_path / "model.safetensors"
        if fmt == "bf16-safetensors":
            hf = {k: v.to(torch.bfloat16) for k, v in hf.items()}
        save_file(hf, str(path))
        if fmt == "directory":
            path = tmp_path
    # bpx reads .safetensors with the safetensors package, which has no
    # numpy bf16: its reference is the same values widened to fp32
    torch.save({k: v.float() for k, v in hf.items()}, ref)
    jexp = jexp.replace(model=jexp.model.replace(
        bert=bert, bert_init="pretrained", bert_weights_path=str(path)))
    exp = config_from_dict(dataclasses.asdict(jexp))

    model, _ = loop.init_model_and_state(exp, 0, "cpu")
    got = {k[len("bert."):]: v for k, v in model.state_dict().items()
           if k.startswith("bert.")}
    want = flax_to_state_dict(jload({}, bert, str(
        ref if fmt == "bf16-safetensors" else path))["bert"])
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    q = ("transformer.layer.0.attention.q_lin" if distil
         else "encoder.layer.0.attention.self.query")
    assert torch.equal(got["layers.0.attention.query.weight"],
                       hf[f"{layout}.{q}.weight"].float())
    # no checkpoint at the path: the state dict is returned as it was
    sd = model.state_dict()
    assert maybe_load_pretrained(sd, bert, str(tmp_path / "none")) is sd
