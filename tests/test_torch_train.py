"""The port's training against the JAX package's: losses, optimizer and
schedulers, and the train step with gradient accumulation in lockstep with
``bpx.train.steps.make_train_step`` for both models (mmtrvapt, mmtrvat);
and the port's dropout wiring, MAG's included.

fp32 on the CPU, where the port's kernel wrappers compute their plain
versions.  Weights are initialised in ``bpx`` and carried over with
``bpx_torch.interop.params_from_flax`` (which maps a gradient tree the same
way); inputs are made with numpy from a seed.  Tolerances: losses 1e-6
relative (the same fp32 formula); one Adam step 1e-6; the three-step loss
trajectory rtol 2e-3 / atol 2e-4 (as tests/test_train_parity.py); step-1
gradients 1e-3 relative to each tensor's largest entry plus 1e-5 of the
largest gradient anywhere (fp32 sums in another order through a few
layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train import optim as joptim
from bpx.train.state import TrainState
from bpx.train.steps import make_train_step as jmake_train_step
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import norm as tnorm
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.train import losses, optim
from bpx_torch.train.steps import make_eval_step, make_train_step
from tests.test_torch_model import _batch, _tiny_experiment, tiny_vat

LR = 1e-3
A, MICRO = 2, 2


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# losses, optimizer, schedulers
# ---------------------------------------------------------------------------

def test_losses_match_bpx():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 5).astype(np.float32) * 3
    multi = (rng.rand(6, 5) > 0.6).astype(np.float32)
    cls = rng.randint(0, 5, size=6).astype(np.int32)
    reg = rng.randn(6).astype(np.float32)
    freqs, n = [3, 10, 1, 7, 4], 20
    pw = jlosses.inverse_frequency_weights(freqs, n)
    np.testing.assert_array_equal(losses.inverse_frequency_weights(freqs, n),
                                  pw)
    close = lambda a, b: np.testing.assert_allclose(float(a), float(b),
                                                    rtol=1e-6, atol=1e-7)
    close(losses.bce_with_logits(_t(logits), _t(multi), _t(pw)),
          jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(multi),
                                  jnp.asarray(pw)))
    close(losses.bce_with_logits(_t(logits), _t(multi)),
          jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(multi)))
    for w in (None, pw):
        close(losses.weighted_cross_entropy(
                  _t(logits), _t(cls), None if w is None else _t(w)),
              jlosses.weighted_cross_entropy(
                  jnp.asarray(logits), jnp.asarray(cls),
                  None if w is None else jnp.asarray(w)))
    close(losses.l1_loss(_t(reg), _t(logits[:, 0])),
          jlosses.l1_loss(jnp.asarray(reg), jnp.asarray(logits[:, 0])))
    for task, ttype, tgt in (("moviescope", "multilabel", multi),
                             ("iemocap", "classification", cls),
                             ("cmu-mosi", "classification", reg)):
        want = jlosses.make_loss_fn(task, ttype, True, freqs, n)(
            jnp.asarray(logits), jnp.asarray(tgt))
        got = losses.make_loss_fn(task, ttype, True, freqs, n)(
            _t(logits), _t(tgt))
        close(got, want)


def test_schedulers_match_bpx():
    metrics = [0.5, 0.6, 0.6, 0.59, 0.6, 0.6, 0.61, 0.3, 0.3, 0.3, 0.3]
    for mode in ("max", "min"):
        js = joptim.PlateauScheduler(1e-3, mode=mode, patience=1)
        ts = optim.PlateauScheduler(1e-3, mode=mode, patience=1)
        assert [ts.step(m) for m in metrics] == [js.step(m) for m in metrics]
        je, te = joptim.EarlyStopping(3, mode), optim.EarlyStopping(3, mode)
        assert [(te.update(m), te.should_stop) for m in metrics] == \
            [(je.update(m), je.should_stop) for m in metrics]
        assert ts.state_dict() == js.state_dict()


@pytest.mark.parametrize("name", ["adam", "adamw", "radam", "plain_radam"])
def test_one_optimizer_step_matches_optax(name):
    rng = np.random.RandomState(1)
    p0 = rng.randn(7, 3).astype(np.float32)
    grads = [rng.randn(7, 3).astype(np.float32) for _ in range(2)]
    tx = joptim.make_optimizer(LR, name)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    p = torch.nn.Parameter(_t(p0))
    opt = optim.make_optimizer([p], LR, name)
    for g in grads:        # two steps: the bias corrections move
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)
    assert optim.get_current_lr(opt) == LR
    optim.set_lr(opt, 5e-4)
    assert optim.get_current_lr(opt) == 5e-4


# ---------------------------------------------------------------------------
# the train step in lockstep with bpx
# ---------------------------------------------------------------------------

def _no_dropout(jexp):
    m = jexp.model
    return jexp.replace(model=m.replace(
        attn_dropout=0.0, attn_dropout_a=0.0, attn_dropout_v=0.0,
        relu_dropout=0.0, res_dropout=0.0, out_dropout=0.0,
        embed_dropout=0.0,
        bert=dataclasses.replace(m.bert, hidden_dropout=0.0,
                                 attention_dropout=0.0)))


def _super_batch(jexp, seed, regression=False):
    """(A, micro, ...) numpy super-batch with multilabel targets, or with
    one real-valued target per sample (``regression``)."""
    b = _batch(jexp, A * MICRO, seed=seed)
    rng = np.random.RandomState(seed + 100)
    b["target"] = (rng.randn(A * MICRO).astype(np.float32) if regression
                   else (rng.rand(A * MICRO, jexp.model.n_classes)
                         > 0.6).astype(np.float32))
    return {k: v.reshape(A, MICRO, *v.shape[1:]) for k, v in b.items()}


FREQS = [5, 2, 9, 1, 4]


def test_train_step_lockstep_with_bpx():
    _lockstep(_no_dropout(_tiny_experiment()), FREQS)


def test_mmtrvat_train_step_lockstep_with_bpx():
    """The tiny mmtrvat (head_dim 25, plain second round, 3-ary GMU)."""
    jexp, _, _ = tiny_vat("gmu")
    _lockstep(_no_dropout(jexp), [5, 2, 9, 1, 4, 3, 6, 2])


def _lockstep(jexp, freqs, task="synthetic", task_type="multilabel",
              batch_seeds=(0, 1, 2)):
    """Three accumulation steps of bpx and the port from the same weights
    and batches (one super-batch per seed of ``batch_seeds``): step-1
    gradients, the grad norm and the loss trajectory."""
    name = jexp.model.model
    exp = config_from_dict(dataclasses.asdict(jexp))
    regression = task == "cmu-mosi"
    batches = [_super_batch(jexp, s, regression) for s in batch_seeds]
    jmodel = jget_model(jexp.model)
    first = {k: jnp.asarray(v[0]) for k, v in batches[0].items()}
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         *jmodel_inputs(name, first))["params"]

    # bpx: the real loss, optimizer and jitted accumulation step
    jloss = jlosses.make_loss_fn(task, task_type, True, freqs, 10)
    tx = joptim.make_optimizer(LR)
    jstep = jax.jit(jmake_train_step(jmodel, name, jloss, tx,
                                     grad_accum=A))
    state = TrainState.create(params, tx)
    jlosses_ = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(1))
        jlosses_.append(float(m["loss"]))

    # bpx step-1 gradients: the mean of the micro-batch gradients
    def mean_loss(prm):
        ls = [jloss(jmodel.apply({"params": prm}, *jmodel_inputs(
                  name, {k: jnp.asarray(v[i])
                               for k, v in batches[0].items()})),
                    jnp.asarray(batches[0]["target"][i])) for i in range(A)]
        return sum(ls) / A
    jgrads = jax.grad(mean_loss)(params)

    # the port
    model = get_model(exp.model, device="cpu")
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params), exp.model))
    opt = optim.make_optimizer(model.parameters(), LR)
    step = make_train_step(model, name,
                           losses.make_loss_fn(task, task_type, True, freqs,
                                               10),
                           opt, grad_accum=A, with_grad_norm=True)
    tlosses = []
    for i, b in enumerate(batches):
        m = step({k: _t(v) for k, v in b.items()})
        tlosses.append(float(m["loss"]))
        if i == 0:
            want = params_from_flax(jax.tree.map(np.asarray, jgrads),
                                    exp.model)
            got = {n: p.grad for n, p in model.named_parameters()}
            assert set(got) == set(want)
            # a floor of 1e-5 of the largest gradient anywhere: the key
            # biases' true gradient is 0 and both sides hold fp32 noise
            floor = 1e-5 * max(float(w.abs().max()) for w in want.values())
            for n in want:
                w = want[n].numpy()
                np.testing.assert_allclose(
                    got[n].numpy(), w, rtol=1e-3,
                    atol=1e-3 * np.abs(w).max() + floor, err_msg=n)
            norm = np.sqrt(sum(float((g.double() ** 2).sum())
                               for g in got.values()))
            np.testing.assert_allclose(float(m["grad_norm"]), norm,
                                       rtol=1e-5)
    np.testing.assert_allclose(tlosses, jlosses_, rtol=2e-3, atol=2e-4,
                               err_msg="loss trajectory diverged")
    assert tlosses[-1] < tlosses[0]


def test_freeze_bert_keeps_bert_fixed():
    jexp = _tiny_experiment()
    exp = config_from_dict(dataclasses.asdict(jexp))
    model = get_model(exp.model, device="cpu", seed=1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = optim.make_optimizer(model.parameters(), 1e-2)
    step = make_train_step(model, "mmtrvapt",
                           losses.make_loss_fn("synthetic", "multilabel",
                                               False),
                           opt, grad_accum=A, freeze_bert=True,
                           generator=torch.Generator().manual_seed(4))
    for s in range(2):
        step({k: _t(v) for k, v in _super_batch(jexp, s).items()})
    moved = {n for n, p in model.named_parameters()
             if not torch.equal(p, before[n])}
    bert = {n for n in before if n.startswith("bert.")}
    assert bert and not (moved & bert)
    assert moved == set(before) - bert


# ---------------------------------------------------------------------------
# dropout wiring in the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_port():
    jexp = _tiny_experiment()
    exp = config_from_dict(dataclasses.asdict(jexp))
    model = get_model(exp.model, device="cpu", seed=2)
    inputs = [_t(v) for v in jmodel_inputs(
        "mmtrvapt", _batch(jexp, 3, seed=5))]
    return jexp, exp, model, inputs


def test_train_mode_dropout_follows_the_seed(tiny_port):
    """The same generator state gives the same base seed and so identical
    logits; another state, other masks."""
    from bpx_torch.ops.dropout import draw_base_seed
    _, _, model, inputs = tiny_port
    seed = lambda state: draw_base_seed(torch.Generator().manual_seed(state))
    model.train()
    with torch.no_grad():
        a = model(*inputs, dropout_seed=seed(11))
        b = model(*inputs, dropout_seed=seed(11))
        c = model(*inputs, dropout_seed=seed(12))
        model.eval()
        d = model(*inputs)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, d)
    model.train()
    with pytest.raises(ValueError, match="SeedStream"):
        model(*inputs)
    model.eval()


def test_train_mode_with_rates_zero_equals_eval(tiny_port):
    jexp, _, _, inputs = tiny_port
    exp = config_from_dict(dataclasses.asdict(_no_dropout(jexp)))
    model = get_model(exp.model, device="cpu", seed=2)
    with torch.no_grad():
        want = model(*inputs)
        model.train()
        got = model(*inputs, dropout_seed=3)
    assert torch.equal(got, want)


def _count_calls(monkeypatch):
    counts = {"ln": 0, "flash": 0, "flash_dropout": 0}
    ln_fwd, fl_fwd = tnorm._forward, tflash._forward

    def ln(*a):
        counts["ln"] += 1
        return ln_fwd(*a)

    def fl(q, k, v, masked, kv_lens, rate, seed, place=None):
        counts["flash"] += 1
        counts["flash_dropout"] += rate > 0
        return fl_fwd(q, k, v, masked, kv_lens, rate, seed, place)
    monkeypatch.setattr(tnorm, "_forward", ln)
    monkeypatch.setattr(tflash, "_forward", fl)
    return counts


def _expected(cfg, training):
    """LayerNorms and flash calls (with dropout) of one forward: BERT's
    embedding norm and 2 per layer, 3 per encoder layer and a final one,
    and in training one more per encoder layer (V embedded apart from K);
    MAG's norm; one attention per BERT and first-round layer, and per
    second-round layer two in mmtrvapt (biprojection) and one in mmtrvat;
    dropout in BERT and in the encoders whose rate is > 0 (both rounds
    have the same table of rates)."""
    L, Lb = cfg.layers, cfg.bert.num_layers
    ln = (1 + 2 * Lb + 12 * (3 * L + 1) + (12 * L if training else 0)
          + (cfg.fusion == "mag"))
    per_second = 2 if cfg.model == "mmtrvapt" else 1
    flash = Lb + 6 * L + 6 * per_second * L
    rated = (lambda r: r > 0)
    first = sum(rated(r) for r in (cfg.attn_dropout_a, cfg.attn_dropout_v,
                                   cfg.attn_dropout, cfg.attn_dropout_a,
                                   cfg.attn_dropout, cfg.attn_dropout_v))
    drop = (Lb * rated(cfg.bert.attention_dropout) + first * L
            + first * per_second * L) if training else 0
    return ln, flash, drop


def _check_structure(model, cfg, inputs, monkeypatch):
    counts = _count_calls(monkeypatch)
    for training in (False, True):
        for key in counts:
            counts[key] = 0
        model.train(training)
        with torch.no_grad():
            model(*inputs, dropout_seed=1 if training else None)
        assert (counts["ln"], counts["flash"], counts["flash_dropout"]) == \
            _expected(cfg, training)
    model.eval()


def test_launch_structure_in_train_mode(tiny_port, monkeypatch):
    """Counted at the wrappers on the CPU path: V embedded separately in
    training raises the LayerNorms per forward, and the rated encoders'
    attentions carry dropout; at moviescope's depth the same formula gives
    181 / 229 LayerNorms and 84 flash calls, 36 with dropout."""
    _, exp, model, inputs = tiny_port
    _check_structure(model, exp.model, inputs, monkeypatch)
    from bpx_torch.config import get_preset
    full = get_preset("moviescope").model
    assert _expected(full, False) == (181, 84, 0)
    assert _expected(full, True) == (229, 84, 36)


@pytest.mark.parametrize("fusion", ["gmu", "mag"])
def test_mmtrvat_launch_structure_in_train_mode(fusion, monkeypatch):
    """The same count for mmtrvat (plain second round: one attention per
    layer); at iemocap's depth 325 / 421 LayerNorms and 108 flash calls,
    44 with dropout (BERT's 12 and the l-keyed encoders' 4 x 8), and MAG
    one LayerNorm more."""
    jexp, exp, _ = tiny_vat(fusion)
    model = get_model(exp.model, device="cpu", seed=3)
    inputs = [_t(v) for v in jmodel_inputs("mmtrvat",
                                            _batch(jexp, 3, seed=6))]
    _check_structure(model, exp.model, inputs, monkeypatch)
    from bpx_torch.config import get_preset
    full = get_preset("iemocap").model.replace(fusion=fusion)
    mag = int(fusion == "mag")
    assert _expected(full, False) == (325 + mag, 108, 0)
    assert _expected(full, True) == (421 + mag, 108, 44)


def test_mag_dropout_follows_the_seed():
    """MAG's dropout (rate 0.5) in training mode is the hash mask of the
    next seed of the forward's stream on its eval-mode output, bit for
    bit; in the model (every other rate 0) the same base seed gives the
    same logits, another base other logits."""
    from bpx_torch.ops.dropout import SeedStream, hash_keep
    from bpx_torch.ops.mag import MAG
    rng = np.random.RandomState(21)
    t, v, a = (_t(rng.randn(6, 40).astype(np.float32)) for _ in range(3))
    mag = MAG(40, gen=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mag.eval()
        want, alpha = mag(t, v, a)
        mag.train()
        got, alpha_t = mag(t, v, a, SeedStream(77))
    keep = hash_keep(SeedStream(77).next(), want.shape, 0.5)
    assert torch.equal(got, torch.where(keep, want / 0.5, 0.0))
    assert torch.equal(alpha, alpha_t) and 0 < keep.float().mean() < 1

    jexp, _, _ = tiny_vat("mag")
    exp = config_from_dict(dataclasses.asdict(_no_dropout(jexp)))
    model = get_model(exp.model, device="cpu", seed=4).train()
    inputs = [_t(x) for x in jmodel_inputs("mmtrvat",
                                           _batch(jexp, 3, seed=7))]
    with torch.no_grad():
        x = model(*inputs, dropout_seed=11)
        y = model(*inputs, dropout_seed=11)
        z = model(*inputs, dropout_seed=12)
        model.eval()
        e = model(*inputs)
    assert torch.equal(x, y)
    assert not torch.allclose(x, z)
    assert not torch.allclose(x, e)


def test_eval_step(tiny_port):
    _, exp, model, inputs = tiny_port
    batch = dict(zip(("txt", "mask", "segment", "video", "audio", "poster"),
                     inputs))
    batch["target"] = torch.zeros(3, exp.model.n_classes)
    step = make_eval_step(model, "mmtrvapt",
                          losses.make_loss_fn("synthetic", "multilabel",
                                              False), output_gates=True)
    model.train()
    out = step(batch)
    assert not model.training
    assert out["logits"].shape == (3, exp.model.n_classes)
    assert out["gates"].shape == (3, 4 * exp.model.hidden_sz)
    assert out["loss"].dim() == 0 and out["logits"].grad_fn is None
    with torch.no_grad():
        assert torch.equal(out["logits"], model(*inputs))


def test_training_after_serving_in_one_process(tiny_port):
    """A forward under inference_mode (the Predictor's) must not leave
    cached inference tensors that a later training forward saves for its
    backward (the audio encoder's pooling matrix did)."""
    from bpx_torch.ops.audio import adaptive_avg_pool_matrix
    _, _, model, inputs = tiny_port
    adaptive_avg_pool_matrix.cache_clear()
    model.eval()
    with torch.inference_mode():
        model(*inputs)
    model.train()
    model(*inputs, dropout_seed=1).sum().backward()
    assert model.audio_enc.conv1.weight.grad is not None
    model.zero_grad(set_to_none=True)
    model.eval()
