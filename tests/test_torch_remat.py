"""Recompute (``remat``) in the port, the counterpart of the JAX package's
``jax.checkpoint`` per encoder and BERT layer.

With every dropout above 0, the gradients of one training forward and
backward with recompute equal those without, bit for bit on the CPU, at
``remat_policy`` None and ``"save_attn"`` and ``remat_bert`` True and False:
the replay draws the first pass's dropout seeds.  A replay that draws fresh
seeds (the trap of a stream that hands seeds out in call order) must break
that equality.  A dispatch mode counts the ops: full recompute reruns every
flash forward and LayerNorm inside a recomputed layer, ``save_attn`` reruns
no flash forward.  Without dropout, the train step with recompute runs in
lockstep with ``bpx.train.steps.make_train_step`` with the same remat
settings, at tests/test_torch_train.py's tolerances (losses rtol 2e-3 / atol
2e-4, the gradients' norm 1e-3).  Tiny fp32 configs; inputs made with numpy
from a seed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train import optim as joptim
from bpx.train.state import TrainState
from bpx.train.steps import make_train_step as jmake_train_step
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.inputs import model_inputs
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import encoder
from bpx_torch.ops.dropout import SeedStream
from bpx_torch.train import losses, optim
from bpx_torch.train.steps import make_train_step
from tests.test_torch_model import (_batch, _tiny_experiment,
                                    _tiny_vat_experiment)
from tests.test_torch_train import A, LR, _no_dropout, _super_batch
from tests.test_torch_loop import few_threads  # noqa: F401

EXPERIMENTS = {"mmtrvapt": _tiny_experiment, "mmtrvat": _tiny_vat_experiment}
FLASH = "bpx_torch.flash_fwd.default"
LN = "bpx_torch.layer_norm.default"


def _every_dropout(m):
    return m.replace(
        attn_dropout=0.1, attn_dropout_a=0.2, attn_dropout_v=0.15,
        relu_dropout=0.1, res_dropout=0.1, out_dropout=0.1,
        embed_dropout=0.25,
        bert=dataclasses.replace(m.bert, hidden_dropout=0.1,
                                 attention_dropout=0.1))


class _OpCount(TorchDispatchMode):
    """Calls of each op below autograd, recomputed ones included."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] = self.n.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def _kept(name):
    """:func:`_step` without recompute, once per model."""
    return _step(name, remat=False)


def _step(name, **remat):
    """Loss, parameter gradients and op counts of one training forward and
    backward of the tiny ``name`` model with every dropout on."""
    jexp = EXPERIMENTS[name]()
    m = _every_dropout(config_from_dict(dataclasses.asdict(jexp)).model)
    model = get_model(m.replace(**remat), device="cpu", seed=3).train()
    batch = {k: torch.from_numpy(v) for k, v in _batch(jexp, 3).items()}
    count = _OpCount()
    with count:
        logits = model(*model_inputs(name, batch), dropout_seed=77)
        loss = logits.float().pow(2).mean()
        loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}, count.n


def _recomputed_calls(m, policy, remat_bert):
    """(flash forwards, LayerNorms) a backward reruns: per recomputed BERT
    layer one attention and two LayerNorms, per recomputed encoder layer
    four LayerNorms (V embedded apart from K in training) and its
    attentions (two in a biprojection layer); ``save_attn`` keeps every
    attention's output."""
    Lb, L = m.bert.num_layers, m.layers
    per_second = 2 if m.model == "mmtrvapt" else 1
    attn = 6 * L + 6 * per_second * L
    full = policy is None
    return (remat_bert * full * Lb + full * attn,
            remat_bert * 2 * Lb + 12 * L * 4)


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
@pytest.mark.parametrize("policy", [None, "save_attn"])
@pytest.mark.parametrize("remat_bert", [True, False])
def test_recompute_gradients_equal_keeping_activations(name, policy,
                                                       remat_bert):
    loss0, grads0, n0 = _kept(name)
    loss, grads, n = _step(name, remat=True, remat_policy=policy,
                           remat_bert=remat_bert, remat_policy_bert=policy)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for p in grads0:
        assert torch.equal(grads[p], grads0[p]), p
    m = config_from_dict(dataclasses.asdict(EXPERIMENTS[name]())).model
    flash, ln = _recomputed_calls(m, policy, remat_bert)
    assert n[FLASH] - n0[FLASH] == flash
    assert n[LN] - n0[LN] == ln
    assert n["bpx_torch.flash_bwd.default"] == n0[FLASH]


def test_a_replay_with_fresh_seeds_is_caught(monkeypatch):
    """A recomputed layer that drew from the outer stream would replay
    later seeds, so other masks: the gradients then differ."""
    _, grads0, _ = _kept("mmtrvat")
    monkeypatch.setattr(SeedStream, "at", lambda self, count: self)
    _, grads, _ = _step("mmtrvat", remat=True)
    assert any(not torch.equal(grads[p], grads0[p]) for p in grads0)


def test_serving_and_evaluation_do_not_recompute(monkeypatch):
    """Recompute runs only in training with grad enabled."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called")
    monkeypatch.setattr(encoder, "checkpoint", refuse)
    jexp = _tiny_vat_experiment()
    m = config_from_dict(dataclasses.asdict(jexp)).model
    model = get_model(m.replace(remat=True, remat_policy="save_attn"),
                      device="cpu", seed=3)
    inputs = model_inputs("mmtrvat", {k: torch.from_numpy(v) for k, v in
                                      _batch(jexp, 2).items()})
    model(*inputs).sum().backward()
    model.train()
    with torch.no_grad():
        model(*inputs, dropout_seed=5)


def test_unknown_remat_policy_raises():
    assert encoder.resolve_remat_policy(None) is None
    with pytest.raises(ValueError, match="unknown remat_policy"):
        encoder.resolve_remat_policy("save_everything")


# ---------------------------------------------------------------------------
# lockstep with bpx
# ---------------------------------------------------------------------------

FREQS = [5, 2, 9, 1, 4, 3, 6, 2]


@pytest.fixture(scope="module")
def vat_params():
    """The tiny mmtrvat without dropout, cut to one encoder and one BERT
    layer, and its bpx parameters."""
    jexp = _no_dropout(_tiny_vat_experiment())
    m = jexp.model
    jexp = jexp.replace(model=m.replace(
        layers=1, bert=dataclasses.replace(m.bert, num_layers=1)))
    first = {k: jnp.asarray(v[0])
             for k, v in _super_batch(jexp, 0).items()}
    params = jget_model(jexp.model).init(
        {"params": jax.random.PRNGKey(0)},
        *jmodel_inputs("mmtrvat", first))["params"]
    return jexp, params


@pytest.mark.parametrize("remat", [
    dict(remat=True),
    dict(remat=True, remat_policy="save_attn", remat_bert=True,
         remat_policy_bert="save_attn")], ids=["full", "save_attn"])
def test_remat_train_step_lockstep_with_bpx(vat_params, remat):
    """Three accumulation steps of both packages with the same remat
    settings, from the same weights and batches: the losses and the
    gradients' global norm at every step."""
    jexp, params = vat_params
    jexp = jexp.replace(model=jexp.model.replace(**remat))
    exp = config_from_dict(dataclasses.asdict(jexp))
    batches = [_super_batch(jexp, s) for s in (0, 1, 2)]
    jloss = jlosses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10)
    tx = joptim.make_optimizer(LR)
    jstep = jax.jit(jmake_train_step(jget_model(jexp.model), "mmtrvat",
                                     jloss, tx, grad_accum=A,
                                     with_grad_norm=True))
    state = TrainState.create(params, tx)
    want = []
    for b in batches:
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(1))
        want.append((float(m["loss"]), float(m["grad_norm"])))

    model = get_model(exp.model, device="cpu")
    assert model.bert.remat and model.trans_l_with_a.remat
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params), exp.model))
    step = make_train_step(
        model, "mmtrvat",
        losses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10),
        optim.make_optimizer(model.parameters(), LR), grad_accum=A,
        with_grad_norm=True)
    got = []
    for b in batches:
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        got.append((float(m["loss"]), float(m["grad_norm"])))
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-3, atol=2e-4,
                               err_msg="loss trajectory diverged")
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-3,
                               err_msg="gradient norms diverged")
    assert got[-1, 0] < got[0, 0]
