"""The port's vmapped multi-seed step (``bpx_torch/train/multiseed.py``).

* Against the JAX package's ``make_multi_seed_train_step``: ``synthetic-tiny``
  cut to one encoder and one BERT layer, ``attention_impl="xla"`` (the one
  bpx can vmap), every dropout rate 0, two seeds; bpx's stacked initial
  weights carried over with ``interop.stacked_params_from_flax``.  SGD, for
  the reason bpx's own test gives (``tests/test_multiseed.py``: Adam's
  first step amplifies near-zero gradients into lr-sized flips).  Losses
  and parameters after one step within atol 1e-5.  (The packages derive
  per-site dropout seeds differently, threefry keys against splitmix64, so
  dropout is compared within the port.)
* With every dropout on, at ``attention_impl="pallas"`` (the flash ops'
  vmap rules, their plain versions on the CPU): each seed of the vmapped
  step against the port's single-seed step (``train/steps.py``) on the
  same weights and base seed, three seeds.  fp32 on the CPU: the losses
  and the gradients agree within 2e-6 of each tensor's largest entry, not
  bitwise (a batched GEMM over the seeds blocks its sums otherwise than
  one seed's GEMM); the masks are bit for bit (``test_torch_vmap_ops.py``).
* ``grad_norm`` per seed; Adam, AdamW and RAdam on stacked tensors equal
  each seed's own optimizer; ``unstack_seed`` saved by ``CheckpointManager``
  and served by ``Predictor``; ``remat`` runs, an unknown model raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bpx import config as jconfig
from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train import multiseed as jmultiseed

from bpx_torch.config import config_from_dict
from bpx_torch.data.synthetic import example_batch
from bpx_torch.inputs import model_inputs
from bpx_torch.interop import stacked_params_from_flax
from bpx_torch.models import get_model
from bpx_torch.serve import Predictor
from bpx_torch.train.losses import make_loss_fn
from bpx_torch.train.multiseed import (init_multi_seed,
                                       make_multi_seed_train_step,
                                       unstack_seed)
from bpx_torch.train.optim import make_optimizer
from bpx_torch.train.steps import make_train_step
from bpx_torch.utils.checkpoint import CheckpointManager

BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(dropout: bool, attention_impl: str = "xla"):
    """(bpx experiment, port experiment): synthetic-tiny at depth 1."""
    jexp = jconfig.get_preset("synthetic-tiny")
    m = jexp.model
    m = m.replace(layers=1, attention_impl=attention_impl,
                  bert=dataclasses.replace(m.bert, num_layers=1))
    if not dropout:
        m = m.replace(attn_dropout=0.0, attn_dropout_a=0.0,
                      attn_dropout_v=0.0, relu_dropout=0.0, res_dropout=0.0,
                      out_dropout=0.0, embed_dropout=0.0,
                      bert=dataclasses.replace(m.bert, hidden_dropout=0.0,
                                               attention_dropout=0.0))
    jexp = jexp.replace(model=m)
    return jexp, config_from_dict(dataclasses.asdict(jexp))


def torch_batch(exp):
    return {k: torch.from_numpy(v) for k, v in example_batch(exp, BATCH)
            .items() if k != "valid"}


def loss_fn(exp):
    return make_loss_fn(exp.data.task, exp.data.task_type, False)


def test_multiseed_step_matches_bpx():
    jexp, exp = tiny(dropout=False)
    seeds = [3, 9]
    batch = torch_batch(exp)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = jget_model(jexp.model)
    tx = optax.sgd(1e-3)
    jstates = jmultiseed.init_multi_seed(jmodel, jexp.model.model, jbatch, tx,
                                         seeds)
    jstep = jax.jit(jmultiseed.make_multi_seed_train_step(
        jmodel, jexp.model.model,
        jlosses.make_loss_fn(jexp.data.task, jexp.data.task_type, False),
        tx))
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    jnew, jmetrics = jstep(jstates, jbatch, rngs)

    state = init_multi_seed(exp.model, seeds,
                            lambda ps: torch.optim.SGD(ps, lr=1e-3),
                            device="cpu")
    carried = stacked_params_from_flax(
        jax.tree.map(np.asarray, jstates.params), exp.model)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(carried[k])
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(batch)
    assert metrics["loss"].shape == (2,)
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), atol=1e-5)
    want = stacked_params_from_flax(jax.tree.map(np.asarray, jnew.params),
                                    exp.model)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)


def single_step(exp, state_dict, seed, with_grad_norm=False):
    """The port's single-seed A = 1 step (Adam) on ``state_dict``, its
    dropout base seed drawn from a generator seeded with ``seed``: (model,
    optimizer, metrics)."""
    model = get_model(exp.model, device="cpu").train()
    model.load_state_dict(state_dict)
    opt = make_optimizer(model.parameters(), 1e-3)
    step = make_train_step(model, exp.model.model, loss_fn(exp), opt,
                           generator=torch.Generator().manual_seed(seed),
                           with_grad_norm=with_grad_norm)
    metrics = step({k: v[None] for k, v in torch_batch(exp).items()})
    return model, opt, metrics


@pytest.fixture(scope="module")
def dropout_run():
    """Three seeds through one vmapped Adam step with every dropout on, at
    attention_impl "pallas", and the initial weights of each seed."""
    _, exp = tiny(dropout=True, attention_impl="pallas")
    seeds = [3, 9, 27]
    state = init_multi_seed(exp.model, seeds,
                            lambda ps: make_optimizer(ps, 1e-3),
                            device="cpu")
    initial = [unstack_seed(state, i)[0] for i in range(len(seeds))]
    metrics = make_multi_seed_train_step(
        state, loss_fn(exp), with_grad_norm=True)(torch_batch(exp))
    return exp, seeds, state, initial, metrics


def test_each_seed_with_dropout_is_its_own_single_seed_step(dropout_run):
    exp, seeds, state, initial, metrics = dropout_run
    assert len(set(metrics["loss"].tolist())) == len(seeds)
    for i, seed in enumerate(seeds):
        model, _, single = single_step(exp, initial[i], seed)
        torch.testing.assert_close(metrics["loss"][i], single["loss"],
                                   rtol=0, atol=2e-6)
        for name, p in model.named_parameters():
            g, want = state.params[name].grad[i], p.grad
            scale = want.abs().max().item()
            assert (g - want).abs().max().item() <= 2e-6 * max(scale, 1e-6), \
                (seed, name)


def test_grad_norm_is_per_seed(dropout_run):
    exp, seeds, _, initial, metrics = dropout_run
    assert metrics["grad_norm"].shape == (len(seeds),)
    for i, seed in enumerate(seeds):
        _, _, single = single_step(exp, initial[i], seed,
                                   with_grad_norm=True)
        torch.testing.assert_close(metrics["grad_norm"][i],
                                   single["grad_norm"], rtol=1e-5, atol=0)


def test_seeds_start_as_their_single_seed_models(dropout_run):
    exp, seeds, _, initial, _ = dropout_run
    for i, seed in enumerate(seeds):
        want = get_model(exp.model, device="cpu", seed=seed).state_dict()
        assert set(initial[i]) == set(want)
        for k in want:
            assert torch.equal(initial[i][k], want[k]), (seed, k)


@pytest.mark.parametrize("name", ["adam", "adamw", "radam"])
def test_stacked_optimizer_steps_each_seed_as_its_own(name):
    """The optimizers are elementwise with one shared step count: stepping
    (S, ...) tensors equals stepping each seed's slice with its own
    optimizer, bit for bit, over a few steps."""
    rng = np.random.RandomState(0)
    S, shapes = 3, [(4, 5), (7,)]
    stacked = [torch.tensor(rng.randn(S, *s), dtype=torch.float32,
                            requires_grad=True) for s in shapes]
    per_seed = [[p[i].detach().clone().requires_grad_() for p in stacked]
                for i in range(S)]
    opt = make_optimizer(stacked, 1e-2, name)
    opts = [make_optimizer(ps, 1e-2, name) for ps in per_seed]
    for _ in range(6):
        grads = [torch.tensor(rng.randn(S, *s), dtype=torch.float32)
                 for s in shapes]
        for p, g in zip(stacked, grads):
            p.grad = g.clone()
        opt.step()
        for i, o in enumerate(opts):
            for p, g in zip(per_seed[i], grads):
                p.grad = g[i].clone()
            o.step()
    for i in range(S):
        for p, q in zip(stacked, per_seed[i]):
            torch.testing.assert_close(p[i], q, rtol=0, atol=0)


def test_unstacked_seed_checkpoints_and_serves(dropout_run, tmp_path):
    exp, seeds, state, _, _ = dropout_run
    model_sd, opt_sd = unstack_seed(state, 1)
    model = get_model(exp.model, device="cpu")
    model.load_state_dict(model_sd)
    opt = make_optimizer(model.parameters(), 1e-3)
    opt.load_state_dict(opt_sd)
    for p, name in zip(model.parameters(), state.params):
        torch.testing.assert_close(opt.state[p]["exp_avg"],
                                   state.optimizer.state[
                                       state.params[name]]["exp_avg"][1],
                                   rtol=0, atol=0)
    run = tmp_path / "run"
    CheckpointManager(str(run)).save(model, opt, 1, {"epoch": 1},
                                     is_best=True)
    pred = Predictor.from_checkpoint(exp, str(run), batch_size=BATCH,
                                     device="cpu")
    batch = example_batch(exp, BATCH)
    probs = pred(batch)
    model.eval()
    with torch.no_grad():
        logits = model(*model_inputs(exp.model.model, torch_batch(exp)))
    np.testing.assert_allclose(probs, torch.sigmoid(logits).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_remat_is_refused():
    """Recompute now runs under the seed vmap (held against bpx and the
    single-seed step in ``test_torch_multiseed_remat.py``); a model name
    the registry lacks still raises."""
    _, exp = tiny(dropout=False)
    state = init_multi_seed(exp.model.replace(remat=True), [1, 2],
                            lambda ps: torch.optim.SGD(ps, lr=1e-3),
                            device="cpu")
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(
        torch_batch(exp))
    assert metrics["loss"].shape == (2,)
    assert torch.isfinite(metrics["loss"]).all()
    with pytest.raises(KeyError, match="unknown model"):
        init_multi_seed(exp.model.replace(model="mmtrvxyz"), [1, 2],
                        lambda ps: None, device="cpu")


def test_stacked_interop_rejects_a_leftover_key():
    jexp, exp = tiny(dropout=False)
    jbatch = {k: jnp.asarray(v.numpy())
              for k, v in torch_batch(exp).items()}
    states = jmultiseed.init_multi_seed(jget_model(jexp.model),
                                        jexp.model.model, jbatch,
                                        optax.sgd(1e-3), [1, 2])
    tree = jax.tree.map(np.asarray, states.params)
    tree = dict(tree, stray={"kernel": np.zeros((2, 3, 4), np.float32)})
    with pytest.raises(KeyError, match="left over"):
        stacked_params_from_flax(tree, exp.model)
