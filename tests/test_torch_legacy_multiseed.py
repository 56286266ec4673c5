"""The notebook-era models (``bpx_torch/models/legacy.py``) through the
vmapped multi-seed step and ``Predictor.export``.

* Every name: the exported archive served by ``ExportedPredictor`` equals
  the eager ``Predictor`` within 1e-6 (probabilities and gates); the
  multi-seed step with recompute and every dropout, each seed against the
  port's single-seed step with the same recompute within 1e-5 of each
  tensor's largest entry (a bias gradient sums terms that cancel: one
  entry of tmmtrvpa's ``transfm_v2l.bias`` differs by 4.5e-6 of it), the
  key biases, whose gradient is 0 in exact arithmetic, below 1e-7 of the
  step's largest gradient on both sides.
* mmtrvpa, gmu_hier and bertclf: the multi-seed step against the JAX
  package's ``make_multi_seed_train_step`` at ``attention_impl="xla"``,
  every dropout rate 0, SGD, two seeds, bpx's stacked initial weights
  carried over; losses and parameters after one step within atol 1e-5.

The config is ``tests/test_torch_legacy_models.py``'s tiny moviescope
pattern (hidden 24 over 2 heads, 1 layer, BERT 32 wide), fp32 on the CPU.
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
from bpx.train import multiseed as jmultiseed

from bpx_torch.config import config_from_dict
from bpx_torch.interop import stacked_params_from_flax
from bpx_torch.models import get_model
from bpx_torch.serve import ExportedPredictor, Predictor
from bpx_torch.train.losses import make_loss_fn
from bpx_torch.train.multiseed import (init_multi_seed,
                                       make_multi_seed_train_step)
from bpx_torch.train.optim import make_optimizer
from bpx_torch.train.steps import make_train_step
from tests.test_torch_legacy_models import LEGACY, legacy_experiment
from tests.test_torch_model import _batch
from tests.test_torch_train import _no_dropout

BATCH = 2
SEEDS = [3, 9]
#: the key projections' biases: the softmax over keys cancels a bias that
#: every key shares, so their gradient is 0 up to rounding
KEY_BIASES = ("key.bias", "k_proj.bias")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def host_batch(jexp):
    """A numpy batch with ragged text and multilabel targets."""
    b = _batch(jexp, BATCH, seed=4)
    rng = np.random.RandomState(5)
    b["target"] = (rng.rand(BATCH, jexp.model.n_classes)
                   > 0.6).astype(np.float32)
    return b


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def loss_fn(exp):
    return make_loss_fn(exp.data.task, exp.data.task_type, False)


@pytest.mark.parametrize("name", LEGACY)
def test_exported_legacy_model_serves_as_the_predictor(name):
    exp = config_from_dict(dataclasses.asdict(legacy_experiment(name)))
    batch = host_batch(legacy_experiment(name))
    pred = Predictor(exp, batch_size=BATCH, device="cpu", seed=1)
    served = ExportedPredictor(pred.export(batch))
    assert served.batch_size == BATCH
    for got, want in zip(served(batch, return_gates=True),
                         pred(batch, return_gates=True)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", LEGACY)
def test_recomputed_legacy_multiseed_step_is_each_seeds_own(name):
    exp = config_from_dict(dataclasses.asdict(legacy_experiment(name)))
    exp = exp.replace(model=exp.model.replace(remat=True))
    batch = torch_batch(host_batch(legacy_experiment(name)))
    state = init_multi_seed(exp.model, SEEDS,
                            lambda ps: make_optimizer(ps, 1e-3),
                            device="cpu")
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(batch)
    assert metrics["loss"].shape == (len(SEEDS),)
    for i, seed in enumerate(SEEDS):
        model = get_model(exp.model, device="cpu", seed=seed).train()
        step = make_train_step(model, name, loss_fn(exp),
                               make_optimizer(model.parameters(), 1e-3),
                               generator=torch.Generator().manual_seed(seed))
        one = step({k: v[None] for k, v in batch.items()})
        torch.testing.assert_close(metrics["loss"][i], one["loss"], rtol=0,
                                   atol=2e-6)
        top = max(p.grad.abs().max().item() for p in model.parameters())
        for k, p in model.named_parameters():
            g, want = state.params[k].grad[i], p.grad
            if k.endswith(KEY_BIASES):
                # zero in exact arithmetic: both are rounding residue
                assert max(g.abs().max(), want.abs().max()) <= 1e-7 * top, \
                    (seed, k)
                continue
            scale = want.abs().max().item()
            assert (g - want).abs().max().item() <= 1e-5 * scale, (seed, k)


@pytest.mark.parametrize("name", ["mmtrvpa", "gmu_hier", "bertclf"])
def test_legacy_multiseed_step_matches_bpx(name):
    jexp = _no_dropout(legacy_experiment(name))
    m = jexp.model
    jexp = jexp.replace(model=m.replace(attention_impl="xla",
                                        bert_attention_impl="xla"))
    exp = config_from_dict(dataclasses.asdict(jexp))
    batch = host_batch(jexp)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jget_model(jexp.model)
    tx = optax.sgd(1e-3)
    jstates = jmultiseed.init_multi_seed(jmodel, name, jbatch, tx, SEEDS)
    jstep = jax.jit(jmultiseed.make_multi_seed_train_step(
        jmodel, name,
        jlosses.make_loss_fn(jexp.data.task, jexp.data.task_type, False),
        tx))
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS))
    jnew, jmetrics = jstep(jstates, jbatch, rngs)

    state = init_multi_seed(exp.model, SEEDS,
                            lambda ps: torch.optim.SGD(ps, lr=1e-3),
                            device="cpu")
    carried = stacked_params_from_flax(
        jax.tree.map(np.asarray, jstates.params), exp.model)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(carried[k])
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(
        torch_batch(batch))
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), atol=1e-5)
    want = stacked_params_from_flax(jax.tree.map(np.asarray, jnew.params),
                                    exp.model)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)
