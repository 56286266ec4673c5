"""The port's sharded train step against the JAX package's single-device
step: moviescope's mmtrvapt pattern, shrunk, on gloo ranks.

bpx takes one SGD step (grad_accum 2, dropout off, fp32) on one CPU device
from its initial weights; the port takes the same step from those weights
(``interop.params_from_flax``) on a ``(data, fsdp, tensor)`` mesh of gloo
processes (``tests/_torch_distributed.py``): data=2 (DDP), fsdp=2
(FSDP2), data=2 x tensor=2 (DDP over the tensor split) and 2 x 2 x 2
(HSDP over the split, world 8).  The whole weights after the step,
gathered from the ranks, and the loss must be bpx's within atol 1e-4, the
limit of bpx's own sharded-step tests; every rank must report the same.
The model has one encoder layer and one BERT layer (bpx's compile time
grows with depth) with two heads everywhere, so the tensor split cuts
every attention, FFN and BERT layer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bpx.config import BertConfig as JBertConfig
from bpx.config import get_preset as jget_preset
from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train.state import TrainState
from bpx.train.steps import make_train_step as jmake_train_step
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import params_from_flax
from tests import _torch_distributed as td

A, MICRO = 2, 4
LR = 0.1
FREQS = [5, 2, 9, 1, 4]
TOL = dict(rtol=0, atol=1e-4)


def no_dropout(model):
    return model.replace(
        attn_dropout=0.0, attn_dropout_a=0.0, attn_dropout_v=0.0,
        relu_dropout=0.0, res_dropout=0.0, out_dropout=0.0,
        embed_dropout=0.0,
        bert=dataclasses.replace(model.bert, hidden_dropout=0.0,
                                 attention_dropout=0.0))


def tiny_vapt():
    """synthetic-tiny's mmtrvapt at hidden 32 over 2 heads, one encoder
    and one BERT layer, Tl != Ta (both bands), fp32, the flash path."""
    exp = jget_preset("synthetic-tiny")
    model = exp.model.replace(
        hidden_sz=32, num_heads=2, layers=1,
        num_vectors_l=24, num_vectors_a=12, num_vectors_v=12,
        orig_d_l=32, orig_d_v=20, orig_d_a=8, orig_d_p=16,
        attention_impl="pallas", compute_dtype="float32",
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2, num_layers=1,
                                 intermediate_size=64, gelu="tanh"))
    data = dataclasses.replace(exp.data, audio_raw_len=400, video_len=12)
    return exp.replace(model=model, data=data)


def super_batch(jexp, seed, classes=None):
    """An (A, MICRO, ...) super-batch: multilabel targets, or class
    indices when ``classes`` is given."""
    rng = np.random.RandomState(seed)
    m, d = jexp.model, jexp.data
    n = A * MICRO
    lens = rng.randint(4, m.num_vectors_l + 1, size=n)
    lens[0] = m.num_vectors_l
    mask = np.arange(m.num_vectors_l)[None, :] < lens[:, None]
    txt = rng.randint(1, m.bert.vocab_size, size=(n, m.num_vectors_l))
    b = {"txt": (txt * mask).astype(np.int32),
         "mask": mask.astype(np.int32),
         "segment": np.zeros((n, m.num_vectors_l), np.int32),
         "video": rng.rand(n, d.video_len, m.orig_d_v).astype(np.float32),
         "audio": rng.rand(n, d.audio_raw_len, m.orig_d_a).astype(np.float32)}
    if m.model == "mmtrvapt":
        b["poster"] = rng.rand(n, m.orig_d_p).astype(np.float32)
    b["target"] = (rng.randint(0, classes, size=n).astype(np.int32)
                   if classes else
                   (rng.rand(n, m.n_classes) > 0.6).astype(np.float32))
    return {k: v.reshape(A, MICRO, *v.shape[1:]) for k, v in b.items()}


def bpx_sgd_step(jexp, batch, task, task_type, freqs):
    """bpx's initial weights, and its loss and weights after one SGD step
    on one device, as port state dicts."""
    name = jexp.model.model
    jmodel = jget_model(jexp.model)
    first = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         *jmodel_inputs(name, first))["params"]
    tx = optax.sgd(LR)
    step = jax.jit(jmake_train_step(
        jmodel, name, jlosses.make_loss_fn(task, task_type, True, freqs, 10),
        tx, grad_accum=A))
    state, metrics = step(TrainState.create(params, tx),
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(1))
    exp = config_from_dict(dataclasses.asdict(jexp))
    to_port = lambda p: params_from_flax(jax.tree.map(np.asarray, p),
                                         exp.model)
    return to_port(params), float(metrics["loss"]), to_port(state.params)


def sharded_step(tmp_path, jexp, state, batch, layout, task, task_type,
                 freqs):
    """The port's step from ``state`` on a gloo mesh of ``layout``:
    rank 0's result dict (``_torch_distributed.run_steps``)."""
    spec = dict(exp=dataclasses.asdict(jexp), state=state, optimizer="sgd",
                lr=LR, task=task, task_type=task_type, freqs=freqs,
                accum=A, batches=[batch], mesh=layout)
    spec_path, out_path = tmp_path / "spec.pt", tmp_path / "out.pt"
    torch.save(spec, spec_path)
    td.spawn(int(np.prod(layout)), td.step_worker, tmp_path, str(spec_path),
             str(out_path))
    return torch.load(out_path, weights_only=False)


def assert_matches_bpx(got, loss, weights):
    np.testing.assert_allclose(got["loss"][0], loss, **TOL)
    assert set(got["state"]) == set(weights)
    for n, w in weights.items():
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(),
                                   err_msg=n, **TOL)


@pytest.fixture(scope="module")
def bpx_vapt():
    jexp = tiny_vapt()
    jexp = jexp.replace(model=no_dropout(jexp.model))
    batch = super_batch(jexp, 0)
    init, loss, after = bpx_sgd_step(jexp, batch, "synthetic", "multilabel",
                                     FREQS)
    return jexp, batch, init, loss, after


@pytest.mark.parametrize("layout", [(2, 1, 1), (1, 2, 1), (2, 1, 2),
                                    (2, 2, 2)],
                         ids=["data2", "fsdp2", "data2_tensor2", "2x2x2"])
def test_sharded_step_matches_bpx_single_device(tmp_path, bpx_vapt, layout):
    jexp, batch, init, loss, after = bpx_vapt
    got = sharded_step(tmp_path, jexp, init, batch, layout, "synthetic",
                       "multilabel", FREQS)
    assert_matches_bpx(got, loss, after)
    # the weights moved: the comparison is not of the initial weights
    moved = max(float((after[n] - init[n]).abs().max()) for n in init)
    assert moved > 1e-2
