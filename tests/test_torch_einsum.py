"""The einsum attention path (``attention_impl`` other than ``"pallas"``)
against the JAX package's XLA attention, and which path the config
chooses.  The encoder and BERT on that path (BERT: unscaled q, scores
divided by sqrt(head_dim) in fp32, the additive key-padding bias), the tiny
mmtrvapt served and trained in lockstep, the attention dropout on the
probabilities bit for bit, and the flash wrappers called exactly where the
config says ``"pallas"`` and nowhere else.

Tolerances as in ``tests/test_torch_model.py`` and
``tests/test_torch_train.py``; the dropout check is exact up to fp32
rounding of the same products (1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.config import BertConfig as JBertConfig
from bpx.models import get_model as jget_model
from bpx.ops.bert import BertEncoder as JBertEncoder
from bpx.ops.encoder import TransformerEncoder as JTransformerEncoder
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import flax_to_state_dict, params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops.bert import BertEncoder
from bpx_torch.ops.encoder import TransformerEncoder
from bpx_torch.serve import Predictor
from tests.test_torch_model import (TOL, _batch, _fp32_matmuls,  # noqa: F401
                                    _np_tree, _t, _tiny_experiment)
from tests.test_torch_train import (FREQS, _count_calls, _expected, _lockstep,
                                    _no_dropout)


@pytest.mark.parametrize("biprojection", [False, True])
def test_einsum_encoder_matches_bpx(biprojection):
    """The einsum attention (``attention_impl="xla"``) in both packages:
    fp32 scores plus the additive band, softmax, the product with V."""
    B, Tq, Tk, E, H = 2, 12, 20, 32, 4
    rng = np.random.RandomState(16)
    x = rng.randn(B, Tq, E).astype(np.float32)
    xk = rng.randn(B, Tk, E).astype(np.float32)
    jenc = JTransformerEncoder(embed_dim=E, num_heads=H, layers=2,
                               attn_mask=True, biprojection=biprojection,
                               attention_impl="xla")
    xj, xkj = jnp.asarray(x), jnp.asarray(xk)
    params = jenc.init(jax.random.PRNGKey(1), xj, xkj, xkj)["params"]
    want = jenc.apply({"params": params}, xj, xkj, xkj)

    enc = TransformerEncoder(E, H, 2, attn_mask=True,
                             biprojection=biprojection, attention_impl="xla")
    enc.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    xkt = _t(xk)
    with torch.no_grad():
        got = enc(_t(x), xkt, xkt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_einsum_bert_matches_bpx():
    """BERT on the einsum path: unscaled q, scores divided by sqrt(head_dim)
    in fp32, the additive key-padding bias (a sample with one real token
    included)."""
    cfg = dataclasses.replace(JBertConfig.tiny(vocab_size=50), hidden_size=32,
                              num_heads=2, intermediate_size=48)
    B, T = 3, 16
    rng = np.random.RandomState(17)
    lens = np.array([16, 9, 1])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(1, 50, size=(B, T)) * mask).astype(np.int32)
    seg = rng.randint(0, 2, size=(B, T)).astype(np.int32)
    jbert = JBertEncoder(cfg, attention_impl="xla")
    params = jbert.init(jax.random.PRNGKey(3), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(seg))["params"]
    want = jbert.apply({"params": params}, jnp.asarray(ids),
                       jnp.asarray(mask), jnp.asarray(seg))

    from bpx_torch.config import BertConfig
    bert = BertEncoder(BertConfig(**dataclasses.asdict(cfg)),
                       attention_impl="xla").eval()
    bert.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = bert(_t(ids), _t(mask), _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_served_mmtrvapt_on_the_einsum_path_matches_bpx():
    """The tiny mmtrvapt with ``attention_impl="xla"`` (BERT inheriting
    it), served by both packages."""
    jexp = _tiny_experiment()
    jexp = jexp.replace(model=jexp.model.replace(attention_impl="xla"))
    inputs = jmodel_inputs("mmtrvapt", {k: jnp.asarray(v)
                                        for k, v in _batch(jexp, 1).items()})
    params = jget_model(jexp.model).init({"params": jax.random.PRNGKey(5)},
                                         *inputs)["params"]
    exp = config_from_dict(dataclasses.asdict(jexp))
    batch = _batch(jexp, 4, seed=2)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), exp.model),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)


def test_einsum_path_train_step_lockstep_with_bpx():
    """The tiny mmtrvapt with ``attention_impl="xla"`` (BERT inheriting
    it): the einsum attention's backward through autograd."""
    jexp = _no_dropout(_tiny_experiment())
    _lockstep(jexp.replace(model=jexp.model.replace(attention_impl="xla")),
              FREQS)


def test_einsum_attention_dropout_follows_the_seed():
    """On the einsum path the attention dropout (rate 0.25) is the hash
    mask of the next seed of the forward's stream on the softmax
    probabilities, bit for bit; in a model on that path the same base seed
    gives the same logits, another base other logits."""
    from bpx_torch.ops.attention import dot_product_attention
    from bpx_torch.ops.dropout import SeedStream, hash_keep
    from bpx_torch.ops.masks import band_bias
    rng = np.random.RandomState(22)
    q, k, v = (_t(rng.randn(2, 3, n, 16).astype(np.float32))
               for n in (12, 20, 20))
    bias = band_bias(12, 20)
    probs = torch.softmax(q @ k.transpose(-1, -2) + bias, -1)
    keep = hash_keep(SeedStream(78).next(), probs.shape, 0.25)
    want = torch.where(keep, probs / 0.75, 0.0) @ v
    got = dot_product_attention(q, k, v, bias, 0.25, True, SeedStream(78))
    assert 0 < keep.float().mean() < 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(dot_product_attention(q, k, v, bias, 0.25, False),
                       dot_product_attention(q, k, v, bias))

    jexp = _tiny_experiment()
    exp = config_from_dict(dataclasses.asdict(jexp.replace(
        model=jexp.model.replace(attention_impl="xla"))))
    model = get_model(exp.model, device="cpu", seed=5).train()
    inputs = [_t(x) for x in jmodel_inputs("mmtrvapt",
                                           _batch(jexp, 3, seed=8))]
    with torch.no_grad():
        x = model(*inputs, dropout_seed=21)
        y = model(*inputs, dropout_seed=21)
        z = model(*inputs, dropout_seed=22)
    model.eval()
    assert torch.equal(x, y)
    assert not torch.allclose(x, z)


@pytest.mark.parametrize("impl,bert_impl", [
    ("pallas", None), ("xla", None), ("xla", "pallas"), ("pallas", "xla")])
def test_attention_impl_chooses_the_path(monkeypatch, impl, bert_impl):
    """``attention_impl`` (and ``bert_attention_impl``, None inheriting it)
    chooses each attention: a "pallas" one calls the flash wrapper, exactly
    as counted from the structure; any other the einsum attention, which
    calls no flash wrapper.  LayerNorms do not move."""
    jexp = _tiny_experiment()
    exp = config_from_dict(dataclasses.asdict(jexp.replace(
        model=jexp.model.replace(attention_impl=impl,
                                 bert_attention_impl=bert_impl))))
    cfg = exp.model
    model = get_model(cfg, device="cpu", seed=6)
    inputs = [_t(x) for x in jmodel_inputs("mmtrvapt",
                                           _batch(jexp, 2, seed=9))]
    counts = _count_calls(monkeypatch)
    for training in (False, True):
        for key in counts:
            counts[key] = 0
        model.train(training)
        with torch.no_grad():
            model(*inputs, dropout_seed=1 if training else None)
        ln, flash, drop = _expected(cfg, training)
        Lb = cfg.bert.num_layers
        bert_drop = Lb * (training and cfg.bert.attention_dropout > 0)
        on_bert = (bert_impl or impl) == "pallas"
        on_encoders = impl == "pallas"
        assert counts["ln"] == ln
        assert counts["flash"] == Lb * on_bert + (flash - Lb) * on_encoders
        assert counts["flash_dropout"] == (bert_drop * on_bert
                                           + (drop - bert_drop)
                                           * on_encoders)
    model.eval()
