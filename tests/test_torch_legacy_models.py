"""The notebook-era models (``bpx_torch/models/legacy.py``: mmtrvpa,
tmmtrvpa, gmu, gmu_bi, gmu_hier, gmu_softmax, bertclf and its alias bert)
and their new pieces (the GMU variants, GMU input widths, BERT's pooler)
against the JAX package.

Weights are initialised in ``bpx`` and carried over with
``bpx_torch.interop``; inputs are made with numpy from a seed (the text
with ragged lengths) and fed to both.  fp32 on the CPU, where the port's
kernel wrappers compute their plain versions; tolerance 1e-4 (fp32 sums in
another order over a few layers).  The tiny config has hidden 24 beside a
32-wide BERT, so the GMU classifiers' pooled input is wider than the GMU
(``hidden1``, ``transform_1``), and mmtrvpa's memory encoders are 48 wide.
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
from bpx.ops.bert import load_hf_bert_params as jload_hf
from bpx.ops.gmu import GatedBimodalLayer as JBimodal
from bpx.ops.gmu import GatedHierarchicalLayer as JHierarchical
from bpx.ops.gmu import GatedNModalLayer as JNModal
from bpx.ops.gmu import GatedSoftmaxLayer as JSoftmax
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import BertConfig, config_from_dict, get_preset
from bpx_torch.inputs import _INPUT_KEYS
from bpx_torch.interop import flax_to_state_dict, params_from_flax
from bpx_torch.models import MODELS, get_model
from bpx_torch.ops import gmu as tgmu
from bpx_torch.ops.bert import BertEncoder, maybe_load_pretrained
from bpx_torch.serve import Predictor
from tests.test_torch_model import _batch, _tiny_experiment
from tests.test_torch_loop import few_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
LEGACY = ("mmtrvpa", "tmmtrvpa", "gmu", "gmu_bi", "gmu_hier", "gmu_softmax",
          "bertclf", "bert")


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def legacy_experiment(name):
    """The tiny moviescope pattern of ``tests/test_torch_model.py`` as
    model ``name``: hidden 24 over 2 heads (head_dim 12, the memory
    encoders' 24), 1 layer (3 in the memory encoders), BERT 32 wide,
    Tl 24 and Ta = Tv 12, the conv audio encoder, the flash attention's
    plain version, fp32."""
    exp = _tiny_experiment()
    return exp.replace(model=exp.model.replace(model=name, hidden_sz=24,
                                               layers=1))


_TREES = {}


def legacy(name):
    """(bpx experiment, port experiment, bpx params) of ``name``,
    initialised once per name."""
    if name not in _TREES:
        jexp = legacy_experiment(name)
        inputs = jmodel_inputs(name, {k: jnp.asarray(v) for k, v in
                                      _batch(jexp, 1).items()})
        params = jget_model(jexp.model).init(
            {"params": jax.random.PRNGKey(0)}, *inputs)["params"]
        _TREES[name] = (jexp, config_from_dict(dataclasses.asdict(jexp)),
                        params)
    return _TREES[name]


GATES = {"mmtrvpa": 3, "tmmtrvpa": 3, "gmu": 3, "gmu_bi": 2, "gmu_hier": 3,
         "gmu_softmax": 3, "bertclf": 0, "bert": 0}


@pytest.mark.parametrize("name", LEGACY)
def test_served_legacy_model_matches_bpx(name):
    jexp, exp, params = legacy(name)
    m = exp.model
    batch = _batch(jexp, 4, seed=2)
    assert batch["mask"].sum(1).min() < m.num_vectors_l     # ragged text
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), m),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, m.n_classes)
    assert gg.shape == (4, GATES[name] * m.hidden_sz)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)

    # ragged client batch: padded to 4 and sliced back
    small = {k: v[1:3] for k, v in batch.items()}
    wp2, wg2 = want(small, return_gates=True)
    gp2, gg2 = got(small, return_gates=True)
    np.testing.assert_allclose(gp2, np.asarray(wp2, np.float32), **TOL)
    np.testing.assert_allclose(gg2, np.asarray(wg2, np.float32), **TOL)


@pytest.mark.parametrize("name", ["mmtrvpa", "gmu_softmax", "bertclf"])
def test_legacy_logits_without_gates_match_bpx(name):
    """The model called directly, eval mode, without ``output_gates``."""
    jexp, exp, params = legacy(name)
    batch = _batch(jexp, 3, seed=4)
    want = jget_model(jexp.model).apply(
        {"params": params},
        *jmodel_inputs(name, {k: jnp.asarray(v) for k, v in batch.items()}))
    model = get_model(exp.model, device="cpu")
    model.load_state_dict(params_from_flax(_np_tree(params), exp.model))
    with torch.no_grad():
        got = model(*(_t(batch[k]) for k in _INPUT_KEYS[name]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bert_alias_is_bertclf():
    _, exp, params = legacy("bertclf")
    sd = params_from_flax(_np_tree(params), exp.model.replace(model="bert"))
    assert MODELS["bert"] is MODELS["bertclf"]
    assert set(sd) == set(get_model(exp.model, device="meta").state_dict())


@pytest.mark.parametrize("name", ["mmtrvpa", "gmu_hier", "bertclf"])
def test_params_from_flax_legacy_rejects_leftover_and_missing(name):
    _, exp, params = legacy(name)
    tree = _np_tree(params)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="left over"):
        params_from_flax(extra, exp.model)
    bert = {k: v for k, v in tree["bert"].items() if k != "pooler"}
    missing = dict(tree, bert=bert) if "pooler" in tree["bert"] else \
        {k: v for k, v in tree.items() if k != "trans_v_mem"}
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, exp.model)


def test_legacy_structure():
    """mmtrvpa's memory encoders are 2E wide and max(layers, 3) deep; the
    GMU classifiers have no encoder; the full-width moviescope models
    build on the meta device."""
    _, exp, _ = legacy("mmtrvpa")
    model = get_model(exp.model, device="meta")
    assert len(model.trans_l_mem.layers) == 3
    assert model.trans_l_mem.layers[0].attn.num_heads == 2
    assert tuple(model.gmu.hidden1.weight.shape) == (24, 48)
    assert tuple(model.gmu.x_gates.weight.shape) == (72, 144)
    full = get_preset("moviescope").model
    big = get_model(full.replace(model="mmtrvpa"), device="meta")
    mem = big.trans_a_mem.layers[0].attn
    assert 2 * full.hidden_sz // mem.num_heads == 192
    gmu = get_model(full.replace(model="gmu"), device="meta")
    assert not any(n.startswith("trans_") for n, _ in gmu.named_children())
    assert hasattr(gmu.bert, "pooler")


def test_legacy_checks_follow_bpx():
    """tmmtrvpa needs num_vectors_a == num_vectors_v and refuses
    group_encoders, as bpx does; hybrid and MAG, which bpx's notebook-era
    classes ignore, are ignored (the same parameters as without, a warning
    logged)."""
    _, exp, _ = legacy("tmmtrvpa")
    m = exp.model
    with pytest.raises(ValueError, match="num_vectors_a"):
        get_model(m.replace(num_vectors_v=8), device="meta")
    with pytest.raises(ValueError, match="group_encoders"):
        get_model(m.replace(group_encoders=True), device="meta")
    shapes = lambda model: {n: p.shape for n, p in model.named_parameters()}
    for name in ("mmtrvpa", "gmu", "bertclf"):
        plain = shapes(get_model(m.replace(model=name), device="meta"))
        for option in (dict(hybrid=True), dict(fusion="mag")):
            assert shapes(get_model(m.replace(model=name, **option),
                                    device="meta")) == plain
    # lonly / vonly / aonly bind the BPMulT models only
    get_model(m.replace(model="mmtrvpa", lonly=False), device="meta")


def test_export_and_multiseed_refuse_legacy_models():
    """The notebook-era models now export and stack for the multi-seed
    step (held in ``test_torch_legacy_multiseed.py``); a model name the
    registry lacks still raises."""
    from bpx_torch.train.multiseed import init_multi_seed
    jexp, exp, _ = legacy("gmu")
    pred = Predictor(exp, batch_size=2, device="cpu")
    assert len(pred.export(_batch(jexp, 2))) > 0
    state = init_multi_seed(exp.model, [1, 2], lambda p: None, device="cpu")
    assert all(p.shape[0] == 2 for p in state.params.values())
    with pytest.raises(KeyError, match="unknown model"):
        init_multi_seed(exp.model.replace(model="gmu_xyz"), [1, 2],
                        lambda p: None, device="cpu")
    bad = exp.replace(model=exp.model.replace(model="gmu_xyz"))
    with pytest.raises(KeyError, match="unknown model"):
        Predictor(bad, batch_size=2, device="cpu").export(_batch(jexp, 2))


# ---------------------------------------------------------------------------
# the GMU variants, GMU input widths and BERT's pooler alone
# ---------------------------------------------------------------------------

GMU_CASES = {
    # (bpx layer, port layer, input widths, size_out, call with a list)
    "bimodal": (lambda: JBimodal(16), tgmu.GatedBimodalLayer, [20, 16], 16,
                False),
    "nmodal_2e": (lambda: JNModal(3, 16), tgmu.GatedNModalLayer,
                  [32, 32, 32], 16, True),
    "hierarchical": (lambda: JHierarchical(16), tgmu.GatedHierarchicalLayer,
                     [20, 16, 16], 16, False),
    "softmax": (lambda: JSoftmax(16), tgmu.GatedSoftmaxLayer, [20, 16, 12],
                16, False),
}


@pytest.mark.parametrize("case", sorted(GMU_CASES))
def test_gmu_layer_matches_bpx(case):
    jmake, cls, widths, size_out, as_list = GMU_CASES[case]
    rng = np.random.RandomState(7)
    xs = [rng.randn(5, w).astype(np.float32) for w in widths]
    jl = jmake()
    jargs = ([list(map(jnp.asarray, xs))] if as_list
             else list(map(jnp.asarray, xs)))
    params = jl.init(jax.random.PRNGKey(1), *jargs)["params"]
    want_h, want_z = jl.apply({"params": params}, *jargs)
    layer = (cls(len(widths), size_out, in_features=widths) if as_list
             else cls(size_out, in_features=widths))
    layer.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    targs = [list(map(_t, xs))] if as_list else list(map(_t, xs))
    with torch.no_grad():
        got_h, got_z = layer(*targs)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **TOL)
    if case == "softmax":
        # transform_i only where the width differs from size_out
        assert sorted(k for k in params if k.startswith("transform")) == \
            ["transform_1", "transform_3"]
        np.testing.assert_allclose(
            got_z.numpy().reshape(5, 3, size_out).sum(1), 1.0, atol=1e-6)


def test_gmu_input_widths_are_checked():
    with pytest.raises(ValueError, match="input widths"):
        tgmu.GatedNModalLayer(3, 8, in_features=[8, 8])


def _bert_case():
    cfg = dataclasses.replace(JBertConfig.tiny(vocab_size=50), hidden_size=32,
                              num_heads=2, intermediate_size=48)
    B, T = 3, 16
    rng = np.random.RandomState(8)
    lens = np.array([16, 9, 1])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(1, 50, size=(B, T)) * mask).astype(np.int32)
    seg = rng.randint(0, 2, size=(B, T)).astype(np.int32)
    return cfg, ids, mask, seg


@pytest.mark.parametrize("scan", [False, True])
def test_bert_pooler_matches_bpx(scan):
    cfg, ids, mask, seg = _bert_case()
    jbert = JBertEncoder(cfg, with_pooler=True, scan_layers=scan,
                         attention_impl="pallas")
    args = tuple(map(jnp.asarray, (ids, mask, seg)))
    params = jbert.init(jax.random.PRNGKey(0), *args)["params"]
    want_h, want_p = jbert.apply({"params": params}, *args)
    assert set(params["pooler"]) == {"kernel", "bias"}

    bert = BertEncoder(BertConfig(**dataclasses.asdict(cfg)),
                       attention_impl="pallas", with_pooler=True).eval()
    bert.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got_h, got_p = bert(_t(ids), _t(mask), _t(seg))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    # the pooler's init is flax's Dense default: zero bias
    fresh = BertEncoder(BertConfig(**dataclasses.asdict(cfg)),
                        gen=torch.Generator().manual_seed(0),
                        with_pooler=True)
    assert not fresh.pooler.bias.any()


def test_pretrained_bert_keeps_the_models_pooler(tmp_path):
    """bpx's loader reads no pooler from a Hugging Face checkpoint (its
    tree has none), so the port's loads every other BERT weight and keeps
    the model's own pooler."""
    cfg, _, _, _ = _bert_case()
    tcfg = BertConfig(**dataclasses.asdict(cfg))
    donor = BertEncoder(tcfg, gen=torch.Generator().manual_seed(3))
    hf = {}
    names = {"attention.query": "attention.self.query",
             "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention_output": "attention.output.dense",
             "attention_norm": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense", "output": "output.dense",
             "output_norm": "output.LayerNorm"}
    for k, v in donor.state_dict().items():
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            mod, leaf = rest.rsplit(".", 1)
            hf[f"bert.encoder.layer.{i}.{names[mod]}.{leaf}"] = v
        elif k.startswith("embeddings_norm"):
            hf["bert.embeddings.LayerNorm." + k.split(".")[-1]] = v
        else:
            hf["bert.embeddings." + k] = v
    hf["bert.pooler.dense.weight"] = torch.ones(32, 32)
    hf["bert.pooler.dense.bias"] = torch.ones(32)
    torch.save(hf, tmp_path / "pytorch_model.bin")
    assert "pooler" not in jload_hf({k: v.numpy() for k, v in hf.items()},
                                    cfg)
    model = BertEncoder(tcfg, gen=torch.Generator().manual_seed(4),
                        with_pooler=True)
    sd = {f"bert.{k}": v for k, v in model.state_dict().items()}
    got = maybe_load_pretrained(sd, tcfg, str(tmp_path))
    for k, v in donor.state_dict().items():
        assert torch.equal(got[f"bert.{k}"], v), k
    assert torch.equal(got["bert.pooler.weight"], model.pooler.weight)
    assert torch.equal(got["bert.pooler.bias"], model.pooler.bias)
