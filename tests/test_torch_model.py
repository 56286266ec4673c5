"""The port's modules and served models (mmtrvapt, and mmtrvat with its GMU
or MAG fusion) against the JAX package.

Weights are initialised in ``bpx`` and carried over with
``bpx_torch.interop``; inputs are made with numpy from a seed and fed to
both.  Everything runs in fp32 on the CPU, where the port's kernel wrappers
compute their plain versions; tolerance 1e-4 (fp32 sums in another order
over a few layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.config import BertConfig as JBertConfig
from bpx.config import get_preset as jget_preset
from bpx.ops.audio import AudioEncoder as JAudioEncoder
from bpx.ops.bert import BertEncoder as JBertEncoder
from bpx.ops.encoder import TransformerEncoder as JTransformerEncoder
from bpx.ops.mag import MAG as JMAG
from bpx.serve import Predictor as JPredictor
from bpx.models import get_model as jget_model
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict, get_preset
from bpx_torch.interop import flax_to_state_dict, params_from_flax
from bpx_torch.ops.audio import AudioEncoder
from bpx_torch.ops.bert import BertEncoder
from bpx_torch.ops.encoder import TransformerEncoder
from bpx_torch.ops.mag import MAG
from bpx_torch.serve import Predictor
from tests.test_torch_loop import few_threads  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tiny_experiment():
    """moviescope's shape pattern, shrunk: scanned BERT, unrolled
    encoders, Tl != Ta so both the band (Tq < Tk) and the dropped band
    (Tq > Tk) occur, fp32."""
    exp = jget_preset("synthetic-tiny")
    model = exp.model.replace(
        hidden_sz=32, num_heads=2, layers=2,
        num_vectors_l=24, num_vectors_a=12, num_vectors_v=12,
        orig_d_l=32, orig_d_v=20, orig_d_a=8, orig_d_p=16,
        scan_layers=True, scan_encoders=False, attention_impl="pallas",
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2,
                                 intermediate_size=64, gelu="tanh"),
        compute_dtype="float32")
    data = dataclasses.replace(exp.data, audio_raw_len=400, video_len=12)
    return exp.replace(model=model, data=data)


def _batch(exp, n, seed=0):
    rng = np.random.RandomState(seed)
    m, d = exp.model, exp.data
    lens = rng.randint(4, m.num_vectors_l + 1, size=n)
    lens[0] = m.num_vectors_l
    mask = (np.arange(m.num_vectors_l)[None, :] < lens[:, None])
    txt = rng.randint(1, m.bert.vocab_size, size=(n, m.num_vectors_l))
    return {
        "txt": (txt * mask).astype(np.int32),
        "mask": mask.astype(np.int32),
        "segment": np.zeros((n, m.num_vectors_l), np.int32),
        "video": rng.rand(n, d.video_len, m.orig_d_v).astype(np.float32),
        "audio": rng.rand(n, d.audio_raw_len, m.orig_d_a).astype(np.float32),
        "poster": rng.rand(n, m.orig_d_p).astype(np.float32),
    }


@pytest.fixture(scope="module")
def tiny():
    """(bpx experiment, port experiment, bpx params) of the tiny model."""
    jexp = _tiny_experiment()
    inputs = jmodel_inputs("mmtrvapt", {k: jnp.asarray(v)
                                        for k, v in _batch(jexp, 1).items()})
    params = jget_model(jexp.model).init({"params": jax.random.PRNGKey(0)},
                                         *inputs)["params"]
    return jexp, config_from_dict(dataclasses.asdict(jexp)), params


def test_served_mmtrvapt_matches_bpx(tiny):
    jexp, exp, params = tiny
    batch = _batch(jexp, 4)
    assert "layers" in params["bert"]          # scanned BERT
    assert "layer0" in params["trans_l_with_a"]  # unrolled encoders

    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), exp.model),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, exp.model.n_classes)
    assert gg.shape == (4, 4 * exp.model.hidden_sz)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)

    # ragged client batch: padded to 4 and sliced back
    small = {k: v[1:3] for k, v in batch.items()}
    wp3, wg3 = want(small, return_gates=True)
    gp3, gg3 = got(small, return_gates=True)
    assert gp3.shape == (2, exp.model.n_classes)
    np.testing.assert_allclose(gp3, np.asarray(wp3, np.float32), **TOL)
    np.testing.assert_allclose(gg3, np.asarray(wg3, np.float32), **TOL)


def test_params_from_flax_rejects_leftover_and_missing(tiny):
    _, exp, params = tiny
    tree = _np_tree(params)
    extra = dict(tree, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="left over"):
        params_from_flax(extra, exp.model)
    missing = {k: v for k, v in tree.items() if k != "proj_poster"}
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, exp.model)
    odd = dict(tree, gmu={**tree["gmu"], "weird": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="no rule"):
        params_from_flax(odd, exp.model)


@pytest.mark.parametrize("biprojection", [False, True])
def test_transformer_encoder_matches_bpx(biprojection):
    B, Tq, Tk, E, H = 2, 12, 20, 32, 2
    rng = np.random.RandomState(3)
    x = rng.randn(B, Tq, E).astype(np.float32)
    xk = rng.randn(B, Tk, E).astype(np.float32)
    jenc = JTransformerEncoder(embed_dim=E, num_heads=H, layers=2,
                               attn_mask=True, biprojection=biprojection,
                               attention_impl="pallas")
    xj, xkj = jnp.asarray(x), jnp.asarray(xk)
    params = jenc.init(jax.random.PRNGKey(0), xj, xkj, xkj)["params"]
    want = jenc.apply({"params": params}, xj, xkj, xkj)

    enc = TransformerEncoder(E, H, 2, attn_mask=True,
                             biprojection=biprojection,
                             attention_impl="pallas")
    enc.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    xkt = _t(xk)
    with torch.no_grad():
        got = enc(_t(x), xkt, xkt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scan", [False, True])
def test_bert_encoder_matches_bpx(scan):
    cfg = dataclasses.replace(JBertConfig.tiny(vocab_size=50), hidden_size=32,
                              num_heads=2, intermediate_size=48)
    B, T = 3, 16
    rng = np.random.RandomState(4)
    lens = np.array([16, 9, 1])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    ids = (rng.randint(1, 50, size=(B, T)) * mask).astype(np.int32)
    seg = rng.randint(0, 2, size=(B, T)).astype(np.int32)
    jbert = JBertEncoder(cfg, scan_layers=scan, attention_impl="pallas")
    params = jbert.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                        jnp.asarray(mask), jnp.asarray(seg))["params"]
    want = jbert.apply({"params": params}, jnp.asarray(ids),
                       jnp.asarray(mask), jnp.asarray(seg))

    from bpx_torch.config import BertConfig
    # eval mode: the JAX module's default deterministic=True
    bert = BertEncoder(BertConfig(**dataclasses.asdict(cfg)),
                       attention_impl="pallas").eval()
    bert.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = bert(_t(ids), _t(mask), _t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_audio_encoder_matches_bpx():
    """moviescope's conv geometry (k=128, s=2, VALID) with an up-sampling
    adaptive pool (137 frames -> 200 at full size; here 41 -> 50)."""
    B, T, C = 2, 418, 6
    x = np.random.RandomState(5).rand(B, T, C).astype(np.float32)
    jenc = JAudioEncoder(channels=C, kernel_size=128, stride=2,
                         pool_target=50)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jenc.apply({"params": params}, jnp.asarray(x))

    enc = AudioEncoder(C, 128, 2, 50)
    enc.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = enc(_t(x))
    assert got.shape == (B, 50, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="too short"):
        enc(torch.zeros(1, 300, C))


def test_moviescope_preset_builds_on_meta():
    """Full-width moviescope mmtrvapt: structure and parameter count
    without allocating (meta device)."""
    from bpx_torch.models import get_model
    model = get_model(get_preset("moviescope").model, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert len(model.bert.layers) == 12
    assert len(model.trans_l_with_v2a.layers) == 4
    assert model.trans_l_with_v2a.layers[0].attn.num_heads == 8
    assert n > 400_000_000


# ---------------------------------------------------------------------------
# mmtrvat: the 3-input model (iemocap, cmu-mosei, counseling, cmu-mosi)
# ---------------------------------------------------------------------------

def _tiny_vat_experiment(fusion="gmu", scan_encoders=False):
    """iemocap's shape pattern, shrunk: hidden 50 over 2 heads (head_dim 25,
    as iemocap's 300 / 12), 2 layers, equal stream lengths (video shorter
    than its stream, so it is padded), raw audio, scanned BERT, the
    encoders unrolled or scanned, fp32."""
    exp = jget_preset("iemocap")
    model = exp.model.replace(
        hidden_sz=50, num_heads=2, layers=2,
        num_vectors_l=16, num_vectors_a=16, num_vectors_v=16,
        orig_d_l=32, orig_d_v=20, orig_d_a=8, orig_d_p=16,
        scan_layers=True, scan_encoders=scan_encoders, fusion=fusion,
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2,
                                 intermediate_size=64, gelu="tanh"),
        compute_dtype="float32")
    data = dataclasses.replace(exp.data, audio_raw_len=16, video_len=12)
    return exp.replace(model=model, data=data)


_VAT_TREES = {}


def tiny_vat(fusion="gmu", scan_encoders=False):
    """(bpx experiment, port experiment, bpx params) of the tiny mmtrvat,
    initialised once per (fusion, scan_encoders)."""
    key = (fusion, scan_encoders)
    if key not in _VAT_TREES:
        jexp = _tiny_vat_experiment(fusion, scan_encoders)
        inputs = jmodel_inputs("mmtrvat", {
            k: jnp.asarray(v) for k, v in _batch(jexp, 1).items()})
        params = jget_model(jexp.model).init(
            {"params": jax.random.PRNGKey(0)}, *inputs)["params"]
        _VAT_TREES[key] = (jexp, config_from_dict(dataclasses.asdict(jexp)),
                           params)
    return _VAT_TREES[key]


@pytest.mark.parametrize("fusion,scan_encoders", [
    ("gmu", False), ("gmu", True), ("mag", False)])
def test_served_mmtrvat_matches_bpx(fusion, scan_encoders):
    jexp, exp, params = tiny_vat(fusion, scan_encoders)
    m = exp.model
    assert m.hidden_sz // m.num_heads == 25
    assert "layers" in params["bert"]          # scanned BERT
    enc = params["trans_l_with_a"]
    assert ("layers" in enc) == scan_encoders and ("layer0" in enc) != \
        scan_encoders
    assert not any(k.startswith("transfm_") or k == "proj_poster"
                   for k in params)
    batch = _batch(jexp, 4, seed=1)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), m),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, m.n_classes)
    assert gg.shape == ((4, 3 * m.hidden_sz) if fusion == "gmu" else (4, 1))
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)

    # ragged client batch: padded to 4 and sliced back
    small = {k: v[1:3] for k, v in batch.items()}
    wp3, wg3 = want(small, return_gates=True)
    gp3, gg3 = got(small, return_gates=True)
    assert gp3.shape == (2, m.n_classes)
    np.testing.assert_allclose(gp3, np.asarray(wp3, np.float32), **TOL)
    np.testing.assert_allclose(gg3, np.asarray(wg3, np.float32), **TOL)


@pytest.mark.parametrize("fusion", ["gmu", "mag"])
def test_params_from_flax_mmtrvat_rejects_leftover_and_missing(fusion):
    _, exp, params = tiny_vat(fusion)
    tree = _np_tree(params)
    head = "mag" if fusion == "mag" else "gmu"
    sd = params_from_flax(tree, exp.model)
    assert (f"{head}.W_hv.weight" in sd) == (fusion == "mag")
    extra = dict(tree, transfm_a2l={"kernel": np.zeros((16, 16), np.float32),
                                    "bias": np.zeros(16, np.float32)})
    with pytest.raises(KeyError, match="left over"):
        params_from_flax(extra, exp.model)
    missing = {k: v for k, v in tree.items() if k != head}
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, exp.model)
    odd = dict(tree, **{head: {**tree[head],
                               "weird": np.zeros(3, np.float32)}})
    with pytest.raises(KeyError, match="no rule"):
        params_from_flax(odd, exp.model)
    # the other fusion's model does not take this tree
    other = exp.model.replace(fusion="gmu" if fusion == "mag" else "mag")
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(tree, other)


def test_mag_matches_bpx():
    """MAG alone (Dense layers with biases, the norms, the gate, LayerNorm)
    in eval mode, and its guard: where h_m is 0 its norm counts as 1, so
    alpha is ||text|| * 1e-3 / (1 + 1e-6) (not the 1 that a division by
    1e-6 would clip to) and the output is LayerNorm(text)."""
    B, E = 5, 24
    rng = np.random.RandomState(11)
    t, v, a = (rng.randn(B, E).astype(np.float32) for _ in range(3))
    jmag = JMAG(E)
    params = jmag.init(jax.random.PRNGKey(2), *(jnp.asarray(x)
                                               for x in (t, v, a)))["params"]
    params = jax.tree.map(lambda x: x + 0.1, params)   # non-zero biases
    mag = MAG(E)
    mag.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    mag.eval()
    for vv, aa in ((v, a), (np.zeros_like(v), np.zeros_like(a))):
        want, walpha = jmag.apply({"params": params}, jnp.asarray(t),
                                  jnp.asarray(vv), jnp.asarray(aa),
                                  return_alpha=True)
        with torch.no_grad():
            got, alpha = mag(_t(t), _t(vv), _t(aa))
        assert alpha.shape == (B, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(alpha.numpy(), np.asarray(walpha),
                                   **TOL)
    zero = {k: np.zeros_like(np.asarray(x))
            for k, x in params["W_v"].items()}
    params = dict(params, W_v=zero, W_a=zero)
    mag.load_state_dict(flax_to_state_dict(_np_tree(params)), strict=True)
    with torch.no_grad():
        got, alpha = mag(_t(t), _t(v), _t(a))
    want, walpha = jmag.apply({"params": params}, jnp.asarray(t),
                              jnp.asarray(v), jnp.asarray(a),
                              return_alpha=True)
    guarded = np.linalg.norm(t, axis=-1, keepdims=True) * 1e-3 / (1 + 1e-6)
    np.testing.assert_allclose(alpha.numpy(), guarded, **TOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(walpha), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mmtrvat_param_count(m):
    """Parameters of an mmtrvat config, counted from its structure: BERT
    (embeddings, their norm, per layer q/k/v/o, two norms and the FFN),
    the bias-free projections of the streams not already E wide, 12
    encoders of plain crossmodal
    layers (q/k/v/o with biases, two norms, the FFN) and a final norm, six
    bimodal GMUs (3 E^2 each), the 3-ary GMU (3 E^2 + 9 E^2) and the
    head."""
    b, E = m.bert, m.hidden_sz
    Eb, I = b.hidden_size, b.intermediate_size
    bert = ((b.vocab_size + b.max_position_embeddings + b.type_vocab_size)
            * Eb + 2 * Eb
            + b.num_layers * (4 * (Eb * Eb + Eb) + 4 * Eb + 2 * Eb * I
                              + I + Eb))
    proj = E * sum(d for d in (m.orig_d_l, m.orig_d_v, m.orig_d_a)
                   if d != E)
    layer = 4 * (E * E + E) + 4 * E + 8 * E * E + 5 * E
    encoders = 12 * (m.layers * layer + 2 * E)
    gmus = 6 * 4 * E * E + 12 * E * E
    head = 2 * (E * E + E) + E * m.n_classes + m.n_classes
    return bert + proj + encoders + gmus + head


@pytest.mark.parametrize("preset,heads,head_dim,depth", [
    ("iemocap", 12, 25, 8), ("cmu-mosei", 10, 30, 8),
    ("counseling", 10, 30, 5), ("cmu-mosi", 10, 30, 5)])
def test_mmtrvat_presets_build_on_meta(preset, heads, head_dim, depth):
    """Full-width mmtrvat presets: structure and parameter count without
    allocating (meta device)."""
    from bpx_torch.models import get_model
    from bpx_torch.models.bpmult import BPMulTVAT
    m = get_preset(preset).model
    model = get_model(m, device="meta")
    assert isinstance(model, BPMulTVAT)
    assert len(model.bert.layers) == 12
    for name in ("trans_l_with_a", "trans_v_with_a2l"):
        enc = getattr(model, name)
        assert len(enc.layers) == depth
        assert not enc.layers[0].biprojection
        attn = enc.layers[0].attn
        assert (attn.num_heads, attn.head_dim) == (heads, head_dim)
    assert not any(hasattr(model, n) for n in (
        "transfm_a2l", "proj_poster", "audio_enc", "mag"))
    n = sum(p.numel() for p in model.parameters())
    assert n == _mmtrvat_param_count(m)
    mag = get_model(m.replace(fusion="mag"), device="meta")
    E = m.hidden_sz
    assert sum(p.numel() for p in mag.mag.parameters()) == \
        2 * (2 * E * E + E) + 2 * (E * E + E) + 2 * E
    assert not hasattr(mag, "gmu")
