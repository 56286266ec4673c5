"""The port's modules and served model against the JAX package.

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
from bpx.serve import Predictor as JPredictor
from bpx.models import get_model as jget_model
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict, get_preset
from bpx_torch.interop import flax_to_state_dict, params_from_flax
from bpx_torch.ops.audio import AudioEncoder
from bpx_torch.ops.bert import BertEncoder
from bpx_torch.ops.encoder import TransformerEncoder
from bpx_torch.serve import Predictor

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
                             biprojection=biprojection)
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
    bert = BertEncoder(BertConfig(**dataclasses.asdict(cfg))).eval()
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
