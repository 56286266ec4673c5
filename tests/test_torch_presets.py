"""Three preset structures the port serves and trains, against the JAX
package: mmimdb's mmtrvapt (head_dim 128, the audio stream raw and 1 wide,
no audio encoder), counseling's mmtrvat (video and audio enter at the hidden
width, unprojected) and cmu-mosi's (one output: sigmoid probabilities and
the L1 loss).  Each tiny model is served by both packages and trained in
lockstep with ``bpx.train.steps.make_train_step``; the full-width mmimdb is
built on ``meta`` with its exact parameter count.

As in ``tests/test_torch_model.py``: weights initialised in ``bpx`` and
carried over with ``bpx_torch.interop``, numpy-seeded inputs, fp32 on the
CPU (the port's kernel wrappers compute their plain versions), served
outputs to 1e-4; the lockstep tolerances are ``tests/test_torch_train.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bpx.config import BertConfig as JBertConfig
from bpx.config import get_preset as jget_preset
from bpx.models import get_model as jget_model
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict, get_preset
from bpx_torch.interop import params_from_flax
from bpx_torch.serve import Predictor
from tests.test_torch_model import TOL, _batch, _fp32_matmuls, _np_tree  # noqa: F401
from tests.test_torch_train import _lockstep, _no_dropout
from tests.test_torch_loop import few_threads  # noqa: F401



def _tiny_mmimdb_experiment():
    """mmimdb's shape pattern, shrunk: hidden 256 over 2 heads (head_dim
    128, as mmimdb's 768 / 6), 2 layers, equal stream lengths (video
    shorter than its stream, so it is padded), the audio stream raw and
    1 wide (no audio encoder), a poster, scanned BERT, fp32."""
    exp = jget_preset("mmimdb")
    model = exp.model.replace(
        hidden_sz=256, num_heads=2, layers=2,
        num_vectors_l=16, num_vectors_a=16, num_vectors_v=16,
        orig_d_l=32, orig_d_v=20, orig_d_p=16,
        scan_encoders=False,
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2,
                                 intermediate_size=64, gelu="tanh"),
        compute_dtype="float32")
    data = dataclasses.replace(exp.data, audio_raw_len=16, video_len=12)
    return exp.replace(model=model, data=data)


_TREES = {}


def tiny_tree(make, name):
    """(bpx experiment, port experiment, bpx params) of ``make()``'s tiny
    model, initialised once per ``make``."""
    if make not in _TREES:
        jexp = make()
        inputs = jmodel_inputs(name, {
            k: jnp.asarray(v) for k, v in _batch(jexp, 1).items()})
        params = jget_model(jexp.model).init(
            {"params": jax.random.PRNGKey(0)}, *inputs)["params"]
        _TREES[make] = (jexp, config_from_dict(dataclasses.asdict(jexp)),
                        params)
    return _TREES[make]


def tiny_mmimdb():
    return tiny_tree(_tiny_mmimdb_experiment, "mmtrvapt")


def test_served_mmimdb_mmtrvapt_matches_bpx():
    jexp, exp, params = tiny_mmimdb()
    m = exp.model
    assert (m.hidden_sz // m.num_heads, m.orig_d_a) == (128, 1)
    assert not m.use_audio_encoder and m.attention_impl == "pallas"
    assert "audio_enc" not in params and "proj_a" in params
    batch = _batch(jexp, 4, seed=3)
    assert batch["audio"].shape == (4, 16, 1)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), m),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, m.n_classes) and gg.shape == (4, 4 * m.hidden_sz)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)


def _mmtrvapt_param_count(m):
    """Parameters of an mmtrvapt config without its audio encoder (mmimdb),
    counted from its structure: BERT, the bias-free projections of the
    streams not already E wide and of the poster, 6 first-round
    crossmodal encoders (q/k/v/o with biases, two norms, the FFN; a final
    norm), 6 biprojection encoders (a third norm per layer), six bimodal
    GMUs (4 E^2 each), the four sequence adapters, the 4-ary GMU (4 E^2 +
    16 E^2) and the head."""
    assert not m.use_audio_encoder
    b, E = m.bert, m.hidden_sz
    Eb, I = b.hidden_size, b.intermediate_size
    bert = ((b.vocab_size + b.max_position_embeddings + b.type_vocab_size)
            * Eb + 2 * Eb
            + b.num_layers * (4 * (Eb * Eb + Eb) + 4 * Eb + 2 * Eb * I
                              + I + Eb))
    proj = E * (sum(d for d in (m.orig_d_l, m.orig_d_v, m.orig_d_a)
                    if d != E) + m.orig_d_p)
    layer = 4 * (E * E + E) + 4 * E + 8 * E * E + 5 * E
    encoders = (6 * (m.layers * layer + 2 * E)
                + 6 * (m.layers * (layer + 2 * E) + 2 * E))
    Tl, Ta, Tv = m.num_vectors_l, m.num_vectors_a, m.num_vectors_v
    adapters = (Tl * Ta + Tl) + (Tl * Tv + Tl) + (Ta * Tl + Ta) \
        + (Tv * Tl + Tv)
    gmus = 6 * 4 * E * E + 20 * E * E
    head = 2 * (E * E + E) + E * m.n_classes + m.n_classes
    return bert + proj + encoders + adapters + gmus + head


def test_mmimdb_preset_builds_on_meta():
    """Full-width mmimdb mmtrvapt (hidden 768 over 6 heads: head_dim 128,
    T = 512 on every stream, raw 1-wide audio): structure and parameter
    count without allocating (meta device)."""
    from bpx_torch.models import get_model
    from bpx_torch.models.bpmult import BPMulTVAPT
    m = get_preset("mmimdb").model
    model = get_model(m, device="meta")
    assert isinstance(model, BPMulTVAPT)
    assert len(model.bert.layers) == 12
    assert not hasattr(model, "audio_enc")
    assert model.proj_a.weight.shape == (768, 1)
    for name in ("trans_l_with_a", "trans_v_with_a2l"):
        attn = getattr(model, name).layers[0].attn
        assert (attn.num_heads, attn.head_dim, attn.impl) == (6, 128,
                                                              "pallas")
    assert model.transfm_a2l.weight.shape == (512, 512)
    n = sum(p.numel() for p in model.parameters())
    assert n == _mmtrvapt_param_count(m)


# ---------------------------------------------------------------------------
# counseling (video and audio as wide as the hidden size: no proj_v, no
# proj_a) and cmu-mosi (one output: L1 loss, sigmoid probabilities), the
# mmtrvat presets at head_dim 30, shrunk: hidden 60 over 2 heads

def _tiny_preset_vat(preset, **widths):
    exp = jget_preset(preset)
    model = exp.model.replace(
        hidden_sz=60, num_heads=2, layers=2,
        num_vectors_l=16, num_vectors_a=16, num_vectors_v=16,
        orig_d_l=32, scan_encoders=False,
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2,
                                 intermediate_size=64),
        compute_dtype="float32", **widths)
    data = dataclasses.replace(exp.data, audio_raw_len=16, video_len=12)
    return exp.replace(model=model, data=data)


def _tiny_counseling_experiment():
    return _tiny_preset_vat("counseling", orig_d_v=60, orig_d_a=60)


def _tiny_cmu_mosi_experiment():
    return _tiny_preset_vat("cmu-mosi", orig_d_v=20, orig_d_a=5)


def tiny_counseling():
    return tiny_tree(_tiny_counseling_experiment, "mmtrvat")


def tiny_cmu_mosi():
    return tiny_tree(_tiny_cmu_mosi_experiment, "mmtrvat")


@pytest.mark.parametrize("preset", ["counseling", "cmu-mosi"])
def test_served_preset_structures_match_bpx(preset):
    """counseling: the video and audio streams enter at the hidden width
    unprojected; cmu-mosi: one output through a sigmoid (its L1 task is a
    classification task_type, yet served as probabilities)."""
    jexp, exp, params = (tiny_counseling() if preset == "counseling"
                         else tiny_cmu_mosi())
    m = exp.model
    assert m.hidden_sz // m.num_heads == 30
    projected = {k for k in params if k.startswith("proj_")}
    if preset == "counseling":
        assert projected == {"proj_l"}
        assert m.orig_d_v == m.orig_d_a == m.hidden_sz
    else:
        assert projected == {"proj_l", "proj_v", "proj_a"}
        assert m.n_classes == 1
    batch = _batch(jexp, 4, seed=4)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), m),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, m.n_classes)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)
    if preset == "cmu-mosi":
        assert ((gp > 0) & (gp < 1)).all()


def test_mmimdb_train_step_lockstep_with_bpx():
    """The tiny mmimdb mmtrvapt (head_dim 128, raw 1-wide audio), on one
    super-batch three times: at hidden 256 three Adam steps over three
    different super-batches do not lower the loss (both packages read
    1.02, 2.29, 1.21), on the same one they do."""
    jexp, _, params = tiny_mmimdb()
    _lockstep(_no_dropout(jexp), list(range(1, 24)), batch_seeds=(0, 0, 0),
              params=params)


def test_cmu_mosi_train_step_lockstep_with_bpx():
    """The tiny cmu-mosi mmtrvat: one output, the L1 loss on real-valued
    targets (no class weights)."""
    jexp, _, params = tiny_cmu_mosi()
    _lockstep(_no_dropout(jexp), [1], "cmu-mosi", "classification",
              params=params)
