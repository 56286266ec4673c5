"""``mmtrvpa`` at the patterns of the presets other than moviescope, and
the notebook-era models with the options they ignore, against the JAX
package.

mmtrvpa's 2E-wide memory encoders run the flash kernels at head_dim 2E /
heads: 50 at iemocap's widths (600 / 12), 60 at cmu-mosei's, counseling's
and cmu-mosi's (600 / 10), 256 at mmimdb's (1536 / 6).  The tiny models
here keep those memory head dims and the presets' crossmodal ones: hidden
50 over 2 heads (crossmodal 25, memory 50), hidden 60 over 2 (30, 60) and
hidden 128 over 1 (128, 256), with each preset's own stream structure
(raw audio; mmimdb's 1 wide, no audio encoder) and its own recompute
(``remat=True``, mmimdb's ``save_attn``).  Each is served by both
packages (``tests/test_torch_legacy_presets_train.py`` trains it in
lockstep with the JAX package) and its flash calls per forward are counted
by head dim, as ``chip_smoke.py`` counts them at full width on the card.
The notebook-era classes take ``hybrid`` and ``fusion="mag"`` and ignore
them, in both packages: the same logits as the JAX package's with each
option set.  The memory encoders' q/k/v views at 50, 60 and 256 go to the
kernels without a copy.

As in ``tests/test_torch_presets.py``: weights initialised in ``bpx`` and
carried over with ``bpx_torch.interop``, numpy-seeded inputs, fp32 on the
CPU (the port's kernel wrappers compute their plain versions), served
outputs to 1e-4.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.config import BertConfig as JBertConfig
from bpx.config import get_preset as jget_preset
from bpx.models import get_model as jget_model
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict, get_preset
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.ops.attention import fused_projection
from bpx_torch.serve import Predictor
from tests.test_torch_legacy_models import LEGACY, legacy
from tests.test_torch_model import TOL, _batch, _fp32_matmuls, _np_tree  # noqa: F401
from tests.test_torch_presets import tiny_tree
from tests.test_torch_loop import few_threads  # noqa: F401

#: preset: (hidden, heads, the stream widths the tiny model keeps) of the
#: tiny mmtrvpa, whose crossmodal and memory head dims are the preset's
PATTERNS = {
    "iemocap": (50, 2, dict(orig_d_v=35, orig_d_a=74)),
    "cmu-mosei": (60, 2, dict(orig_d_v=35, orig_d_a=74)),
    "mmimdb": (128, 1, dict(orig_d_v=20, orig_d_a=1, orig_d_p=16)),
}
#: (crossmodal, memory) head dims of each preset's full-width mmtrvpa
HEAD_DIMS = {"iemocap": (25, 50), "cmu-mosei": (30, 60),
             "counseling": (30, 60), "cmu-mosi": (30, 60),
             "mmimdb": (128, 256)}


def _tiny_mmtrvpa(preset):
    """``preset`` as mmtrvpa, shrunk: the pattern's hidden size and heads,
    1 layer (3 in the memory encoders), 16 steps on every stream, BERT 32
    wide, unrolled encoders, fp32; the preset's recompute kept."""
    hidden, heads, widths = PATTERNS[preset]
    exp = jget_preset(preset)
    model = exp.model.replace(
        model="mmtrvpa", hidden_sz=hidden, num_heads=heads, layers=1,
        num_vectors_l=16, num_vectors_a=16, num_vectors_v=16, orig_d_l=32,
        scan_encoders=False,
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2,
                                 intermediate_size=64),
        compute_dtype="float32", **widths)
    data = dataclasses.replace(exp.data, audio_raw_len=16, video_len=12)
    return exp.replace(model=model, data=data)


_MAKERS = {p: (lambda p=p: _tiny_mmtrvpa(p)) for p in PATTERNS}


def tiny_mmtrvpa(preset):
    return tiny_tree(_MAKERS[preset], "mmtrvpa")


def _memory_head_dim(m):
    return 2 * m.hidden_sz // m.num_heads


@pytest.mark.parametrize("preset", list(PATTERNS))
def test_served_mmtrvpa_at_the_preset_matches_bpx(preset):
    jexp, exp, params = tiny_mmtrvpa(preset)
    m = exp.model
    assert (m.hidden_sz // m.num_heads, _memory_head_dim(m)) == \
        HEAD_DIMS[preset]
    assert m.remat and m.attention_impl == "pallas"
    assert m.use_audio_encoder is False and "audio_enc" not in params
    batch = _batch(jexp, 4, seed=5)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(_np_tree(params), m),
                    batch_size=4, device="cpu")
    wp, wg = want(batch, return_gates=True)
    gp, gg = got(batch, return_gates=True)
    assert gp.shape == (4, m.n_classes) and gg.shape == (4, 3 * m.hidden_sz)
    np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
    np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)


def calls_by_head_dim(cfg) -> dict:
    """Flash calls of one mmtrvpa forward by head dim: BERT's, one a layer;
    six crossmodal encoders of ``layers``; three memory encoders of
    max(layers, 3) at 2E / heads."""
    got = collections.Counter()
    got[cfg.bert.hidden_size // cfg.bert.num_heads] += cfg.bert.num_layers
    got[cfg.hidden_sz // cfg.num_heads] += 6 * cfg.layers
    got[_memory_head_dim(cfg)] += 3 * max(cfg.layers, 3)
    return dict(got)


@pytest.mark.parametrize("preset", list(PATTERNS))
def test_mmtrvpa_flash_calls_by_head_dim(preset, monkeypatch):
    """The flash calls of a served forward, counted at the wrapper by head
    dim on the CPU path, are what the structure gives; at full width the
    same count is the one ``chip_smoke.py`` checks on the card: 84 (12 at
    64, 48 at the crossmodal and 24 at the memory head dim) at iemocap and
    cmu-mosei, 57 (12, 30, 15) at counseling and cmu-mosi, 48 (12, 24, 12)
    at mmimdb."""
    _, exp, _ = tiny_mmtrvpa(preset)
    model = get_model(exp.model, device="cpu", seed=1).eval()
    inputs = [torch.from_numpy(np.asarray(v)) for v in jmodel_inputs(
        "mmtrvpa", _batch(exp, 2, seed=3))]
    seen = collections.Counter()
    forward = tflash._forward

    def count(q, *args):
        seen[q.shape[-1]] += 1
        return forward(q, *args)
    monkeypatch.setattr(tflash, "_forward", count)
    with torch.no_grad():
        model(*inputs)
    assert dict(seen) == calls_by_head_dim(exp.model)
    full = {p: calls_by_head_dim(get_preset(p).model.replace(
        model="mmtrvpa")) for p in HEAD_DIMS}
    assert full == {"iemocap": {64: 12, 25: 48, 50: 24},
                    "cmu-mosei": {64: 12, 30: 48, 60: 24},
                    "counseling": {64: 12, 30: 30, 60: 15},
                    "cmu-mosi": {64: 12, 30: 30, 60: 15},
                    "mmimdb": {64: 12, 128: 24, 256: 12}}


@pytest.mark.parametrize("preset", sorted(HEAD_DIMS))
def test_memory_views_go_to_the_kernels_uncopied(preset):
    """The memory encoders' attention inputs at the preset's full width, as
    the port builds them (the (B, H, T, D) views of one fused projection of
    the 2E-wide stream, q scaled, in bf16), and O and dO in the kernels'
    (B, T, H, D) layout (dO's too), meet the head dim's ``KERNEL_ALIGN``:
    the wrapper hands them to the kernels without a copy."""
    m = get_preset(preset).model
    E2, H = 2 * m.hidden_sz, m.num_heads
    D = HEAD_DIMS[preset][1]
    assert E2 // H == D and D in tflash.KERNEL_ALIGN
    layers = [torch.nn.Linear(E2, E2) for _ in range(3)]
    x = torch.randn(2, 8, E2)
    q, k, v = fused_projection(x, layers, H, torch.bfloat16)
    q = q * torch.tensor(D ** -0.5, dtype=torch.bfloat16)
    out = tflash._kernel_layout(2, 8, H, D, q)
    for t in (q, k, v, out):
        assert tflash._kernel_ready("t", t, t.device) is t


@pytest.mark.parametrize("option", [dict(hybrid=True), dict(fusion="mag")],
                         ids=["hybrid", "mag"])
@pytest.mark.parametrize("name", LEGACY)
def test_legacy_model_ignores_the_option_as_bpx_does(name, option):
    """A notebook-era model with ``hybrid`` or ``fusion="mag"``: both
    packages build it from the same parameters as without the option (the
    JAX package's classes never read either) and give the same logits."""
    jexp, exp, params = legacy(name)
    jcfg, cfg = jexp.model.replace(**option), exp.model.replace(**option)
    batch = _batch(jexp, 3, seed=8)
    inputs = jmodel_inputs(name, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    want = jget_model(jcfg).apply({"params": params}, *inputs)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(params_from_flax(_np_tree(params), cfg))
    with torch.no_grad():
        got = model.eval()(*[torch.from_numpy(np.asarray(v))
                             for v in inputs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)
