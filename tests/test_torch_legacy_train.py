"""Training the notebook-era models: the train step of mmtrvpa, tmmtrvpa
and gmu_hier in lockstep with ``bpx.train.steps.make_train_step`` (the loss
trajectory, the step-1 gradients, the grad norm), as
``tests/test_torch_train.py`` holds the BPMulT models; their dropout wiring;
and the kernel calls per forward that ``chip_smoke.py`` counts on the card.

fp32 on the CPU, weights carried from ``bpx`` with
``bpx_torch.interop.params_from_flax``, numpy-seeded inputs; the
tolerances are ``tests/test_torch_train.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict, get_preset
from bpx_torch.models import get_model
from tests.test_torch_legacy_models import legacy_experiment
from tests.test_torch_model import _batch
from tests.test_torch_train import _count_calls, _lockstep, _no_dropout
from tests.test_torch_loop import few_threads  # noqa: F401

FREQS = [5, 2, 9, 1, 4]


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("name", ["mmtrvpa", "tmmtrvpa", "gmu_hier"])
def test_legacy_train_step_lockstep_with_bpx(name):
    _lockstep(_no_dropout(legacy_experiment(name)), FREQS)


def expected_calls(cfg, training):
    """(LayerNorm, flash, flash with dropout) calls of one forward of a
    notebook-era model.  BERT: its embedding norm and 2 per layer, one
    attention per layer, dropout at its attention rate.  mmtrvpa: six
    crossmodal encoders (3 LayerNorms per layer and a final one, one more
    per layer in training where V is embedded apart from K) and three
    self-attention memory encoders of max(layers, 3) layers (2 per layer
    and a final one), one attention per layer, dropout where the rate is
    > 0 (the memory encoders' is attn_dropout).  tmmtrvpa: twelve
    crossmodal encoders (BPMulT's two rounds, the second plain).  The GMU
    classifiers: BERT alone."""
    L, Lb = cfg.layers, cfg.bert.num_layers
    ln, flash = 1 + 2 * Lb, Lb
    drop = Lb * (cfg.bert.attention_dropout > 0)
    rates = (cfg.attn_dropout_a, cfg.attn_dropout_v, cfg.attn_dropout,
             cfg.attn_dropout_a, cfg.attn_dropout, cfg.attn_dropout_v)
    cross = {"mmtrvpa": 6, "tmmtrvpa": 12}.get(cfg.model, 0)
    rounds = cross // 6
    ln += cross * (3 * L + 1 + (L if training else 0))
    flash += cross * L
    drop += rounds * L * sum(r > 0 for r in rates)
    if cfg.model == "mmtrvpa":
        M = max(L, 3)
        ln += 3 * (2 * M + 1)
        flash += 3 * M
        drop += 3 * M * (cfg.attn_dropout > 0)
    return ln, flash, drop if training else 0


@pytest.mark.parametrize("name", ["mmtrvpa", "tmmtrvpa", "gmu", "gmu_bi",
                                  "bertclf"])
def test_legacy_calls_per_forward(name, monkeypatch):
    """Counted at the wrappers on the CPU path, eval and training mode; at
    moviescope's depth the same formula gives the counts ``chip_smoke.py``
    checks on the card: mmtrvpa 48 flash calls (12 BERT, 24 crossmodal,
    12 memory at head_dim 192), 32 with dropout, 130 / 154 LayerNorms;
    tmmtrvpa 60, 28, 181 / 229; the GMU classifiers and bertclf 12, 12,
    25 / 25.  mmtrvpa at the other presets (only ``model`` changed): 84
    flash calls, 52 with dropout, 226 / 274 LayerNorms at iemocap and
    cmu-mosei (8 layers), 57, 37, 154 / 184 at counseling and cmu-mosi (5),
    48, 32, 130 / 154 at mmimdb (4)."""
    jexp = legacy_experiment(name)
    exp = config_from_dict(dataclasses.asdict(jexp))
    model = get_model(exp.model, device="cpu", seed=3)
    inputs = [torch.from_numpy(np.asarray(v)) for v in jmodel_inputs(
        name, _batch(jexp, 2, seed=6))]
    counts = _count_calls(monkeypatch)
    for training in (False, True):
        for key in counts:
            counts[key] = 0
        model.train(training)
        with torch.no_grad():
            model(*inputs, dropout_seed=1 if training else None)
        assert (counts["ln"], counts["flash"], counts["flash_dropout"]) == \
            expected_calls(exp.model, training)
    full = get_preset("moviescope").model.replace(model=name)
    want = {"mmtrvpa": ((130, 48, 0), (154, 48, 32)),
            "tmmtrvpa": ((181, 60, 0), (229, 60, 28))}.get(
                name, ((25, 12, 0), (25, 12, 12)))
    assert (expected_calls(full, False), expected_calls(full, True)) == want
    if name == "mmtrvpa":
        at = {p: tuple(expected_calls(get_preset(p).model.replace(
            model=name), training) for training in (False, True))
            for p in ("iemocap", "cmu-mosei", "counseling", "cmu-mosi",
                      "mmimdb")}
        eight = ((226, 84, 0), (274, 84, 52))
        five = ((154, 57, 0), (184, 57, 37))
        assert at == {"iemocap": eight, "cmu-mosei": eight,
                      "counseling": five, "cmu-mosi": five,
                      "mmimdb": ((130, 48, 0), (154, 48, 32))}


@pytest.mark.parametrize("name", ["mmtrvpa", "tmmtrvpa", "gmu_hier"])
def test_legacy_dropout_follows_the_seed(name):
    """In training mode the same base seed gives the same logits, another
    base other logits, and eval mode none of them; without a seed the
    training forward raises."""
    jexp = legacy_experiment(name)
    exp = config_from_dict(dataclasses.asdict(jexp))
    model = get_model(exp.model, device="cpu", seed=5).train()
    inputs = [torch.from_numpy(np.asarray(v)) for v in jmodel_inputs(
        name, _batch(jexp, 3, seed=7))]
    with torch.no_grad():
        a = model(*inputs, dropout_seed=11)
        b = model(*inputs, dropout_seed=11)
        c = model(*inputs, dropout_seed=12)
        with pytest.raises(ValueError, match="SeedStream"):
            model(*inputs)
        model.eval()
        e = model(*inputs)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, e)
