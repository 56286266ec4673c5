"""The port's ``hybrid`` early fusion against the JAX package's.

Both models with ``hybrid=True`` (bpx's ``_make_hybrid`` and
``_hybrid_summary``): the early encoders (self-attention, ``max(layers,
3)`` layers, at ``reduced_dim`` positions), the sequence-axis projections
``proj_{l,v,a}_e`` and the 3-ary ``gmu_early``, whose summary joins the
final GMU (5-ary in mmtrvapt, 4-ary in mmtrvat).  Weights are initialised
in ``bpx`` and carried over with ``params_from_flax``; inputs are made with
numpy from a seed; fp32 on the CPU, where the kernel wrappers compute
their plain versions.  Served outputs at ``TOL`` (1e-4, as
``tests/test_torch_model.py``); one lockstep training run with the
tolerances of ``tests/test_torch_train.py::_lockstep``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.serve import Predictor
from tests.test_torch_model import (TOL, _batch, _tiny_experiment,
                                    _tiny_vat_experiment)
from tests.test_torch_train import (FREQS, _count_calls, _expected,
                                    _lockstep, _no_dropout)
from tests.test_torch_loop import few_threads  # noqa: F401


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hybrid(jexp, **kw):
    return jexp.replace(model=jexp.model.replace(hybrid=True, **kw))


EXPERIMENTS = {
    "mmtrvapt": lambda: _hybrid(_tiny_experiment()),
    "mmtrvat": lambda: _hybrid(_tiny_vat_experiment("gmu")),
}


def served_against_bpx(jexp, n_final):
    """Serve 4 numpy-seeded requests (and a ragged one) through bpx's
    Predictor and the port's from the same weights; returns the port's
    model."""
    name = jexp.model.model
    inputs = jmodel_inputs(name, {k: jnp.asarray(v)
                                  for k, v in _batch(jexp, 1).items()})
    params = jget_model(jexp.model).init({"params": jax.random.PRNGKey(0)},
                                         *inputs)["params"]
    exp = config_from_dict(dataclasses.asdict(jexp))
    batch = _batch(jexp, 4, seed=3)
    want = JPredictor(jexp, params, batch_size=4)
    got = Predictor(exp, params_from_flax(jax.tree.map(np.asarray, params),
                                          exp.model),
                    batch_size=4, device="cpu")
    for b in (batch, {k: v[1:3] for k, v in batch.items()}):
        wp, wg = want(b, return_gates=True)
        gp, gg = got(b, return_gates=True)
        assert gg.shape == (len(b["txt"]), n_final * exp.model.hidden_sz)
        np.testing.assert_allclose(gp, np.asarray(wp, np.float32), **TOL)
        np.testing.assert_allclose(gg, np.asarray(wg, np.float32), **TOL)
    return got.model, params


@pytest.mark.parametrize("name,n_final", [("mmtrvapt", 5), ("mmtrvat", 4)])
def test_served_hybrid_matches_bpx(name, n_final):
    model, params = served_against_bpx(EXPERIMENTS[name](), n_final)
    for m in "lva":
        assert f"trans_{m}_early" in params and f"proj_{m}_e" in params
        # a tiny config of 2 layers gets 3 early layers
        assert len(getattr(model, f"trans_{m}_early").layers) == 3
    assert model.proj_l_e.weight.shape == (32, model.config.num_vectors_l)


def test_hybrid_train_step_lockstep_with_bpx():
    """Three accumulation steps of the hybrid mmtrvapt in bpx and the port
    from the same weights and batches (every dropout rate 0): step-1
    gradients, the gradient norm and the loss trajectory."""
    _lockstep(_no_dropout(EXPERIMENTS["mmtrvapt"]()), FREQS)


@pytest.mark.parametrize("name", ["mmtrvapt", "mmtrvat"])
def test_hybrid_keeps_the_seeded_weights_before_it(name):
    """The hybrid modules are built after the final GMU, as bpx's setup
    builds them: every module drawn before it keeps its seeded weights, so
    a config without ``hybrid`` builds the weights it built before."""
    cfg = config_from_dict(dataclasses.asdict(EXPERIMENTS[name]())).model
    plain = get_model(cfg.replace(hybrid=False), device="cpu", seed=7)
    hybrid = get_model(cfg, device="cpu", seed=7)
    got = dict(hybrid.named_parameters())
    drawn_after = ("gmu.", "proj1.", "proj2.", "out_layer.")
    shared = [n for n, _ in plain.named_parameters()
              if not n.startswith(drawn_after)]
    assert len(shared) > 100
    for n, p in plain.named_parameters():
        if n in shared:
            assert torch.equal(p, got[n]), n
    new = {n for n in got if "_early" in n or n.endswith("_e.weight")}
    new.add(f"gmu.hidden{plain.gmu.n_inputs + 1}.weight")
    assert set(got) - set(dict(plain.named_parameters())) == new


@pytest.mark.parametrize("layers,early", [(2, 3), (4, 4)])
def test_early_encoders_have_at_least_three_layers(layers, early):
    cfg = config_from_dict(dataclasses.asdict(
        EXPERIMENTS["mmtrvat"]())).model.replace(layers=layers)
    model = get_model(cfg, device="meta")
    assert len(model.trans_v_early.layers) == early
    assert len(model.trans_v_with_l.layers) == layers
    assert not model.trans_v_early.layers[0].biprojection


def test_hybrid_launch_structure(monkeypatch):
    """The early encoders add 3 x max(L, 3) self-attentions at reduced_dim
    x reduced_dim (the band: causal) and 3 x (2 max(L, 3) + 1)
    LayerNorms per forward, in training too (one input: no separate V);
    their attention dropout is attn_dropout."""
    jexp = EXPERIMENTS["mmtrvapt"]()
    cfg = config_from_dict(dataclasses.asdict(jexp)).model
    model = get_model(cfg, device="cpu", seed=2)
    inputs = [_t(v) for v in jmodel_inputs("mmtrvapt", _batch(jexp, 3))]
    counts = _count_calls(monkeypatch)
    classes = []
    fwd = tflash._forward

    def spy(q, k, v, masked, kv_lens, rate, seed, place=None):
        classes.append((q.shape[2], k.shape[2], masked))
        return fwd(q, k, v, masked, kv_lens, rate, seed, place)
    monkeypatch.setattr(tflash, "_forward", spy)
    L = max(cfg.layers, 3)
    for training in (False, True):
        for key in counts:
            counts[key] = 0
        classes.clear()
        model.train(training)
        with torch.no_grad():
            model(*inputs, dropout_seed=1 if training else None)
        ln, flash, drop = _expected(cfg.replace(hybrid=False), training)
        assert counts["ln"] == ln + 3 * (2 * L + 1)
        assert counts["flash"] == flash + 3 * L
        assert counts["flash_dropout"] == drop + (3 * L if training else 0)
        assert classes.count((32, 32, True)) == 3 * L
    model.eval()
    # moviescope's full depth: BERT 12 + 84 - 12 + 3 x 4 = 96 flash calls
    from bpx_torch.config import get_preset
    full = get_preset("moviescope").model
    assert _expected(full, False)[1] + 3 * max(full.layers, 3) == 96


def test_hybrid_recompute_gives_the_same_gradients():
    """With ``remat`` the early encoders recompute their layers too: the
    gradients of a training micro-step (every dropout on) are bitwise
    those without."""
    jexp = EXPERIMENTS["mmtrvat"]()
    cfg = config_from_dict(dataclasses.asdict(jexp)).model
    inputs = [_t(v) for v in jmodel_inputs("mmtrvat", _batch(jexp, 3))]
    grads = []
    for remat in (False, True):
        model = get_model(cfg.replace(remat=remat), device="cpu",
                          seed=4).train()
        model(*inputs, dropout_seed=9).square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    assert grads[0]["trans_a_early.layers.2.fc1.weight"].abs().sum() > 0
