"""The port's ``group_encoders`` against the JAX package's and against the
port's own ungrouped model.

With ``group_encoders`` the 12 crossmodal encoders are 6 pairs (``g_va``
... ``g_xl2``), every parameter with a leading pair axis of 2 (bpx's
``nn.vmap`` pair; in front of the scanned layer axis when the encoders
are scanned).  Served outputs of both models against bpx's grouped models
from the same weights (``params_from_flax``), and the port's grouped model
against its ungrouped one with the pairs' weights stacked (bpx's
``_regroup``, ``tests/test_grouped_encoders.py``): outputs and gradients.
fp32 on the CPU, inputs from numpy seeds, tolerance ``TOL`` (1e-4).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import GROUPED, params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.ops.encoder import GroupedTransformerEncoder
from tests.test_torch_hybrid import served_against_bpx
from tests.test_torch_model import (TOL, _batch, _tiny_experiment,
                                    _tiny_vat_experiment)
from tests.test_torch_train import _count_calls, _expected
from tests.test_torch_loop import few_threads  # noqa: F401

# the pairs, as bpx groups the encoders
PAIRS = {
    "g_va": ("trans_v_with_a", "trans_a_with_v"),
    "g_xl": ("trans_v_with_l", "trans_a_with_l"),
    "g_lx": ("trans_l_with_v", "trans_l_with_a"),
    "g_l_bi": ("trans_l_with_v2a", "trans_l_with_a2v"),
    "g_x2l": ("trans_a_with_v2l", "trans_v_with_a2l"),
    "g_xl2": ("trans_a_with_l2v", "trans_v_with_l2a"),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _grouped(jexp):
    return jexp.replace(model=jexp.model.replace(group_encoders=True))


EXPERIMENTS = {
    # unrolled encoders (layer{i}: leaves (2, ...))
    "mmtrvapt": lambda: _grouped(_tiny_experiment()),
    # scanned encoders (layers: leaves (2, L, ...))
    "mmtrvat": lambda: _grouped(_tiny_vat_experiment("gmu", True)),
}


def regroup(state):
    """An ungrouped model's state dict with each pair's two encoders
    stacked into the pair's slot."""
    members = {n for pair in PAIRS.values() for n in pair}
    out = {k: v for k, v in state.items() if k.split(".")[0] not in members}
    for g, (a, b) in PAIRS.items():
        for k, v in state.items():
            if k.startswith(a + "."):
                rest = k[len(a):]
                out[g + rest] = torch.stack([v, state[b + rest]])
    return out


@pytest.mark.parametrize("name,n_final", [("mmtrvapt", 4), ("mmtrvat", 3)])
def test_served_grouped_matches_bpx(name, n_final):
    model, params = served_against_bpx(EXPERIMENTS[name](), n_final)
    assert set(GROUPED) <= set(params)
    for g in GROUPED:
        assert isinstance(getattr(model, g), GroupedTransformerEncoder)
    if name == "mmtrvat":
        assert "layers" in params["g_va"]
        assert params["g_va"]["layers"]["fc1"]["kernel"].shape[:2] == (2, 2)
    w = model.g_va.layers[0].fc1.weight
    assert w.shape == (2, 4 * model.config.hidden_sz, model.config.hidden_sz)


@pytest.mark.parametrize("name", ["mmtrvapt", "mmtrvat"])
def test_grouped_matches_ungrouped_port(name):
    """The grouped model with the ungrouped model's pairs stacked: the same
    logits and gates at eval, and the same gradients (stacked) of a loss
    on them."""
    jexp = EXPERIMENTS[name]()
    cfg = config_from_dict(dataclasses.asdict(jexp)).model
    ungrouped = get_model(cfg.replace(group_encoders=False), device="cpu",
                          seed=3)
    grouped = get_model(cfg, device="cpu", seed=0)
    grouped.load_state_dict(regroup(ungrouped.state_dict()))
    inputs = [_t(v) for v in jmodel_inputs(name, _batch(jexp, 3, seed=4))]
    outs = []
    for model in (ungrouped, grouped):
        logits, gates = model(*inputs, output_gates=True)
        (logits.square().sum() + gates.sum()).backward()
        outs.append((logits.detach(), gates.detach()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    want = regroup({n: p.grad for n, p in ungrouped.named_parameters()})
    got = {n: p.grad for n, p in grouped.named_parameters()}
    assert got.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=n)


def test_grouped_requires_uniform_dropouts():
    cfg = config_from_dict(dataclasses.asdict(
        EXPERIMENTS["mmtrvapt"]())).model
    with pytest.raises(ValueError, match="attn_dropout_a == attn_dropout_v"):
        get_model(cfg.replace(attn_dropout_a=0.1, attn_dropout_v=0.0),
                  device="meta")


def test_grouped_interop_raises_for_missing_and_leftover_keys():
    jexp = EXPERIMENTS["mmtrvat"]()
    exp = config_from_dict(dataclasses.asdict(jexp))
    inputs = jmodel_inputs("mmtrvat", {k: np.asarray(v) for k, v in
                                       _batch(jexp, 1).items()})
    params = jax.tree.map(np.asarray, jget_model(jexp.model).init(
        {"params": jax.random.PRNGKey(0)}, *inputs)["params"])
    sd = params_from_flax(params, exp.model)
    # a Dense kernel (2, L, in, out) becomes one (2, out, in) per layer
    k = params["g_x2l"]["layers"]["attn"]["q_proj"]["kernel"]
    assert torch.equal(sd["g_x2l.layers.1.attn.q_proj.weight"],
                       _t(np.swapaxes(k[:, 1], 1, 2)))
    missing = dict(params)
    missing["g_lx"] = dict(params["g_lx"])
    del missing["g_lx"]["final_norm"]
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(missing, exp.model)
    extra = dict(params)
    extra["g_extra"] = params["g_va"]
    with pytest.raises(KeyError, match="left over"):
        params_from_flax(extra, exp.model)
    # the ungrouped model's tree does not fit the grouped model
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(params, exp.model.replace(group_encoders=False))


@pytest.mark.parametrize("name", ["mmtrvapt", "mmtrvat"])
def test_grouped_launch_structure(name, monkeypatch):
    """Half the crossmodal attention calls, each over the pair folded into
    the batch (2B) through strided views of the projection; the same
    LayerNorms (one call per member)."""
    jexp = EXPERIMENTS[name]()
    cfg = config_from_dict(dataclasses.asdict(jexp)).model
    model = get_model(cfg, device="cpu", seed=2)
    B = 3
    inputs = [_t(v) for v in jmodel_inputs(name, _batch(jexp, B))]
    counts = _count_calls(monkeypatch)
    batches = []
    fwd = tflash._forward

    def spy(q, k, v, masked, kv_lens, rate, seed, place=None):
        batches.append((q.shape[0], q.is_contiguous()))
        return fwd(q, k, v, masked, kv_lens, rate, seed, place)
    monkeypatch.setattr(tflash, "_forward", spy)
    L, Lb = cfg.layers, cfg.bert.num_layers
    per_second = 2 if name == "mmtrvapt" else 1
    for training in (False, True):
        for key in counts:
            counts[key] = 0
        batches.clear()
        model.train(training)
        with torch.no_grad():
            model(*inputs, dropout_seed=1 if training else None)
        ln, flash, drop = _expected(cfg.replace(group_encoders=False),
                                    training)
        assert counts["ln"] == ln
        assert counts["flash"] == Lb + 3 * L + 3 * per_second * L
        # the encoders' share of the dropout calls halves
        assert counts["flash_dropout"] == (
            Lb + (drop - Lb) // 2 if training else 0)
        assert batches.count((2 * B, False)) == counts["flash"] - Lb
    model.eval()
    # moviescope: 12 BERT + 3 x 4 + 3 x 4 x 2 = 48 flash calls, 24 with
    # dropout in training
    from bpx_torch.config import get_preset
    full = get_preset("moviescope").model
    _, flash, drop = _expected(full, True)
    assert (12 + (flash - 12) // 2, 12 + (drop - 12) // 2) == (48, 24)


def test_grouped_recompute_gives_the_same_gradients():
    """A pair recomputes in full under ``remat`` (bpx: no policy for a
    pair): a training micro-step's gradients (every dropout on) are
    bitwise those without."""
    jexp = EXPERIMENTS["mmtrvapt"]()
    cfg = config_from_dict(dataclasses.asdict(jexp)).model.replace(
        remat_policy="save_attn")
    inputs = [_t(v) for v in jmodel_inputs("mmtrvapt", _batch(jexp, 3))]
    grads = []
    for remat in (False, True):
        model = get_model(cfg.replace(remat=remat), device="cpu",
                          seed=4).train()
        assert model.g_va.remat_policy is None
        model(*inputs, dropout_seed=9).square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
