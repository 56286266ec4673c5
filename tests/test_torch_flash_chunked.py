"""The flash kernels past head dim 256, in bf16 and in fp32, against the JAX
package.

The JAX package's Pallas kernels take any raw head dim; on the card the
port runs every head dim above 256 on the chunked kernels of
``csrc/flash_chunked.cu`` (``kernel_route`` "chunked"), whose blocks each
own 128 columns of the head dim.  Here, on the CPU, the port's wrappers
compute their plain versions (the same functions as at every other head
dim), held against bpx's Pallas kernels in interpret mode: the forward,
its log-sum-exp and ``jax.vjp`` at head dims 257, 300, 384 and 512 (band
offset, ``kv_lens`` with an empty row, dropout), bf16 at 384 (the route
table's edges are in ``tests/test_torch_flash_generic.py``), strided
views at 300, and at the model level a tiny
mmtrvapt at hidden 264 over one head (head dim 264 in the encoders),
served and one step's loss and gradients, against bpx under
``BPX_FORCE_PALLAS=1``.

Inputs are made with numpy from a seed.  fp32 at atol/rtol 2e-5 of each
tensor's largest entry (the same function, summed in another order); bf16
within 2e-2 of each tensor's largest entry, as stated at its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.serve import Predictor
from bpx_torch.train import losses
from tests.test_torch_flash_attention import (TOL, _bpx_fwd_vjp, _inputs,
                                              _port_fwd_bwd)
from tests.test_torch_flash_generic import _bpx_lse, _np_tree
from tests.test_torch_model import _batch, _tiny_experiment
from tests.test_torch_train import FREQS, _no_dropout
from tests.test_torch_loop import few_threads  # noqa: F401

#: a band offset of 26, ``kv_lens`` with a row of no visible key, rate 0.2
B, H, TQ, TK, LENS, RATE = 2, 1, 70, 96, (96, 0), 0.2


@pytest.mark.parametrize("D", [257, 300, 384, 512])
def test_chunked_head_dims_match_pallas(D):
    """Head dims past 256 (one column past the generic kernels' widest
    build, iemocap's 300 over one head, moviescope's 384 over two, 512):
    the forward, its lse and the backward against bpx, with the band
    offset, ``kv_lens`` (one row with no visible key, which attends
    uniformly in the forward and gets zero dQ) and dropout at 0.2.  The
    absolute tolerance is 2e-5 of each tensor's largest entry (at least
    2e-5)."""
    q, k, v = _inputs(B, H, TQ, TK, D, seed=D)
    dout = np.random.RandomState(D + 1).randn(B, H, TQ, D).astype(np.float32)
    kv = np.asarray(LENS, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, kv, RATE, 0xC0FFEE + D)
    got = _port_fwd_bwd(q, k, v, dout, True, kv, RATE, 0xC0FFEE + D)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)
    _, lse = tflash.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), True,
        torch.from_numpy(kv))
    np.testing.assert_allclose(lse.numpy().reshape(B * H, TQ),
                               _bpx_lse(q, k, v, True, kv), **TOL)
    b = LENS.index(0)
    assert not got[1][b].any() and got[0][b].any()


def test_chunked_head_dim_in_bf16_matches_pallas():
    """bf16 inputs on both sides at head dim 384 (bpx's kernels keep the
    input dtype, the plain version casts P and dS to it as they do): the
    output and the gradients within 2e-2 of each tensor's largest entry,
    two bf16 ulps (2**-8 each) at the casts of P, dS and the outputs,
    where an fp32 sum taken in another order rounds to the neighbouring
    bf16 value; the fp32 lse within 1e-5."""
    D = 384
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(B, H, TQ, TK, D,
                                                       seed=D + 2))
    dout = np.random.RandomState(D + 3).randn(B, H, TQ, D).astype(
        jnp.bfloat16)
    kv = np.asarray(LENS, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, kv, RATE, 0xB16 + D)
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    qt, kt, vt = (bf(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, True, torch.from_numpy(kv),
                                 RATE, 0xB16 + D)
    out.backward(bf(dout))
    got = (out, qt.grad, kt.grad, vt.grad)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max(),
                                   err_msg=name)
    _, lse = tflash.flash_attention_reference(qt, kt, vt, True,
                                              torch.from_numpy(kv))
    np.testing.assert_allclose(lse.detach().numpy().reshape(B * H, TQ),
                               _bpx_lse(q, k, v, True, kv), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("D", [1536, 4096])
def test_plain_versions_take_any_head_dim(D):
    """The plain versions the CPU runs at every head dim are the ones the
    chunked route runs here too (no copy of them for D > 256), and they
    take any D: the forward and backward against autograd through a dense
    masked softmax, at mmtrvpa's 2E-wide memory width over one head and
    at 4096."""
    rng = np.random.RandomState(D)
    q, k, v = (torch.from_numpy((rng.randn(1, 2, t, D) * 0.05).astype(
        np.float32)).requires_grad_(True) for t in (12, 16, 16))
    out = tflash.flash_attention(q, k, v, True)
    dout = torch.from_numpy(rng.randn(1, 2, 12, D).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), dout)
    band = torch.ones(12, 16, dtype=torch.bool).tril(4)
    s = (q @ k.transpose(-1, -2)).masked_fill(~band, -1e30)
    want_out = torch.softmax(s, -1) @ v
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    torch.testing.assert_close(out, want_out, **TOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5 * float(w.abs().max()),
                                   rtol=2e-5)
    assert tflash.kernel_route(torch.float32, D) == "chunked"
    assert tflash.column_chunks(D) == D // tflash.CHUNK_COLUMNS


def test_chunked_route_takes_strided_views_uncopied():
    """The chunked kernels take any strides whose last dim is contiguous:
    a fused projection's (B, H, T, D) views at D 300 go to them as they
    are, in either dtype; a view whose last dim is strided is copied."""
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.zeros(2, 9, 3, 2, 300, dtype=dtype)
        for i in range(3):
            t = buf[:, :, i].transpose(1, 2)
            assert tflash._route(t) == "chunked"
            assert tflash._kernel_ready("t", t, t.device) is t
        strided = torch.zeros(2, 2, 9, 600, dtype=dtype)[..., ::2]
        ready = tflash._kernel_ready("t", strided, strided.device, "chunked")
        assert ready is not strided and ready.stride(3) == 1
        assert torch.equal(ready, strided)


# ---------------------------------------------------------------------------
# the model level
# ---------------------------------------------------------------------------

def _d264_experiment():
    """The tiny mmtrvapt at hidden 264 over 1 head (head_dim 264 in the
    encoders, past the generic kernels' 256) and one layer an encoder,
    BERT's heads at 16, fp32, ``attention_impl`` pallas, every dropout
    off."""
    jexp = _no_dropout(_tiny_experiment())
    return jexp.replace(model=jexp.model.replace(hidden_sz=264, num_heads=1,
                                                 layers=1))


@pytest.fixture(scope="module")
def force_pallas():
    """bpx's attention on its Pallas kernels (interpret mode) off the TPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BPX_FORCE_PALLAS", "1")
    yield
    mp.undo()


def test_model_past_head_dim_256_matches_bpx_pallas(force_pallas,
                                                    monkeypatch):
    """The served forward (4 requests through the port's ``Predictor``)
    and one micro-step's loss and gradients of the port against bpx's
    model on its Pallas kernels (one jitted ``value_and_grad`` whose aux is
    the logits), from the same weights: the encoders' flash calls at head
    dim 264 (the chunked route on the card), BERT's at 16.  Served at 1e-4
    (as ``tests/test_torch_model.py``), gradients as
    ``tests/test_torch_train.py::_lockstep``'s step 1."""
    jexp = _d264_experiment()
    exp = config_from_dict(dataclasses.asdict(jexp))
    name = jexp.model.model
    batch = _batch(jexp, 4, seed=2)
    jin = jmodel_inputs(name, {k: jnp.asarray(v) for k, v in batch.items()})
    jmodel = jget_model(jexp.model)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  *jin)["params"]
    tparams = params_from_flax(_np_tree(params), exp.model)
    target = (np.random.RandomState(3).rand(4, jexp.model.n_classes)
              > 0.6).astype(np.float32)
    jloss = jlosses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10)

    def loss_and_logits(prm):
        logits = jmodel.apply({"params": prm}, *jin)
        return jloss(logits, jnp.asarray(target)), logits
    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_and_logits, has_aux=True))(params)

    seen = set()
    fwd = tflash._forward

    def spy(q, k, v, masked, kv_lens, rate, seed, place=None):
        seen.add(q.shape[3])
        return fwd(q, k, v, masked, kv_lens, rate, seed, place)
    monkeypatch.setattr(tflash, "_forward", spy)

    got = Predictor(exp, tparams, batch_size=4, device="cpu")(batch)
    np.testing.assert_allclose(got, np.asarray(jax.nn.sigmoid(jlogits)),
                               rtol=1e-4, atol=1e-4)
    assert seen == {264, 16}
    assert {tflash.kernel_route(torch.float32, d) for d in seen} == {
        "chunked", "generic"}

    from bpx_torch.inputs import model_inputs
    model = get_model(exp.model, device="cpu")
    model.load_state_dict(tparams)
    tl = losses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10)(
        model(*model_inputs(name, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})),
        torch.from_numpy(target))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    wants = params_from_flax(_np_tree(jgrads), exp.model)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(wants)
    floor = 1e-5 * max(float(w.abs().max()) for w in wants.values())
    for n, w in wants.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[n].numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max() + floor,
                                   err_msg=n)
