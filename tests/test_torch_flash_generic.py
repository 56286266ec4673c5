"""The flash kernels' whole domain: any head dim from 1 to 256, in bf16 and
in fp32, against the JAX package.

The JAX package's Pallas kernels take any raw head dim and keep their
operands in the input dtype; on the card the port runs bf16 at the tabled
head dims on the tabled kernels, bf16 at every other head dim up to 256 on
their panel builds, fp32 up to 256 on the generic kernels of
``csrc/flash_generic.cu`` and both above 256 on the chunked ones
(``kernel_route``).  Here, on the CPU, the
port's wrappers compute their plain versions, held against bpx's Pallas
kernels in interpret mode: the forward, its log-sum-exp and ``jax.vjp`` at
head dims between and beyond the tabled ones (band, ``kv_lens`` with an
empty row, dropout), bf16 at two of them, the route table at its edges,
and at the model level an mmtrvapt at head dim 48 and the README's
synthetic configuration (fp32, head dim 16) with ``attention_impl
"pallas"``, served and one step's loss and gradients, against bpx under
``BPX_FORCE_PALLAS=1``.

Inputs are made with numpy from a seed.  fp32 at atol/rtol 2e-5 (the same
function, summed in another order); bf16 as stated at its test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.ops.pallas_attention import _fwd as pallas_fwd
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
from tests.test_torch_model import _batch, _tiny_experiment
from tests.test_torch_train import FREQS, _no_dropout
from tests.test_torch_loop import few_threads  # noqa: F401


def _bpx_lse(q, k, v, masked, kv):
    """The Pallas forward's log-sum-exp, (B*H, Tq)."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    eff_masked, offset = tflash.effective_band(Tq, Tk, masked)
    kvl = (np.full(B * H, Tk, np.int32) if kv is None
           else np.repeat(kv, H).astype(np.int32))
    flat = lambda x: jnp.asarray(x.reshape(B * H, x.shape[2], D))
    _, lse = pallas_fwd(flat(q), flat(k), flat(v), jnp.asarray(kvl),
                        jnp.zeros((1,), jnp.uint32), eff_masked, offset, 0.0,
                        kv is None)
    return np.asarray(lse)[:, 0, :]


@pytest.mark.parametrize("D", [8, 16, 32, 48, 80, 112, 160, 224])
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", [
    (2, 2, 70, 100, True, (100, 0), 0.2),       # band offset 30, empty row
    (2, 1, 100, 65, True, (65, 40), 0.0),       # tall band, kv_lens
])
def test_generic_head_dims_match_pallas(D, B, H, Tq, Tk, masked, lens,
                                        rate):
    """Head dims between and beyond the tabled ones (8 to 224): the
    forward, its lse and the backward against bpx, with the band offset,
    ``kv_lens`` (one row with no visible key, which attends uniformly in
    the forward and gets zero dQ) and dropout at 0.2.  The absolute
    tolerance is 2e-5 of each tensor's largest entry (at least 2e-5), as
    ``test_head_dim_128_matches_pallas``."""
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=D)
    dout = np.random.RandomState(D + 1).randn(B, H, Tq, D).astype(np.float32)
    kv = np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0xC0FFEE + D)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0xC0FFEE + D)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)
    _, lse = tflash.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), masked,
        torch.from_numpy(kv))
    np.testing.assert_allclose(lse.numpy().reshape(B * H, Tq),
                               _bpx_lse(q, k, v, masked, kv), **TOL)
    if 0 in lens:
        b = lens.index(0)
        assert not got[1][b].any() and got[0][b].any()


@pytest.mark.parametrize("D", [48, 80])
def test_generic_head_dims_in_bf16_match_pallas(D):
    """bf16 inputs on both sides (bpx's kernels keep the input dtype, the
    plain version casts P and dS to it as they do): the output and the
    gradients within 2e-2 of each tensor's largest entry, two bf16 ulps
    (2**-8 each) at the casts of P, dS and the outputs, where an fp32 sum
    taken in another order rounds to the neighbouring bf16 value; the
    fp32 lse within 1e-5."""
    B, H, Tq, Tk = 2, 2, 70, 100
    q, k, v = (x.astype(jnp.bfloat16) for x in _inputs(B, H, Tq, Tk, D,
                                                       seed=D + 2))
    dout = np.random.RandomState(D + 3).randn(B, H, Tq, D).astype(
        jnp.bfloat16)
    kv = np.asarray((100, 0), np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, kv, 0.2, 0xB16 + D)
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16)
    qt, kt, vt = (bf(x).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(qt, kt, vt, True, torch.from_numpy(kv), 0.2,
                                 0xB16 + D)
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
    np.testing.assert_allclose(lse.detach().numpy().reshape(B * H, Tq),
                               _bpx_lse(q, k, v, True, kv), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 1, "panel"), (torch.bfloat16, 24, "panel"),
    (torch.bfloat16, 25, "tabled"), (torch.bfloat16, 26, "panel"),
    (torch.bfloat16, 48, "panel"), (torch.bfloat16, 64, "tabled"),
    (torch.bfloat16, 255, "panel"), (torch.bfloat16, 256, "tabled"),
    (torch.float32, 1, "generic"), (torch.float32, 25, "generic"),
    (torch.float32, 64, "generic"), (torch.float32, 256, "generic"),
    (torch.bfloat16, 257, "chunked"), (torch.float32, 257, "chunked"),
    (torch.float32, 300, "chunked"), (torch.bfloat16, 384, "chunked"),
    (torch.bfloat16, 512, "chunked"), (torch.float32, 1536, "chunked"),
    (torch.bfloat16, 4096, "chunked"), (torch.float32, 4096, "chunked"),
])
def test_kernel_route(dtype, D, route):
    """bf16 at a tabled head dim takes the tabled kernels; bf16 at any other
    head dim from 1 to 256 their panel builds, at the panel width that
    holds it; fp32 at every one the generic kernels; either dtype above
    256, with no upper limit, the chunked kernels, whose column chunks
    cover D with the last one partial."""
    assert tflash.kernel_route(dtype, D) == route
    assert (route == "tabled") == (dtype == torch.bfloat16
                                   and D in tflash.KERNEL_HEAD_DIMS)
    assert (route == "chunked") == (D > tflash.GENERIC_MAX_HEAD_DIM)
    assert (route == "generic") == (dtype == torch.float32
                                    and D <= tflash.GENERIC_MAX_HEAD_DIM)
    if route == "panel":
        w = tflash.panel_width(D)
        assert w in tflash.PANEL_WIDTHS and D <= w
    if route == "generic":
        w = tflash.generic_width(D)
        assert w in tflash.GENERIC_WIDTHS and D <= w
        assert w == 32 or D > w // 2
    if route == "chunked":
        n = tflash.column_chunks(D)
        assert (n - 1) * tflash.CHUNK_COLUMNS < D <= n * tflash.CHUNK_COLUMNS


@pytest.mark.parametrize("dtype,D,error", [
    (torch.bfloat16, -1, ValueError),
    (torch.float32, 0, ValueError),
    (torch.bfloat16, 0, ValueError),
    (torch.float16, 64, TypeError), (torch.float16, 48, TypeError),
    (torch.float64, 32, TypeError), (torch.float16, 300, TypeError),
    (torch.float64, 512, TypeError),
])
def test_kernel_route_rejects_what_no_kernel_takes(dtype, D, error):
    """A head dim below 1 (the kernels raise, naming the limit) or a dtype
    other than bf16 and fp32, above 256 too, has no route, and
    ``blocks_per_sm`` raises for it before it loads the kernels.  Every
    head dim above 256 has one in bf16 and fp32 (the chunked kernels)."""
    with pytest.raises(error, match="1 or more" if error is ValueError
                       else "bfloat16 or float32"):
        tflash.kernel_route(dtype, D)
    with pytest.raises(error):
        tflash.blocks_per_sm(D, dtype)


def test_generic_route_takes_strided_views_uncopied():
    """The generic kernels take any strides whose last dim is contiguous:
    a fused projection's (B, H, T, D) views at an odd D go to them as they
    are, in either dtype; a view whose last dim is strided is copied."""
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.zeros(2, 9, 3, 4, 33, dtype=dtype)
        for i in range(3):
            t = buf[:, :, i].transpose(1, 2)
            assert tflash._kernel_ready("t", t, t.device, "generic") is t
        strided = torch.zeros(2, 4, 9, 66, dtype=dtype)[..., ::2]
        ready = tflash._kernel_ready("t", strided, strided.device, "generic")
        assert ready is not strided and ready.stride(3) == 1
        assert torch.equal(ready, strided)
    with pytest.raises(TypeError, match="one dtype"):
        tflash._route(torch.zeros(1, 1, 2, 8),
                      torch.zeros(1, 1, 2, 8, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the model level
# ---------------------------------------------------------------------------

def _d48_experiment():
    """The tiny mmtrvapt at hidden 96 over 2 heads (head_dim 48, a head
    dim the tabled kernels do not take) and one layer an encoder, BERT's
    heads at 16, fp32, ``attention_impl`` pallas, every dropout off."""
    jexp = _no_dropout(_tiny_experiment())
    return jexp.replace(model=jexp.model.replace(hidden_sz=96, num_heads=2,
                                                 layers=1))


def _readme_synthetic_experiment():
    """The README's synthetic command (``--hidden_sz 64 --num_heads 4
    --compute_dtype float32``: BERT's heads at orig_d_l // 16, so every
    flash call at head dim 16) with ``--attention_impl pallas``, cut to
    one layer an encoder and one BERT layer, shorter streams, every
    dropout off."""
    from bpx.config import get_preset as jget_preset
    exp = jget_preset("synthetic-tiny")
    base = _no_dropout(exp)
    m = base.model
    model = m.replace(
        hidden_sz=64, num_heads=4, layers=1, num_vectors_l=16,
        num_vectors_a=12, num_vectors_v=12, orig_d_l=64, orig_d_v=48,
        orig_d_a=96, orig_d_p=40, attention_impl="pallas",
        compute_dtype="float32",
        bert=dataclasses.replace(m.bert, num_layers=1, hidden_size=64,
                                 num_heads=64 // 16,
                                 intermediate_size=128))
    data = dataclasses.replace(exp.data, audio_raw_len=576, video_len=12)
    return base.replace(model=model, data=data)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def force_pallas():
    """bpx's attention on its Pallas kernels (interpret mode) off the TPU."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BPX_FORCE_PALLAS", "1")
    yield
    mp.undo()


@pytest.mark.parametrize("make,head_dims", [
    (_d48_experiment, {48, 16}), (_readme_synthetic_experiment, {16})])
def test_model_at_generic_head_dims_matches_bpx_pallas(force_pallas, make,
                                                       head_dims,
                                                       monkeypatch):
    """The served forward (4 requests through the port's ``Predictor``)
    and one micro-step's loss and gradients of the port against bpx's
    model on its Pallas kernels (one jitted ``value_and_grad`` whose aux is
    the logits), from the same weights: every flash call of the port at
    the head dims the model gives (48 in the encoders, BERT's 16; the
    README's configuration 16 throughout), none of them tabled in bf16.
    Served at 1e-4 (as ``tests/test_torch_model.py``), gradients as
    ``tests/test_torch_train.py::_lockstep``'s step 1."""
    jexp = make()
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
    assert seen == head_dims

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
