"""The port's LayerNorm (plain versions, CPU) against the JAX package's
Pallas LayerNorm in interpret mode (``BPX_FORCE_PALLAS=1``), forward and,
through ``jax.vjp``, backward (``_ln_bwd_kernel``).

Inputs are made with numpy from a seed.  fp32 output: atol/rtol 2e-5 (the
same function, sums in another order).  bf16 output: within one bf16 ulp
(2**-7 relative), since both round the same fp32 value and a last-bit fp32
difference may cross a rounding boundary.  Backward: dx, dW and db within
atol/rtol 2e-5 of the largest entry in fp32; with bf16 input dx is within
one bf16 ulp.  Besides small shapes, the model's own LayerNorm classes
(1600 x 768 bf16, both of its eps), a row count that the kernels' grid
splits unevenly, and mmtrvpa's 1536-wide memory encoders.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bpx.ops.norm import _ln_fwd as pallas_ln_fwd
from bpx.ops.norm import layer_norm as bpx_layer_norm

import jax

from bpx_torch.ops.norm import (LayerNorm, layer_norm,
                                layer_norm_backward_reference,
                                layer_norm_reference)


def _inputs(n, e, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, e) * 2.0 + 0.5).astype(np.float32)
    w = (rng.rand(e) + 0.5).astype(np.float32)
    b = rng.randn(e).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("e,eps,out", [
    (768, 1e-12, "float32"),      # BERT's LayerNorms
    (768, 1e-6, "float32"),       # the encoders'
    (768, 1e-12, "bfloat16"),
    (768, 1e-6, "bfloat16"),
    (300, 1e-6, "float32"),       # a width the TPU kernel's lane gate skips
    (1536, 1e-6, "float32"),      # mmtrvpa's 2E-wide memory encoders
    (1536, 1e-6, "bfloat16"),
])
def test_layer_norm_reference_matches_pallas(monkeypatch, e, eps, out):
    monkeypatch.setenv("BPX_FORCE_PALLAS", "1")
    x, w, b = _inputs(64, e)
    want = np.asarray(bpx_layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), eps,
                                     out_dtype=jnp.dtype(out)), np.float32)
    tdt = getattr(torch, out)
    got, mu, rstd = layer_norm_reference(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(b), eps, tdt)
    assert got.dtype == tdt
    if out == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=1e-6, rtol=2 ** -7)
    # the statistics the kernel saves for the backward
    _, want_mu, want_rstd = pallas_ln_fwd(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), eps, jnp.float32)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu)[:, 0],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd)[:, 0],
                               atol=2e-5, rtol=2e-5)


def test_layer_norm_module_and_wrapper_on_cpu():
    x, w, b = _inputs(6, 40, seed=1)
    ln = LayerNorm(40, eps=1e-6, dtype=torch.bfloat16)
    assert set(dict(ln.named_parameters())) == {"weight", "bias"}
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        y = ln(torch.from_numpy(x).reshape(2, 3, 40))
    ref, _, _ = layer_norm_reference(torch.from_numpy(x), ln.weight, ln.bias,
                                     1e-6, torch.bfloat16)
    assert y.shape == (2, 3, 40) and y.dtype == torch.bfloat16
    assert torch.equal(y.reshape(6, 40), ref)
    with pytest.raises(ValueError, match="weight/bias"):
        layer_norm(torch.from_numpy(x), ln.weight[:4], ln.bias, 1e-6)


@pytest.mark.parametrize("n,e,eps,dt", [
    (64, 768, 1e-12, "float32"),
    (40, 768, 1e-6, "bfloat16"),
    (24, 300, 1e-6, "float32"),
    (64, 1536, 1e-6, "float32"),    # mmtrvpa's memory encoders
    (40, 1536, 1e-6, "bfloat16"),
])
def test_layer_norm_backward_matches_pallas(monkeypatch, n, e, eps, dt):
    monkeypatch.setenv("BPX_FORCE_PALLAS", "1")
    x, w, b = _inputs(n, e, seed=2)
    g = np.random.RandomState(3).randn(n, e).astype(np.float32)
    jdt = jnp.dtype(dt)
    xj = jnp.asarray(x, jdt)
    _, vjp = jax.vjp(lambda a, s, c: bpx_layer_norm(a, s, c, eps,
                                                    out_dtype=jdt),
                     xj, jnp.asarray(w), jnp.asarray(b))
    wdx, wdw, wdb = vjp(jnp.asarray(g, jdt))

    tdt = getattr(torch, dt)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt)
    xt.requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = layer_norm(xt, wt, bt, eps, tdt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt
    close = lambda a, ref, tol: np.testing.assert_allclose(
        a, ref, atol=tol * np.abs(ref).max(), rtol=tol)
    if dt == "float32":
        close(xt.grad.numpy(), np.asarray(wdx), 2e-5)
    else:
        np.testing.assert_allclose(xt.grad.float().numpy(),
                                   np.asarray(wdx, np.float32),
                                   atol=1e-6, rtol=2 ** -7)
    close(wt.grad.numpy(), np.asarray(wdw), 2e-5)
    close(bt.grad.numpy(), np.asarray(wdb), 2e-5)


def _bf16_pair(n, e, seed):
    """bf16 x of (n, e) as a jax array and as a torch tensor, same values."""
    x, w, b = _inputs(n, e, seed)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    return xj, xt, w, b


# the model's LayerNorm classes (moviescope, batch 8: 1600 and 4096 rows of
# 768, bf16 in and out; BERT's eps 1e-12, the encoders' 1e-6), and 1336 rows
# (8 x 167), which the kernels' card-sized grid splits unevenly, at 768 and
# at mmtrvpa's 1536 (its memory encoders, the warp-pair path on the card)
MODEL_CLASSES = [(1600, 1e-6, 768), (1600, 1e-12, 768), (1336, 1e-6, 768),
                 (1336, 1e-6, 1536)]
MODEL_IDS = [f"{n}-{eps}" + ("" if e == 768 else f"-{e}")
             for n, eps, e in MODEL_CLASSES]


@pytest.mark.parametrize("n,eps,e", MODEL_CLASSES, ids=MODEL_IDS)
def test_layer_norm_at_the_model_classes_matches_pallas(monkeypatch, n, eps,
                                                        e):
    monkeypatch.setenv("BPX_FORCE_PALLAS", "1")
    xj, xt, w, b = _bf16_pair(n, e, seed=5)
    want = bpx_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), eps,
                          out_dtype=jnp.bfloat16)
    _, want_mu, want_rstd = pallas_ln_fwd(xj, jnp.asarray(w), jnp.asarray(b),
                                          eps, jnp.bfloat16)
    got, mu, rstd = layer_norm_reference(xt, torch.from_numpy(w),
                                         torch.from_numpy(b), eps,
                                         torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (n, e)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu)[:, 0],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd)[:, 0],
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n,eps,e", MODEL_CLASSES, ids=MODEL_IDS)
def test_layer_norm_backward_at_the_model_classes_matches_pallas(
        monkeypatch, n, eps, e):
    monkeypatch.setenv("BPX_FORCE_PALLAS", "1")
    xj, xt, w, b = _bf16_pair(n, e, seed=6)
    g = np.random.RandomState(7).randn(n, e).astype(np.float32)
    gj = jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, s, c: bpx_layer_norm(
        a, s, c, eps, out_dtype=jnp.bfloat16), xj, jnp.asarray(w),
        jnp.asarray(b))
    wdx, wdw, wdb = vjp(gj)

    _, mu, rstd = layer_norm_reference(xt, torch.from_numpy(w),
                                       torch.from_numpy(b), eps)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        torch.bfloat16)
    dx, dw, db = layer_norm_backward_reference(xt, torch.from_numpy(w), mu,
                                               rstd, gt)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(wdx, np.float32),
                               atol=1e-6, rtol=2 ** -7)
    for got, want in ((dw, wdw), (db, wdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2e-5 * np.abs(want).max(), rtol=2e-5)


def test_layer_norm_backward_reference_shapes():
    x, w, _ = _inputs(6, 40, seed=4)
    xt = torch.from_numpy(x).reshape(2, 3, 40)
    _, mu, rstd = layer_norm_reference(xt, torch.from_numpy(w),
                                       torch.zeros(40), 1e-6)
    dx, dw, db = layer_norm_backward_reference(
        xt, torch.from_numpy(w), mu, rstd, torch.ones(2, 3, 40))
    assert dx.shape == (2, 3, 40) and dw.shape == db.shape == (40,)
    assert torch.allclose(db, torch.full((40,), 6.0))
