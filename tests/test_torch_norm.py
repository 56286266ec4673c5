"""The port's LayerNorm (plain version, CPU) against the JAX package's
Pallas LayerNorm in interpret mode (``BPX_FORCE_PALLAS=1``).

Inputs are made with numpy from a seed.  fp32 output: atol/rtol 2e-5 (the
same function, sums in another order).  bf16 output: within one bf16 ulp
(2**-7 relative), since both round the same fp32 value and a last-bit fp32
difference may cross a rounding boundary.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bpx.ops.norm import _ln_fwd as pallas_ln_fwd
from bpx.ops.norm import layer_norm as bpx_layer_norm

from bpx_torch.ops.norm import LayerNorm, layer_norm, layer_norm_reference


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
