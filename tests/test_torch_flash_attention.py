"""The port's flash attention (plain version, CPU) against the JAX
package's Pallas kernel in interpret mode, outputs and log-sum-exp.

Inputs are made with numpy from a seed; fp32, atol/rtol 2e-5 (the same
function, sums in another order).  On the card, chip_smoke.py holds the
CUDA kernel against this plain version.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bpx.ops.pallas_attention import _fwd as pallas_fwd
from bpx.ops.pallas_attention import flash_attention as pallas_flash

from bpx_torch.ops.flash_attention import (effective_band, flash_attention,
                                           flash_attention_reference)

TOL = dict(atol=2e-5, rtol=2e-5)


def _inputs(B, H, Tq, Tk, D, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Tq, D) * 0.3).astype(np.float32)
    k = (rng.randn(B, H, Tk, D) * 0.3).astype(np.float32)
    v = rng.randn(B, H, Tk, D).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens", [
    (1, 2, 128, 128, 64, True, None),      # causal
    (1, 2, 128, 256, 64, True, None),      # band, offset 128
    (1, 2, 256, 128, 96, True, None),      # tall band
    (2, 2, 200, 200, 96, True, None),      # ragged T, causal
    (2, 2, 160, 64, 96, True, None),       # offset 96 >= Tk-1: band dropped
    (4, 1, 128, 128, 64, False, (128, 37, 1, 0)),   # key padding, one empty
    (2, 2, 200, 120, 96, True, (120, 50)),          # band + key padding
])
def test_flash_reference_matches_pallas(B, H, Tq, Tk, D, masked, lens):
    q, k, v = _inputs(B, H, Tq, Tk, D)
    kv = None if lens is None else np.asarray(lens, np.int32)

    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        masked=masked,
                        kv_lens=None if kv is None else jnp.asarray(kv),
                        layout="bhtd", out_layout="bhtd")
    # log-sum-exp straight from the Pallas forward, on (B*H, T, D)
    eff_masked, offset = effective_band(Tq, Tk, masked)
    kvl = (np.full(B * H, Tk, np.int32) if kv is None
           else np.repeat(kv, H).astype(np.int32))
    flat = lambda x: jnp.asarray(x.reshape(B * H, x.shape[2], D))
    _, want_lse = pallas_fwd(flat(q), flat(k), flat(v), jnp.asarray(kvl),
                             jnp.zeros((1,), jnp.uint32), eff_masked, offset,
                             0.0, kv is None)

    got, got_lse = flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        masked=masked, kv_lens=None if kv is None else torch.from_numpy(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy().reshape(B * H, Tq),
                               np.asarray(want_lse)[:, 0, :], **TOL)


def test_band_is_dropped_only_when_vacuous():
    assert effective_band(512, 200, True) == (False, 312)
    assert effective_band(200, 512, True) == (True, 312)
    assert effective_band(200, 200, True) == (True, 0)
    assert effective_band(201, 200, True) == (True, 1)
    assert effective_band(512, 512, False) == (False, 0)


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 2, 24, 40, 64, seed=1))
    lens = torch.tensor([40, 7], dtype=torch.int32)
    out, lse = flash_attention(q, k, v, masked=True, kv_lens=lens,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, True, lens)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    assert out.shape == (2, 2, 24, 64) and lse.dtype == torch.float32


def test_wrapper_rejects_what_it_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 16, 64))
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, k, v, kv_lens=torch.ones(3, dtype=torch.int32))
