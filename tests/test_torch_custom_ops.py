"""The kernels as ``torch.library`` custom ops (namespace ``bpx_torch``):
``flash_fwd``, ``flash_bwd``, ``flash_delta``, ``layer_norm`` and
``layer_norm_bwd``.

``torch.library.opcheck`` holds each op's schema, fake impl (shapes,
dtypes and strides: the flash outputs are (B, H, T, D) views of (B, T, H, D)
memory on every device), autograd registration and AOT tracing against its
CPU impl, the plain version; autograd through the public wrappers equals the
plain backward; the flash forward and backward against the JAX package's
Pallas kernels in interpret mode.  fp32 inputs made with numpy from a seed;
tolerances: the plain backward 1e-5 (the same fp32 formula through the op),
bpx 1e-4 (as tests/test_torch_flash_attention.py).
"""

import numpy as np
import pytest
import torch

from bpx_torch.ops import flash_attention as fa
from bpx_torch.ops import norm
from bpx_torch.ops.flash_attention import (
    attention_delta_reference, flash_attention,
    flash_attention_backward_reference, flash_attention_reference)
from bpx_torch.ops.norm import layer_norm, layer_norm_backward_reference
from tests.test_torch_flash_attention import _bpx_fwd_vjp
from tests.test_torch_loop import few_threads  # noqa: F401

OPS = torch.ops.bpx_torch
B, H, TQ, TK = 2, 3, 7, 9


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


def _qkv(D, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = _t(rng, B, H, TQ, D), _t(rng, B, H, TK, D), _t(rng, B, H, TK, D)
    return q * D ** -0.5, k, v, _t(rng, B, H, TQ, D)


FLASH_CASES = [(D, kv, masked, rate) for D in (25, 64)
               for kv in (False, True) for masked in (False, True)
               for rate in (0.0, 0.1)]


def _flash_args(D, kv, masked, rate):
    q, k, v, dout = _qkv(D)
    kv_lens = torch.tensor([TK, 4], dtype=torch.int32) if kv else None
    # the ops take a list of seeds, one per group of the batch
    return q, k, v, dout, kv_lens, masked, rate, ([1234] if rate else None)


@pytest.mark.parametrize("D,kv,masked,rate", FLASH_CASES)
def test_flash_ops_pass_opcheck(D, kv, masked, rate):
    q, k, v, dout, kv_lens, masked, rate, seed = _flash_args(D, kv, masked,
                                                             rate)
    grad = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.library.opcheck(OPS.flash_fwd.default,
                          (*grad, kv_lens, masked, rate, seed))
    out, lse = OPS.flash_fwd(q, k, v, kv_lens, masked, rate, seed)
    assert out.stride() == out.transpose(1, 2).contiguous() \
        .transpose(1, 2).stride()
    torch.library.opcheck(OPS.flash_bwd.default,
                          (q, k, v, out, lse, dout, kv_lens, masked, rate,
                           seed))
    torch.library.opcheck(OPS.flash_delta.default, (dout, out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_ops_pass_opcheck(dtype):
    rng = np.random.RandomState(1)
    x = _t(rng, 3, 5, 16).to(dtype)
    w, b = _t(rng, 16), _t(rng, 16)
    grad = [t.clone().requires_grad_() for t in (x, w, b)]
    for out_dtype in (dtype, torch.float32):
        torch.library.opcheck(OPS.layer_norm.default,
                              (*grad, 1e-6, out_dtype))
    y, mu, rstd = OPS.layer_norm(x, w, b, 1e-6, dtype)
    torch.library.opcheck(OPS.layer_norm_bwd.default,
                          (x, w, mu, rstd, _t(rng, 3, 5, 16).to(dtype)))


@pytest.mark.parametrize("D,kv,masked,rate", FLASH_CASES[::3])
def test_flash_autograd_equals_the_plain_backward(D, kv, masked, rate):
    q, k, v, dout, kv_lens, masked, rate, seed = _flash_args(D, kv, masked,
                                                             rate)
    grad = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention(*grad, masked, kv_lens, rate, seed,
                               return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad
    got = torch.autograd.grad(out, grad, dout)
    ref_out, ref_lse = flash_attention_reference(q, k, v, masked, kv_lens,
                                                 rate, seed)
    want = flash_attention_backward_reference(
        q, k, v, dout, ref_lse, attention_delta_reference(dout, ref_out),
        masked, kv_lens, rate, seed)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # nothing is recorded when no input requires grad, or grad is off
    assert flash_attention(q, k, v, masked, kv_lens, rate, seed).grad_fn \
        is None
    with torch.no_grad():
        assert flash_attention(*grad, masked, kv_lens, rate, seed).grad_fn \
            is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_autograd_equals_the_plain_backward(dtype):
    rng = np.random.RandomState(2)
    x, w, b = _t(rng, 4, 6, 24).to(dtype), _t(rng, 24), _t(rng, 24)
    dy = _t(rng, 4, 6, 24).to(dtype)
    grad = [t.clone().requires_grad_() for t in (x, w, b)]
    y, mu, rstd = layer_norm(*grad, 1e-5, dtype, return_stats=True)
    assert not mu.requires_grad and not rstd.requires_grad
    got = torch.autograd.grad(y, grad, dy)
    want = layer_norm_backward_reference(x, w, mu, rstd, dy)
    for g, want_g in zip(got, want):
        torch.testing.assert_close(g, want_g, atol=1e-5, rtol=1e-5)
    assert layer_norm(x, w, b, 1e-5).grad_fn is None


def test_flash_ops_match_the_pallas_kernels():
    """The ops' CPU impls (forward, and the backward through autograd)
    against bpx's Pallas kernels in interpret mode, with kv_lens, the band
    and dropout."""
    q, k, v, dout, kv_lens, masked, rate, seed = _flash_args(64, True, True,
                                                             0.1)
    want = _bpx_fwd_vjp(*(t.numpy() for t in (q, k, v, dout)), masked,
                        kv_lens.numpy(), rate, seed)
    grad = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*grad, masked, kv_lens, rate, seed)
    got = (out,) + torch.autograd.grad(out, grad, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-4,
                                   rtol=1e-4)


def test_autograd_functions_are_replaced_by_the_ops():
    assert not hasattr(fa, "_FlashAttention")
    assert not hasattr(norm, "_LayerNorm")
    for name in ("flash_fwd", "flash_bwd", "flash_delta", "layer_norm",
                 "layer_norm_bwd"):
        assert hasattr(OPS, name)
