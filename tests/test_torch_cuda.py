"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the served forward does not reach (ragged tiles, an empty key
range, single rows, widths without vector loads, fp32 input and output).

Needs a CUDA device and skips elsewhere (the ``gen`` fixture decides).
On a machine with a card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: bf16 outputs 2e-2 (one bf16 rounding of values of order 1),
fp32 log-sum-exp 1e-3, fp32 LayerNorm output 1e-5.
"""

import pytest
import torch

from bpx_torch.ops.dispatch import plain_versions
from bpx_torch.ops.flash_attention import (flash_attention,
                                           flash_attention_reference)
from bpx_torch.ops.norm import layer_norm, layer_norm_reference


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, B, H, Tq, Tk, D):
    q = torch.randn(B, H, Tq, D, generator=gen, device="cuda") * D ** -0.5
    k = torch.randn(B, H, Tk, D, generator=gen, device="cuda")
    v = torch.randn(B, H, Tk, D, generator=gen, device="cuda")
    return tuple(x.to(torch.bfloat16) for x in (q, k, v))


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens", [
    (2, 3, 77, 130, 64, True, None),        # ragged tiles, band offset 53
    (2, 2, 130, 77, 96, True, None),        # tall band
    (2, 2, 300, 100, 96, True, None),       # band dropped (offset >= Tk-1)
    (3, 2, 64, 64, 64, False, (64, 0, 5)),  # an empty key range: uniform
    (1, 2, 1, 1, 96, True, None),           # single row and key
    (2, 2, 300, 300, 96, True, (300, 129)),  # band + key padding
])
def test_flash_kernel_matches_plain(gen, B, H, Tq, Tk, D, masked, lens):
    q, k, v = _qkv(gen, B, H, Tq, Tk, D)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, masked, kv, return_lse=True)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


def test_flash_kernel_takes_strided_views(gen):
    """The (B, H, T, D) views of a fused (B, T, 3, H, D) projection give
    the same result as contiguous copies."""
    B, T, H, D = 2, 100, 4, 96
    buf = torch.randn(B, T, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
    strided = flash_attention(q, k, v, True)
    dense = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            True)
    assert torch.equal(strided, dense)


def test_flash_kernel_rejects_and_plain_context(gen):
    q, k, v = _qkv(gen, 1, 2, 16, 16, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float())
    q32, k32, v32 = _qkv(gen, 1, 2, 16, 16, 32)
    with pytest.raises(NotImplementedError, match="head_dim"):
        flash_attention(q32, k32, v32)
    before = flash_attention.launches
    with plain_versions():
        out = flash_attention(q, k, v, True)
    assert flash_attention.launches == before
    ref, _ = flash_attention_reference(q, k, v, True)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("n,e", [(5, 768), (33, 300), (16, 1001), (7, 64),
                                 (3, 2048)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("y_dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_matches_plain(gen, n, e, x_dtype, y_dtype):
    x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(x_dtype)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    b = torch.randn(e, generator=gen, device="cuda")
    before = layer_norm.launches
    y, mu, rstd = layer_norm(x, w, b, 1e-6, y_dtype, return_stats=True)
    assert layer_norm.launches == before + 1
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-6, y_dtype)
    assert y.dtype == y_dtype
    tol = 2e-2 if y_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)


def test_layer_norm_kernel_rejects_non_contiguous(gen):
    x = torch.randn(8, 64, generator=gen, device="cuda")
    w, b = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    with pytest.raises(RuntimeError, match="contiguous"):
        layer_norm(x[:, ::2], w, b, 1e-6)
