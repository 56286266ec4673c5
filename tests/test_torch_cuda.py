"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the model does not reach (ragged tiles, an empty key range,
single rows, widths without vector loads, fp32 input and output, a long
multi-tile shape) and at the model's own attention classes, forward and
backward, with and without dropout (and the hybrid early encoders' 32 x 32
causal class at every head dim); the narrow heads (head_dim 25 and 30)
at tile edges, on fused-projection views the wrapper must not copy, on a
view that ends its allocation, their exact dropout masks and the two
kernels of their backward; head_dim 128
(mmimdb) at tile edges, its model class, its fused views and its exact
masks, and its backward's own two kernels (dQ with delta, then the
two-warpgroup dK/dV kernel) at tile edges (nine key tiles, Tk < 64 < Tq,
kv_len below a tile and 0, B*H 1 with the band); the delta kernel alone;
the head_dim-128 forward's own kernel (the last query tile first, S of a
key tile beside P V of the one before) at tile edges with dropout and
bitwise reruns (nine query tiles, kv_lens, Tk < 64 < Tq, B*H 1 with the
band, the long online shapes) and named by the profiler beside the
generic kernel at 64 and 96; head_dim 192 (mmtrvpa's memory encoders)
at its model classes and tile edges, rate 0 and 0.1, its exact masks and
its kernels by name; head_dim 50, 60 and 256 (mmtrvpa's memory encoders at
the other presets) likewise, on fused views of their presets' heads side
by side, where a store past column D would show; synthetic-tiny served and
trained
through the einsum attention with no flash launch; the
LayerNorm kernels at the edges of their card-sized grid, on misaligned views
(their scalar paths), the device kernels one call runs (the profiler), and
the backward's phase stamps in a build with ``-DBPX_LN_TRACE``; the
kernels' custom ops (``opcheck``'s schema and fake checks on CUDA tensors,
and a recomputed call under the ``save_attn`` policy); twenty seeds under
vmap as folded launches of at most 16 seed groups; the panel builds
(bf16 at the untabled head dims up to 256, one in each panel width and odd
ones above 32), the generic kernels (fp32 at every head dim up to 256) and
the chunked ones (every head dim above 256, both dtypes) against the plain
versions at their edges, bitwise on reruns, their exact masks, their
kernels by name, their counters and their occupancy (``-k panel``,
``-k generic``, ``-k chunked``).

Needs a CUDA device and skips elsewhere (the ``gen`` fixture decides).
On a machine with a card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: bf16 outputs 2e-2 (one bf16 rounding of values of order 1),
fp32 log-sum-exp 1e-3, fp32 LayerNorm output 1e-5; bf16 gradients 2e-2
relative to the largest entry plus 1e-4 (sums of bf16-rounded products in
another order), fp32 LayerNorm weight and bias gradients 1e-4 relative.  The
dropout masks are compared for equality.
"""

import pytest
import torch

from bpx_torch.ops.dispatch import plain_versions
from bpx_torch.ops.flash_attention import (
    attention_delta, attention_delta_reference, flash_attention,
    flash_attention_backward, flash_attention_backward_reference,
    flash_attention_reference, keep_mask)
from bpx_torch.ops.norm import (layer_norm, layer_norm_backward,
                                layer_norm_backward_reference,
                                layer_norm_reference)


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


# head_dim 128 (flash_fwd_wide_kernel: the last query tile first, S of the
# next key tile beside P V of the one before) at rate 0 and 0.1
WIDE_FWD_EDGES = [row + (rate,) for row in [
    (2, 2, 576, 576, 128, True, None),          # nine query tiles, causal
    (2, 2, 576, 576, 128, True, (576, 300)),    # ... with kv_lens
    (2, 2, 130, 40, 128, True, None),           # Tk < 64 < Tq
    (1, 1, 200, 576, 128, True, None),          # B*H 1, band offset 376
    (1, 2, 640, 1280, 128, True, None),         # long: tk_p = Tk
    (2, 2, 200, 1100, 128, True, (1100, 700)),  # long: tk_p = 1152
] for rate in (0.0, 0.1)]


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens,rate", [
    (2, 3, 77, 130, 64, True, None, 0.0),        # ragged tiles, offset 53
    (2, 2, 130, 77, 96, True, None, 0.0),        # tall band
    (2, 2, 300, 100, 96, True, None, 0.0),       # band dropped
    (3, 2, 64, 64, 64, False, (64, 0, 5), 0.0),  # an empty key range
    (1, 2, 1, 1, 96, True, None, 0.0),           # single row and key
    (2, 2, 300, 300, 96, True, (300, 129), 0.0),  # band + key padding
    (2, 3, 77, 130, 128, True, None, 0.0),       # head_dim 128: ragged
    (3, 2, 64, 64, 128, False, (64, 0, 5), 0.0),  # an empty key range
    (2, 2, 300, 100, 128, True, None, 0.0),      # band dropped
] + WIDE_FWD_EDGES)
def test_flash_kernel_matches_plain(gen, B, H, Tq, Tk, D, masked, lens,
                                    rate):
    """The forward against the plain version (an empty key range attends
    uniformly), and bitwise on a rerun."""
    q, k, v = _qkv(gen, B, H, Tq, Tk, D)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = 0x5EED if rate else None
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    again, again_lse = flash_attention(q, k, v, masked, kv, rate, seed,
                                       return_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.parametrize("D,kernel", [
    (64, "flash_fwd_kernel<64, false>"), (96, "flash_fwd_kernel<96, false>"),
    (128, "flash_fwd_wide_kernel<128, false>")])
def test_flash_forward_kernel_names(gen, D, kernel):
    """The profiler names the forward's one device kernel: the generic
    kernel at head_dim 64 and 96, the wide kernel at 128, each in its
    instantiation for one seed group."""
    q, k, v = _qkv(gen, 2, 3, 200, 200, D)
    for _ in range(3):   # the profiler drops an event now and then: retry
        names = _device_kernels(lambda: flash_attention(q, k, v, True))
        if len(names) == 1:
            break
    assert len(names) == 1 and kernel in names[0], names


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
    """What no kernel takes raises on the card, with nothing launched and
    no fallback: float16, and a head_dim of 0; under ``plain_versions()``
    the plain version runs and nothing launches."""
    q, k, v = _qkv(gen, 1, 2, 16, 16, 64)
    before = flash_attention.launches
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q.half(), k.half(), v.half())
    q0 = torch.zeros(1, 2, 16, 0, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="1 or more"):
        flash_attention(q0, q0, q0)
    assert flash_attention.launches == before
    with plain_versions():
        out = flash_attention(q, k, v, True)
    assert flash_attention.launches == before
    ref, _ = flash_attention_reference(q, k, v, True)
    assert torch.equal(out, ref)


# row counts at the edges of the LayerNorm kernels' card-sized grid (132
# SMs on an H100; 8 rows per block at most per wave) and the model's 1600 and
# 4096; widths of the vector path (300, 768, 1024) and just past it (1032)
LN_EDGES = [(n, e) for n in (1, 131, 132, 133, 1600, 4096, 8193)
            for e in (300, 768, 1024, 1032)]


@pytest.mark.parametrize("n,e", [(5, 768), (33, 300), (16, 1001), (7, 64),
                                 (3, 2048)] + LN_EDGES)
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


def _close_grad(got, want):
    # 1e-4 absolute floor: where dp - delta cancels (a single visible key)
    # both sides hold rounding noise of order 1e-5
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2e-2 * scale + 1e-4, rtol=2e-2)


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens,rate", [
    (2, 3, 77, 130, 64, True, None, 0.0),       # ragged tiles, band
    (2, 2, 130, 77, 96, True, None, 0.1),       # tall band, dropout
    (2, 2, 300, 100, 96, True, None, 0.0),      # band dropped
    (3, 2, 64, 64, 64, False, (64, 0, 5), 0.1),  # kv_len 0: zero grads
    (1, 2, 1, 1, 96, True, None, 0.5),          # single row and key
    (2, 2, 300, 300, 96, True, (300, 129), 0.1),  # band + key padding
    (1, 2, 640, 1280, 64, True, None, 0.1),     # long: tk_p = Tk
    (2, 2, 200, 1100, 64, True, (1100, 700), 0.1),  # long: tk_p = 1152
    (2, 3, 77, 130, 128, True, None, 0.1),      # head_dim 128: ragged
    (3, 2, 64, 64, 128, False, (64, 0, 5), 0.1),  # kv_len 0: zero grads
    (2, 1, 129, 65, 128, False, (65, 1), 0.0),  # one visible key
    (1, 2, 640, 1280, 128, True, None, 0.1),    # long: ten query tiles
    (2, 2, 576, 576, 128, True, None, 0.0),     # nine key tiles, causal
    (2, 2, 576, 576, 128, True, (576, 300), 0.1),  # nine, kv_lens, dropout
    (2, 2, 130, 40, 128, True, None, 0.1),      # Tk < 64 < Tq
    (2, 2, 130, 40, 128, False, (40, 20), 0.0),  # ... without the band
    (3, 2, 200, 200, 128, True, (200, 40, 0), 0.1),  # kv_len < 64, and 0
    (1, 1, 200, 576, 128, True, None, 0.1),     # B*H 1, band offset 376
    (1, 1, 576, 130, 128, True, (129,), 0.0),   # B*H 1, band dropped
])
def test_flash_backward_kernel_matches_plain(gen, B, H, Tq, Tk, D, masked,
                                             lens, rate):
    q, k, v = _qkv(gen, B, H, Tq, Tk, D)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = 0xFFFFFFF0
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)

    dout = torch.randn(B, H, Tq, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, rate,
                                   seed)
    assert flash_attention_backward.launches == before + 1
    delta = (dout.float() * out.float()).sum(-1)
    want = flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                              masked, kv, rate, seed)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close_grad(g, w)
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert not got[0][b].any()        # no visible key: dq = 0
    # deterministic: no atomics
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,padded", [
    (8, 8, 200, 200, 96, True, False),     # causal
    (8, 8, 200, 512, 96, True, False),     # band, offset 312
    (8, 8, 512, 200, 96, True, False),     # band dropped
    (8, 8, 512, 512, 96, True, False),     # causal
    (8, 12, 512, 512, 64, False, True),    # BERT: kv_lens
    (8, 12, 512, 512, 25, True, False),    # iemocap: causal, head_dim 25
    (8, 10, 512, 512, 30, True, False),    # cmu-mosei: causal, head_dim 30
    (8, 6, 512, 512, 128, True, False),    # mmimdb: causal, head_dim 128
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_at_the_model_classes(gen, B, H, Tq, Tk, D, masked,
                                            padded, rate):
    """The model's attention classes (moviescope, batch 8), q/k/v strided
    views of fused projections as the model hands them over: forward and
    backward against the plain versions, and bitwise-equal reruns."""
    bf = torch.bfloat16
    qbuf = torch.randn(B, Tq, H, D, generator=gen, device="cuda")
    kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda").to(bf)
    q = (qbuf * D ** -0.5).to(bf).transpose(1, 2)
    k, v = kvbuf[:, :, 0].transpose(1, 2), kvbuf[:, :, 1].transpose(1, 2)
    kv = None
    if padded:
        kv = torch.randint(64, Tk + 1, (B,), generator=gen, device="cuda")
        kv[0] = Tk
        kv = kv.to(torch.int32)
    seed = 0x5EED5EED if rate else None
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
        bf).transpose(1, 2)
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, rate,
                                   seed)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        rate, seed)
    for g, w in zip(got, want):
        _close_grad(g, w)
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D,H", [(25, 12), (30, 10), (64, 12), (96, 8),
                                 (128, 6)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_at_the_hybrid_class(gen, D, H, rate):
    """The early encoders' self-attention (``hybrid``): batch 8, 32 x 32
    causal, half of a 64-row query tile past Tq, q/k/v views of one fused
    (B, T, 3, H, D) projection, which the wrapper must not copy: forward
    and backward against the plain versions, bitwise-equal reruns."""
    from bpx_torch.ops.flash_attention import _kernel_ready
    B, T = 8, 32
    buf = torch.randn(B, T, 3, H, D, generator=gen, device="cuda")
    buf[:, :, 0] *= D ** -0.5
    buf = buf.to(torch.bfloat16)
    q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
    for t in (q, k, v):
        assert _kernel_ready("t", t, t.device) is t
    seed = 0xB1B1 if rate else None
    out, lse = flash_attention(q, k, v, True, None, rate, seed,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, True, None, rate,
                                             seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    again = flash_attention(q, k, v, True, None, rate, seed)
    assert torch.equal(out, again)
    dout = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    got = flash_attention_backward(q, k, v, out, lse, dout, True, None, rate,
                                   seed)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), True, None,
        rate, seed)
    for g, w in zip(got, want):
        _close_grad(g, w)
    again = flash_attention_backward(q, k, v, out, lse, dout, True, None,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,T,D", [(8, 8, 200, 96), (8, 12, 512, 64),
                                     (2, 3, 77, 96), (1, 1, 1, 64),
                                     (8, 12, 512, 25), (8, 10, 512, 30),
                                     (2, 3, 77, 25), (1, 1, 1, 30),
                                     (8, 6, 512, 128), (2, 3, 77, 128)])
def test_flash_delta_kernel_matches_plain(gen, B, H, T, D):
    """The backward's first kernel alone: fp32 rowsum(dO * O) of strided
    bf16 views, against the plain sum (another order: 1e-4)."""
    out = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    dout = torch.randn(B, H, T, 2 * D, generator=gen, device="cuda").to(
        torch.bfloat16)[..., :D]
    before = attention_delta.launches
    got = attention_delta(dout, out)
    assert attention_delta.launches == before + 1
    want = attention_delta_reference(dout, out)
    assert got.shape == (B, H, T) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, attention_delta(dout, out))


def test_flash_dropout_mask_is_exact(gen):
    """q = 0 makes every probability 1/Tk; with V = I (Tk = D = 64) row i
    of O is keep[i] * bf16(inv_keep) / 64, and with dO = I (Tq = 64) row j
    of dV is keep[:, j] * bf16(inv_keep / 64): the masks of the forward and
    the backward kernels, bit for bit."""
    B, H, T, D, rate, seed = 2, 3, 64, 64, 0.1, 123456789
    q = torch.zeros(B, H, T, D, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(B, H, T, D, generator=gen, device="cuda").to(q.dtype)
    eye = torch.eye(D, device="cuda", dtype=q.dtype).expand(B, H, T, D)
    out, lse = flash_attention(q, k, eye, False, None, rate, seed,
                               return_lse=True)
    keep = keep_mask(seed, B, H, T, T, rate, "cuda")
    assert torch.equal(out != 0, keep)
    ref, _ = flash_attention_reference(q, k, eye, False, None, rate, seed)
    assert torch.equal(out, ref)
    _, _, dv = flash_attention_backward(q, k, eye, out, lse, eye, False,
                                        None, rate, seed)
    assert torch.equal(dv.transpose(-1, -2) != 0, keep)


# ---------------------------------------------------------------------------
# narrow heads (head_dim 25 and 30: the mmtrvat presets)
# ---------------------------------------------------------------------------

def _fused_views(gen, B, H, Tq, Tk, D):
    """q from a (B, Tq, 1, H, D) projection and k, v from a (B, Tk, 2, H,
    D) one, as (B, H, T, D) views: at D = 25 every row starts at an odd
    element offset of its buffer somewhere."""
    bf = torch.bfloat16
    qbuf = torch.randn(B, Tq, 1, H, D, generator=gen, device="cuda")
    kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda")
    q = (qbuf[:, :, 0] * D ** -0.5).to(bf).transpose(1, 2)
    kv = kvbuf.to(bf)
    return q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)


# (B, H, Tq, Tk, kv_lens when padded): lengths around the 64-row tiles,
# odd and even numbers of tiles (576 is nine; the narrow backward's grids
# take the tiles in reverse for dQ), Tk < 64 < Tq (one key tile), Tq != Tk
# with the band's offset, B*H = 1, and key lengths shorter than one tile
NARROW_EDGES = [(3, 2, T, T, (T, max(T // 2, 1), 1))
                for T in (1, 63, 64, 65, 200, 512, 576)] + [
    (3, 2, 77, 130, (130, 65, 1)), (3, 2, 130, 77, (77, 38, 1)),
    (3, 2, 130, 40, (40, 20, 1)), (1, 1, 200, 576, (40,)),
    (1, 1, 576, 130, (129,)), (1, 1, 321, 321, (321,))]


@pytest.mark.parametrize("D", [25, 30])
@pytest.mark.parametrize("B,H,Tq,Tk,lens", NARROW_EDGES)
@pytest.mark.parametrize("masked,padded", [(True, False), (False, True),
                                           (True, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_narrow_flash_kernels_match_plain(gen, D, B, H, Tq, Tk, lens,
                                          masked, padded, rate):
    """head_dim 25 and 30 at lengths around the 64-row tiles, band on and
    off, kv_lens, rate 0 and 0.1, on strided views of fused projections:
    forward and backward against the plain versions, and bitwise-equal
    backward reruns."""
    q, k, v = _fused_views(gen, B, H, Tq, Tk, D)
    kv = None
    if padded:
        kv = torch.tensor(lens, dtype=torch.int32, device="cuda")
    seed = 0xC0FFEE if rate else None
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    before = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, rate,
                                   seed)
    assert flash_attention_backward.launches == before + 1
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        rate, seed)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close_grad(g, w)
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D,H", [(25, 12), (30, 10), (128, 6), (50, 12),
                                 (60, 10), (256, 6)])
def test_narrow_fused_views_are_not_copied(gen, D, H):
    """The (B, H, T, D) views of a fused (B, T, 3, H, D) projection go to
    the kernels as they are (the wrapper copies nothing: T-stride 3 H D,
    H-stride D, odd at D = 25), and give what contiguous copies give, bit
    for bit, forward and backward; the narrow heads, mmimdb's 128 and
    mmtrvpa's memory encoders' 50, 60 and 256."""
    from bpx_torch.ops.flash_attention import _kernel_ready
    B, T = 2, 200
    buf = torch.randn(B, T, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
    assert q.stride() == (T * 3 * H * D, D, 3 * H * D, 1)
    for t in (q, k, v):
        assert _kernel_ready("t", t, t.device) is t
    dense = [t.contiguous() for t in (q, k, v)]
    out, lse = flash_attention(q, k, v, True, None, 0.1, 99,
                               return_lse=True)
    out_d, lse_d = flash_attention(*dense, True, None, 0.1, 99,
                                   return_lse=True)
    assert torch.equal(out, out_d) and torch.equal(lse, lse_d)
    # dO as autograd hands it over: a view of (B, T, H, D) memory
    dout = torch.randn(B, T, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    assert _kernel_ready("dO", dout, dout.device) is dout
    assert _kernel_ready("O", out, out.device) is out
    got = flash_attention_backward(q, k, v, out, lse, dout, True, None, 0.1,
                                   99)
    want = flash_attention_backward(*dense, out_d, lse_d,
                                    dout.contiguous(), True, None, 0.1, 99)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("D", [25, 30])
def test_narrow_view_ending_its_allocation(gen, D):
    """The last head of the last row ends the tensor's memory, and NaNs
    follow it in the same buffer: a load past column D - 1 would bring them
    into the products.  Forward and backward stay finite and match the
    plain versions."""
    B, T, H = 2, 65, 3
    n = B * T * 3 * H * D
    mem = torch.full((n + 64,), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    mem[:n] = torch.randn(n, generator=gen, device="cuda").to(mem.dtype)
    buf = mem[:n].view(B, T, 3, H, D)
    q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
    q = q * D ** -0.5
    assert v[-1, -1, -1].data_ptr() + 2 * D == buf.data_ptr() + 2 * n
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, True, None)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    dmem = mem.clone()
    dmem[:n] = torch.randn(n, generator=gen, device="cuda").to(mem.dtype)
    dout = dmem[:n].view(B, T, 3, H, D)[:, :, 2].transpose(1, 2)
    got = flash_attention_backward(q, k, v, out, lse, dout, True, None)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), True, None)
    for g, w in zip(got, want):
        assert torch.isfinite(g.float()).all()
        _close_grad(g, w)
    torch.testing.assert_close(attention_delta(dout, out),
                               attention_delta_reference(dout, out),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D", [25, 30, 64, 96, 128, 50, 60, 256])
def test_misaligned_contiguous_inputs_are_copied(gen, D):
    """A contiguous view that starts one element into its buffer (at D =
    30, 50, 60, 64, 96, 128, 256 its rows are not aligned for the kernels'
    copies) is copied to a fresh buffer; at D = 25 any even byte will do
    and it goes as it is.  Either way the forward matches the plain
    version."""
    from bpx_torch.ops.flash_attention import KERNEL_ALIGN, _kernel_ready
    B, H, T = 2, 3, 65
    n = B * H * T * D
    bf = torch.bfloat16
    q, k, v = (torch.randn(n + 1, generator=gen, device="cuda").to(bf)[1:]
               .view(B, H, T, D) for _ in range(3))
    q = q * D ** -0.5
    assert k.is_contiguous() and k.data_ptr() % 4 == 2
    ready = _kernel_ready("k", k, k.device)
    assert (ready is k) == (KERNEL_ALIGN[D] == 1)
    assert ready.data_ptr() % (2 * KERNEL_ALIGN[D]) == 0
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, True, None)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


def narrow_mask_bits(B, H, T, D, rate, seed):
    """(forward, backward) keep bits of the kernels at head_dim D < T,
    read off outputs: q = 0 makes every probability 1/T; with V_s[j, c] =
    [j == D s + c] column c of O is the keep bit of key D s + c, and with
    dO_s[i, c] = [i == D s + c] row j of dV holds the bits of query D s + c
    at key j.  ceil(T / D) rounds cover every (query, key)."""
    bf = torch.bfloat16
    q = torch.zeros(B, H, T, D, device="cuda", dtype=bf)
    k = torch.randn(B, H, T, D, device="cuda").to(bf)
    fwd = torch.zeros(B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    for s in range((T + D - 1) // D):
        c = j - D * s
        sel = ((c >= 0) & (c < D))
        onehot = torch.zeros(T, D, device="cuda", dtype=bf)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(B, H, T, D)
        out, lse = flash_attention(q, k, e, False, None, rate, seed,
                                   return_lse=True)
        _, _, dv = flash_attention_backward(q, k, e, out, lse, e, False,
                                            None, rate, seed)
        fwd[..., sel] = out[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    return fwd, bwd


@pytest.mark.parametrize("D", [25, 30])
def test_narrow_dropout_mask_is_exact(gen, D):
    """The forward and backward kernels' dropout masks at a narrow head
    dim, every bit of a 64 x 64 tile, against the plain version's."""
    B, H, T, rate, seed = 2, 3, 64, 0.1, 987654321
    fwd, bwd = narrow_mask_bits(B, H, T, D, rate, seed)
    keep = keep_mask(seed, B, H, T, T, rate, "cuda")
    assert torch.equal(fwd, keep)
    assert torch.equal(bwd, keep)


@pytest.mark.parametrize("D,H", [(25, 12), (30, 10), (128, 6)])
def test_narrow_backward_is_two_kernels(gen, D, H):
    """A narrow backward, and one at head_dim 128, is two device kernels of
    its own, the dQ kernel (which computes delta) and the dK/dV kernel,
    with no delta kernel and no memset."""
    q, k, v = _fused_views(gen, 2, H, 200, 200, D)
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    for _ in range(3):   # the profiler drops an event now and then: retry
        names = _device_kernels(lambda: flash_attention_backward(
            q, k, v, out, lse, dout, True, None))
        if len(names) == 2:
            break
    kind = "narrow" if D < 32 else "wide"
    assert len(names) == 2, names
    assert any(f"flash_bwd_{kind}_dq_kernel" in n for n in names), names
    assert any(f"flash_bwd_{kind}_dkdv_kernel" in n for n in names), names


def test_dropout_mask_is_exact_at_head_dim_128(gen):
    """The forward and backward kernels' dropout masks at head_dim 128
    (two warpgroups in the dK/dV kernel), every bit of a 128 x 128
    score matrix (two tiles each way), against the plain version's."""
    B, H, T, rate, seed = 2, 3, 128, 0.1, 0xABCDEF
    fwd, bwd = narrow_mask_bits(B, H, T, 128, rate, seed)
    keep = keep_mask(seed, B, H, T, T, rate, "cuda")
    assert torch.equal(fwd, keep)
    assert torch.equal(bwd, keep)


@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens", [
    (8, 8, 512, 512, True, None),          # mmtrvpa's memory: l stream
    (8, 8, 200, 200, True, None),          # ... its a and v streams
    (2, 8, 512, 512, True, (512, 0)),      # the classes with kv_lens, one 0
    (2, 8, 512, 512, False, (300, 0)),
    (2, 8, 200, 200, True, (0, 137)),
    (2, 8, 200, 200, False, (0, 200)),
    (2, 3, 77, 130, True, None),           # ragged tiles, band
    (3, 2, 64, 64, False, (64, 0, 5)),     # kv_len 0: zero grads
    (2, 1, 129, 65, False, (65, 1)),       # one visible key
    (2, 2, 130, 40, True, None),           # Tk < 64 < Tq
    (1, 2, 640, 1280, True, None),         # long: ten query tiles
    (2, 2, 200, 1100, True, (1100, 700)),  # long: tk_p = 1152
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_dim_192_kernels_match_plain(gen, B, H, Tq, Tk, masked, lens,
                                          rate):
    """head_dim 192 (mmtrvpa's 2E-wide memory encoders at moviescope's
    widths): the forward (two warpgroups on a 128-query tile) and the
    backward (delta, then the column-split dK/dV and dQ kernels) against
    the plain versions on fused-projection views, at the memory encoders'
    causal classes, at them with kv_lens (one 0: uniform attention, zero
    gradients), causal or not, and at tile edges, and bitwise-equal
    reruns."""
    q, k, v = _fused_views(gen, B, H, Tq, Tk, 192)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = 0x192192 if rate else None
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    assert torch.equal(out, flash_attention(q, k, v, masked, kv, rate,
                                            seed))
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, rate,
                                   seed)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        rate, seed)
    for g, w in zip(got, want):
        _close_grad(g, w)
    if lens is not None and 0 in lens:
        assert not got[0][lens.index(0)].any()
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("seed", [0x1920C0DE, [0x1920C0DE, 0xC0FFEE]])
def test_dropout_mask_is_exact_at_head_dim_192(gen, seed):
    """The forward and backward kernels' dropout masks at head_dim 192
    (two warpgroups over the query rows in the forward, over each tile's
    keys or queries in the backward), every bit of a 200 x 200 score
    matrix (two rounds), against the plain version's; with one seed, and
    with two seed groups (the build for several, one batch row a
    group)."""
    B, H, T, rate = 2, 3, 200, 0.1
    fwd, bwd = narrow_mask_bits(B, H, T, 192, rate, seed)
    keep = keep_mask(seed, B, H, T, T, rate, "cuda")
    assert torch.equal(fwd, keep)
    assert torch.equal(bwd, keep)


def test_head_dim_192_kernels_by_name(gen):
    """The profiler names the forward's own kernel at 192 (two warpgroups
    on a 128-query tile), and the backward's two kernels: the key-split dQ
    kernel with delta, then the row-split dK/dV kernel."""
    q, k, v = _fused_views(gen, 2, 8, 200, 200, 192)
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    for _ in range(3):   # the profiler drops an event now and then: retry
        names = _device_kernels(lambda: flash_attention(q, k, v, True, None))
        if names:
            break
    assert any("flash_fwd_tall_kernel<192" in n for n in names), names
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    for _ in range(3):
        names = _device_kernels(lambda: flash_attention_backward(
            q, k, v, out, lse, dout, True, None))
        if len(names) == 2:
            break
    assert len(names) == 2, names
    for kernel in ("flash_bwd_keysplit_dq_kernel<192",
                   "flash_bwd_rowsplit_dkdv_kernel<192"):
        assert any(kernel in n for n in names), (kernel, names)


# mmtrvpa's 2E-wide memory encoders at the other presets: 600 / 12
# (iemocap), 600 / 10 (cmu-mosei, counseling, cmu-mosi), 1536 / 6 (mmimdb)
MEMORY_DIMS = [(50, 12), (60, 10), (256, 6)]


@pytest.mark.parametrize("D,H", MEMORY_DIMS)
@pytest.mark.parametrize("B,Tq,Tk,masked,lens", [
    (8, 512, 512, True, None),          # the memory encoders' causal class
    (2, 512, 512, True, (512, 0)),      # with kv_lens, one 0
    (2, 200, 200, False, (0, 137)),
    (3, 77, 130, True, None),           # ragged tiles, band
    (2, 130, 40, True, None),           # Tk < 64 < Tq
    (2, 129, 65, False, (65, 1)),       # one visible key
    (1, 640, 1280, True, None),         # long: ten query tiles
    (8, 32, 32, True, None),            # hybrid's 32 x 32: half a tile
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_memory_head_dims_match_plain(gen, D, H, B, Tq, Tk, masked, lens,
                                      rate):
    """head_dim 50, 60 (the D 128 kernels at 64 columns, two panels whose
    columns D..63 are zeros: the forward with the last query tile first and
    S beside the P V before it, the word copies worked out once; in the
    backward dQ with delta, then dK/dV on one warpgroup)
    and 256 (two warpgroups on 128 query rows in the forward; in the
    backward dQ with delta, then dK/dV, the warpgroups splitting each tile
    step's keys or queries) against
    the plain versions, forward and backward, on fused-projection views of
    H heads side by side: O,
    dQ, dK and dV are (B, T, H, D) memory, so a store past column D would
    write into the next head's columns; bitwise-equal reruns."""
    q, k, v = _fused_views(gen, B, H, Tq, Tk, D)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = 0x50602560 if rate else None
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    assert torch.equal(out, flash_attention(q, k, v, masked, kv, rate,
                                            seed))
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, rate,
                                   seed)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        rate, seed)
    for g, w in zip(got, want):
        _close_grad(g, w)
    if lens is not None and 0 in lens:
        assert not got[0][lens.index(0)].any()
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(attention_delta(dout, out),
                               attention_delta_reference(dout, out),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D,H", MEMORY_DIMS)
@pytest.mark.parametrize("B,Tq,Tk,masked,lens", [
    (2, 512, 512, True, None),
    (2, 200, 200, True, (200, 0)),
    (2, 640, 1280, True, None),
    (2, 32, 32, True, None),
])
def test_memory_head_dims_seed_groups_match_plain(gen, D, H, B, Tq, Tk,
                                                  masked, lens):
    """The D 50, 60 and 256 kernels built for several seed groups (two, one
    batch row each) against the plain version, forward and backward, at
    rate 0.1 on fused views of the memory encoders' H heads, and bitwise on
    a rerun."""
    q, k, v = _fused_views(gen, B, H, Tq, Tk, D)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seeds = [0x2560C0DE, 0xC0FFEE]
    out, lse = flash_attention(q, k, v, masked, kv, 0.1, seeds,
                               return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, 0.1,
                                             seeds)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    assert torch.equal(out, flash_attention(q, k, v, masked, kv, 0.1,
                                            seeds))
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    got = flash_attention_backward(q, k, v, out, lse, dout, masked, kv, 0.1,
                                   seeds)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        0.1, seeds)
    for g, w in zip(got, want):
        _close_grad(g, w)
    again = flash_attention_backward(q, k, v, out, lse, dout, masked, kv,
                                     0.1, seeds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", [50, 60, 256])
@pytest.mark.parametrize("seed", [0x5060C0DE, [0x5060C0DE, 0xC0FFEE]])
def test_dropout_mask_is_exact_at_the_memory_head_dims(gen, D, seed):
    """The forward and backward kernels' dropout masks at head_dim 50, 60
    and 256, every bit of a 200 x 200 score matrix, against the plain
    version's; with one seed, and with two seed groups (the build for
    several, one batch row a group)."""
    B, H, T, rate = 2, 3, 200, 0.1
    fwd, bwd = narrow_mask_bits(B, H, T, D, rate, seed)
    keep = keep_mask(seed, B, H, T, T, rate, "cuda")
    assert torch.equal(fwd, keep)
    assert torch.equal(bwd, keep)


@pytest.mark.parametrize("D,H,forward,backward", [
    (50, 12, "flash_fwd_wide_kernel<50, false>",
     ("flash_bwd_wide_dq_kernel<50, false>",
      "flash_bwd_wide_dkdv_kernel<50, false>")),
    (60, 10, "flash_fwd_wide_kernel<60, false>",
     ("flash_bwd_wide_dq_kernel<60, false>",
      "flash_bwd_wide_dkdv_kernel<60, false>")),
    (256, 6, "flash_fwd_tall_kernel<256, false>",
     ("flash_bwd_keysplit_dq_kernel<256, false>",
      "flash_bwd_rowsplit_dkdv_kernel<256, false>")),
])
def test_memory_head_dims_kernels_by_name(gen, D, H, forward, backward):
    """The profiler names the forward's one kernel at head_dim 50, 60 and
    256 (the wide kernel at DP 64 at 50 and 60, the tall one at 256) and
    the backward's two: the dQ kernel with delta, then the dK/dV kernel
    (the wide kernels at DP 64 at 50 and 60, the key- and row-split ones at
    256)."""
    q, k, v = _fused_views(gen, 2, H, 200, 200, D)
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    for _ in range(3):   # the profiler drops an event now and then: retry
        names = _device_kernels(lambda: flash_attention(q, k, v, True, None))
        if len(names) == 1:
            break
    assert len(names) == 1 and forward in names[0], names
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    for _ in range(3):
        names = _device_kernels(lambda: flash_attention_backward(
            q, k, v, out, lse, dout, True, None))
        if len(names) == len(backward):
            break
    assert len(names) == len(backward), names
    for kernel in backward:
        assert any(kernel in n for n in names), (kernel, names)


def test_kernels_fit_the_sm(gen):
    """Every head dim's forward, dK/dV and dQ kernels fit at least one
    block per SM (their shared memory and registers), by the occupancy
    calculator, and the blocks their design counts on (flash_fwd.cu,
    flash_bwd.cu): at the narrow heads the forward 5 (D 25) and 4 (D 30),
    the backward's dK/dV 3 and dQ 4; at 50 and 60 the forward 3 (the wide
    kernel at 64 columns, 41 KB of shared memory, a cap of 168 registers)
    and the backward's dQ and dK/dV 3 each; at 128 the wide forward
    (113 KB of shared memory) and the dQ kernel 2, the 256-thread dK/dV
    kernel 1; at 192 and 256 one 256-thread block of each; a head dim
    below 1 raises."""
    from bpx_torch.ops.flash_attention import KERNEL_HEAD_DIMS, blocks_per_sm
    for d in KERNEL_HEAD_DIMS:
        got = blocks_per_sm(d)
        assert min(got.values()) >= 1
        if d < 32:
            assert got["forward"] >= {25: 5, 30: 4}[d], (d, got)
            assert got["dK/dV"] >= 3 and got["dQ"] >= 4, (d, got)
        if d in (50, 60):
            assert got["forward"] >= 3 and got["dQ"] >= 3, (d, got)
            assert got["dK/dV"] >= 3, (d, got)
        if d == 128:
            assert got["forward"] >= 2 and got["dQ"] >= 2, (d, got)
            assert got["dK/dV"] == 1, (d, got)
        if d in (192, 256):
            assert got == {"forward": 1, "dK/dV": 1, "dQ": 1}, (d, got)
    with pytest.raises(ValueError, match="head_dim"):
        blocks_per_sm(0)


def test_synthetic_tiny_serves_and_trains_on_the_einsum_path(gen):
    """synthetic-tiny (fp32, head_dim 16, attention_impl "xla") is served
    and trained on the card through the einsum attention: no flash launch,
    finite outputs, the LayerNorm kernels launched; its served outputs
    match the plain path's."""
    import numpy as np
    from bpx_torch.config import get_preset
    from bpx_torch.models import get_model
    from bpx_torch.serve import Predictor
    from bpx_torch.train.losses import make_loss_fn
    from bpx_torch.train.optim import make_optimizer
    from bpx_torch.train.steps import make_train_step
    exp = get_preset("synthetic-tiny")
    m, d = exp.model, exp.data
    rng = np.random.RandomState(0)
    n = 4
    mask = (np.arange(m.num_vectors_l)[None, :]
            < np.array([32, 20, 5, 32])[:, None]).astype(np.int32)
    batch = {
        "txt": rng.randint(1, m.bert.vocab_size, (n, m.num_vectors_l))
        .astype(np.int32) * mask,
        "mask": mask,
        "segment": np.zeros((n, m.num_vectors_l), np.int32),
        "video": rng.rand(n, d.video_len, m.orig_d_v).astype(np.float32),
        "audio": rng.rand(n, d.audio_raw_len, m.orig_d_a).astype(np.float32),
        "poster": rng.rand(n, m.orig_d_p).astype(np.float32),
    }
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    ln = layer_norm.launches
    pred = Predictor(exp, batch_size=n, device="cuda")
    probs = pred(batch)
    assert probs.shape == (n, m.n_classes) and np.isfinite(probs).all()
    assert layer_norm.launches > ln
    with plain_versions():
        plain = pred(batch)
    np.testing.assert_allclose(probs, plain, atol=1e-5, rtol=1e-5)

    model = get_model(m, device="cuda", seed=1).train()
    step = make_train_step(model, m.model,
                           make_loss_fn("synthetic", "multilabel", False),
                           make_optimizer(model.parameters(), 1e-3),
                           grad_accum=2,
                           generator=torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v).to("cuda").reshape(2, n // 2, *v.shape[1:])
          for k, v in batch.items()}
    tb["target"] = (torch.rand(2, n // 2, m.n_classes, generator=gen,
                               device="cuda") > 0.5).float()
    loss = step(tb)["loss"].item()
    assert np.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    assert flash_attention.launches == fwd
    assert flash_attention_backward.launches == bwd


def test_flash_autograd_launches_both_kernels(gen):
    """Through autograd on the card: the forward and backward kernels
    launch, and the gradients of strided q/k/v views match the plain path's
    (same inputs, same dropout seed)."""
    B, T, H, D = 2, 100, 4, 96
    base = torch.randn(B, T, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    dout = torch.randn(B, H, T, D, generator=gen, device="cuda").to(
        torch.bfloat16)
    lens = torch.tensor([100, 40], dtype=torch.int32, device="cuda")

    def grads():
        buf = base.clone().requires_grad_(True)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        out = flash_attention(q, k, v, True, lens, 0.1, 7)
        (out.float() * dout.float()).sum().backward()
        return buf.grad

    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    got = grads()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_backward.launches == bwd + 1
    with plain_versions():
        want = grads()
    assert flash_attention_backward.launches == bwd + 1
    for i in range(3):
        _close_grad(got[:, :, i], want[:, :, i])


@pytest.mark.parametrize("n,e", [(5, 768), (33, 300), (16, 1001), (7, 64),
                                 (40, 2048), (4096, 768), (4096, 1536),
                                 (1600, 1536), (1336, 1536), (5, 1536)]
                         + LN_EDGES)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dy_dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_backward_kernel_matches_plain(gen, n, e, x_dtype,
                                                  dy_dtype):
    x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(x_dtype)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    b = torch.randn(e, generator=gen, device="cuda")
    _, mu, rstd = layer_norm(x, w, b, 1e-6, return_stats=True)
    dy = torch.randn(n, e, generator=gen, device="cuda").to(dy_dtype)
    before = layer_norm_backward.launches
    dx, dw, db = layer_norm_backward(x, w, mu, rstd, dy)
    assert layer_norm_backward.launches == before + 1
    rdx, rdw, rdb = layer_norm_backward_reference(x, w, mu, rstd, dy)
    assert dx.dtype == x_dtype and dw.dtype == db.dtype == torch.float32
    tol = 2e-2 if x_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(dx.float(), rdx.float(), atol=tol, rtol=tol)
    for g, r in ((dw, rdw), (db, rdb)):
        torch.testing.assert_close(g, r, atol=1e-4 * r.abs().max().item(),
                                   rtol=1e-4)
    again = layer_norm_backward(x, w, mu, rstd, dy)
    assert all(torch.equal(a, c) for a, c in zip((dx, dw, db), again))


def test_layer_norm_autograd_on_card(gen):
    x0 = torch.randn(4, 50, 768, generator=gen, device="cuda").to(
        torch.bfloat16)
    w0 = torch.rand(768, generator=gen, device="cuda") + 0.5
    b0 = torch.randn(768, generator=gen, device="cuda")
    g = torch.randn(4, 50, 768, generator=gen, device="cuda")

    def grads():
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = layer_norm(x, w, b, 1e-12, torch.bfloat16)
        (y.float() * g).sum().backward()
        return x.grad, w.grad, b.grad

    before = layer_norm_backward.launches
    got = grads()
    assert layer_norm_backward.launches == before + 1
    with plain_versions():
        want = grads()
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    for a, c in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, c, atol=1e-3 * c.abs().max().item(),
                                   rtol=1e-3)


def _offset_view(gen, n, e, dtype, scale=1.0, shift=0.0):
    """An (n, e) tensor whose data starts 2 elements into its buffer: not
    16-byte aligned, so the kernels take their scalar paths."""
    buf = torch.randn(n * e + 2, generator=gen, device="cuda") * scale + shift
    x = buf.to(dtype)[2:].view(n, e)
    assert x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernels_take_misaligned_views(gen, dtype):
    n, e = 133, 768
    x = _offset_view(gen, n, e, dtype, 3.0, 1.0)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    b = torch.randn(e, generator=gen, device="cuda")
    y, mu, rstd = layer_norm(x, w, b, 1e-6, dtype, return_stats=True)
    ry, rmu, rrstd = layer_norm_reference(x, w, b, 1e-6, dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mu, rmu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=1e-5, rtol=1e-5)
    dy = _offset_view(gen, n, e, dtype)
    got = layer_norm_backward(x, w, mu, rstd, dy)
    want = layer_norm_backward_reference(x, w, mu, rstd, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    for g, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, r, atol=1e-4 * r.abs().max().item(),
                                   rtol=1e-4)
    again = layer_norm_backward(x, w, mu, rstd, dy)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _device_kernels(fn):
    """Names of the device activities (kernels, memsets, copies) of one
    call of ``fn``, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile now and then comes back empty: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        if names:
            return names
    return names


@pytest.mark.parametrize("n,e,dtype,aligned,kernel", [
    (1600, 768, torch.bfloat16, True, "ln_bwd_vec_kernel"),
    (4096, 768, torch.bfloat16, True, "ln_bwd_vec_kernel"),
    (133, 300, torch.float32, True, "ln_bwd_vec_kernel"),
    (133, 768, torch.bfloat16, False, "ln_bwd_scalar_kernel"),
    (64, 1032, torch.float32, True, "ln_bwd_vec_kernel<float, float, 6, 2>"),
    (4096, 1536, torch.bfloat16, True, "ln_bwd_vec_kernel<__nv_bfloat16, "
                                       "__nv_bfloat16, 6, 2>"),
    (1600, 1536, torch.bfloat16, True, "ln_bwd_vec_kernel<__nv_bfloat16, "
                                       "__nv_bfloat16, 6, 2>"),
    (133, 1536, torch.bfloat16, False, "ln_bwd_scalar_kernel"),
    (64, 2048, torch.float32, True, "ln_bwd_scalar_kernel"),
])
def test_layer_norm_backward_is_one_kernel(gen, n, e, dtype, aligned,
                                           kernel):
    """One backward call runs exactly one device kernel (the cooperative
    launch: rows, grid barrier, fixed-order reduction of dw and db), no
    memset, and the path the width and alignment select: the vector
    kernel with a warp a row up to 1024 and two warps a row (its last
    template argument) above, up to 1536, the scalar kernel on a
    misaligned view or a wider row."""
    if aligned:
        x = torch.randn(n, e, generator=gen, device="cuda").to(dtype)
        dy = torch.randn(n, e, generator=gen, device="cuda").to(dtype)
    else:
        x, dy = (_offset_view(gen, n, e, dtype) for _ in range(2))
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    b = torch.randn(e, generator=gen, device="cuda")
    _, mu, rstd = layer_norm(x, w, b, 1e-6, return_stats=True)
    names = _device_kernels(lambda: layer_norm_backward(x, w, mu, rstd, dy))
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("n,e,dtype,kernel", [
    (1600, 768, torch.bfloat16, "layer_norm_vec_kernel"),
    (1600, 768, torch.float32, "layer_norm_vec_kernel"),   # fp32 in: vector
    (3, 768, torch.float32, "layer_norm_vec_kernel"),
    (33, 300, torch.bfloat16, "layer_norm_vec_kernel"),
    (33, 1032, torch.bfloat16, "layer_norm_scalar_kernel"),
])
def test_layer_norm_forward_path(gen, n, e, dtype, kernel):
    """The forward is one kernel on the path its width selects: fp32 input
    at E = 768 takes the vector path, as bf16 does."""
    x = torch.randn(n, e, generator=gen, device="cuda").to(dtype)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    b = torch.randn(e, generator=gen, device="cuda")
    names = _device_kernels(lambda: layer_norm(x, w, b, 1e-6,
                                               torch.bfloat16))
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("e", [768, 1536])
def test_layer_norm_backward_phase_stamps(gen, monkeypatch, e):
    """Built with -DBPX_LN_TRACE (as scripts/torch_ln_bwd_phases.py builds
    it), thread 0 of each block of the vector backward (a warp a row at
    768, a warp pair at 1536) stamps the global timer at its start and
    after its rows, its partial rows, the grid barrier and its column
    sums.  Each launch writes every block's stamps, in order; no block
    leaves the barrier before every block has written its partial rows;
    and the traced kernel still matches the plain version."""
    import ctypes
    from bpx_torch.ops import _cuda
    monkeypatch.setattr(_cuda, "CFLAGS", _cuda.CFLAGS + ["-DBPX_LN_TRACE"])
    monkeypatch.setattr(_cuda, "_lib", None)
    lib = _cuda.library()
    lib.bpx_ln_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bpx_ln_trace_read.restype = ctypes.c_int
    n = 1600
    x = (torch.randn(n, e, generator=gen, device="cuda") * 3 + 1).to(
        torch.bfloat16)
    dy = torch.randn(n, e, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.rand(e, generator=gen, device="cuda") + 0.5
    _, mu, rstd = layer_norm(x, w, torch.zeros_like(w), 1e-6,
                             return_stats=True)
    grid = lib.bpx_layer_norm_bwd_workspace(n, e, 1, 1, 1) // (2 * e)
    assert 0 < grid <= n

    def stamps():
        got = layer_norm_backward(x, w, mu, rstd, dy)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (5 * grid))()
        assert lib.bpx_ln_trace_read(ctypes.addressof(buf), grid) == 0
        return got, [tuple(buf[5 * i:5 * i + 5]) for i in range(grid)]

    _, first = stamps()
    got, second = stamps()
    assert min(s[0] for s in second) > max(s[4] for s in first)
    assert all(list(s) == sorted(s) for s in second)
    assert max(s[2] for s in second) <= min(s[3] for s in second)
    want = layer_norm_backward_reference(x, w, mu, rstd, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    for g, r in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, r, atol=1e-4 * r.abs().max().item(),
                                   rtol=1e-4)


@pytest.mark.parametrize("D", [25, 30, 64, 96, 128])
def test_custom_ops_on_card(gen, D):
    """The kernels' custom ops on CUDA tensors: ``opcheck``'s schema and
    fake-impl checks (the fake states the kernels' output strides), and a
    recomputed layer under the ``save_attn`` policy, which must launch the
    flash forward once where full recompute launches it twice."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    from bpx_torch.ops.encoder import resolve_remat_policy
    ops = torch.ops.bpx_torch
    only = ("test_schema", "test_faketensor")
    q, k, v = _qkv(gen, 2, 3, 96, 160, D)
    lens = torch.tensor([160, 33], dtype=torch.int32, device="cuda")
    for args in ((q, k, v, None, True, 0.0, None),
                 (q, k, v, lens, False, 0.1, [9])):
        torch.library.opcheck(ops.flash_fwd.default, args, test_utils=only)
        out, lse = ops.flash_fwd(*args)
        dout = torch.randn_like(out)
        torch.library.opcheck(ops.flash_bwd.default,
                              (q, k, v, out, lse, dout, *args[3:]),
                              test_utils=only)
        if D in (64, 96):
            torch.library.opcheck(ops.flash_delta.default, (dout, out),
                                  test_utils=only)
    x = torch.randn(40, 300, generator=gen, device="cuda").bfloat16()
    w, b = (torch.randn(300, generator=gen, device="cuda") for _ in range(2))
    torch.library.opcheck(ops.layer_norm.default,
                          (x, w, b, 1e-6, torch.bfloat16), test_utils=only)
    _, mu, rstd = ops.layer_norm(x, w, b, 1e-6, torch.bfloat16)
    torch.library.opcheck(ops.layer_norm_bwd.default,
                          (x, w, mu, rstd, torch.randn_like(x)),
                          test_utils=only)

    launched = {}
    for name in (None, "save_attn"):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        policy = resolve_remat_policy(name)
        kw = {} if policy is None else dict(
            context_fn=lambda: create_selective_checkpoint_contexts(policy))
        before = flash_attention.launches
        out = checkpoint(lambda a, c, d: flash_attention(a, c, d, True) * 2,
                         qg, kg, vg, use_reentrant=False, **kw)
        out.float().sum().backward()
        launched[name] = flash_attention.launches - before
    assert launched == {None: 2, "save_attn": 1}


# the multi-seed step's folded launches: S seed groups of B batch rows
SEED_GROUPS = [0x1234567, 0xDEADBEEF, 7, 0xFFFFFFFF, 99]


@pytest.mark.parametrize("D,H", [(25, 12), (30, 10), (64, 12), (96, 8),
                                 (128, 6), (192, 8), (50, 12), (60, 10),
                                 (256, 6)])
@pytest.mark.parametrize("kv", [False, True])
def test_folded_seed_groups_equal_their_own_launches(gen, D, H, kv):
    """One launch over S groups with one seed each: each group's O, lse,
    dQ, dK and dV bitwise equal to a launch over that group alone with its
    seed; one group (a list of one) is the single-seed launch itself."""
    S, B, T = len(SEED_GROUPS), 2, 200
    q, k, v = _qkv(gen, S * B, H, T, T, D)
    dout = torch.randn_like(q)
    lens = (torch.tensor([T, 77] * S, dtype=torch.int32, device="cuda")
            if kv else None)
    out, lse = flash_attention(q, k, v, not kv, lens, 0.1, SEED_GROUPS,
                               return_lse=True)
    grads = flash_attention_backward(q, k, v, out, lse, dout, not kv, lens,
                                     0.1, SEED_GROUPS)
    for s, seed in enumerate(SEED_GROUPS):
        rows = slice(s * B, (s + 1) * B)
        part = lambda t: None if t is None else t[rows]
        o1, l1 = flash_attention(q[rows], k[rows], v[rows], not kv,
                                 part(lens), 0.1, seed, return_lse=True)
        assert torch.equal(out[rows], o1) and torch.equal(lse[rows], l1)
        g1 = flash_attention_backward(q[rows], k[rows], v[rows], o1, l1,
                                      dout[rows], not kv, part(lens), 0.1,
                                      seed)
        assert all(torch.equal(g[rows], w) for g, w in zip(grads, g1))
        o2 = flash_attention(q[rows], k[rows], v[rows], not kv, part(lens),
                             0.1, [seed])
        assert torch.equal(o1, o2)


@pytest.mark.parametrize("D", [25, 64])
def test_vmapped_flash_is_one_launch_without_copies(gen, D):
    """Under vmap the seeds fold into one launch each way, through views
    of the (S, B, T, 3, H, D) projection, equal to the loop over seeds."""
    from torch.func import vmap
    from bpx_torch.ops import flash_attention as fa
    S, B, H, T = len(SEED_GROUPS), 2, 12, 128
    qkv = torch.randn(S, B, T, 3, H, D, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))
    fa.flash_attention.fold_copies = 0
    before = (flash_attention.launches, flash_attention_backward.launches)
    out = vmap(lambda a, b, c: flash_attention(a, b, c, True, None, 0.1,
                                               SEED_GROUPS))(q, k, v)
    dout = torch.randn_like(out)
    (got,) = torch.autograd.grad(out, qkv, dout)
    assert (flash_attention.launches - before[0],
            flash_attention_backward.launches - before[1]) == (1, 1)
    assert fa.flash_attention.fold_copies == 0
    ref = torch.stack([flash_attention(q[s], k[s], v[s], True, None, 0.1,
                                       seed)
                       for s, seed in enumerate(SEED_GROUPS)])
    (want,) = torch.autograd.grad(ref, qkv, dout)
    assert torch.equal(out, ref) and torch.equal(got, want)


def test_twenty_seeds_run_as_chunks_equal_to_their_own_launches(gen):
    """Under vmap, 20 seeds with dropout (more than the kernels' 16 seed
    groups) run as two folded launches each way, of 16 and 4 groups: O,
    lse and the gradients bitwise equal to each seed's own launch, and
    the keep bits of both directions, read off the outputs as
    ``narrow_mask_bits`` reads them, the plain version's for each seed."""
    from torch.func import vmap
    S, B, H, T, D, rate = 20, 2, 3, 128, 25, 0.1
    seeds = [0xC0DE + 7919 * s for s in range(S)]
    bf = torch.bfloat16
    q, k, v = (t.unflatten(0, (S, B)) for t in _qkv(gen, S * B, H, T, T, D))
    lens = torch.tensor([T, 77], dtype=torch.int32, device="cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    call = lambda a, b, c: flash_attention(a, b, c, True, lens, rate, seeds,
                                           return_lse=True)
    before = (flash_attention.launches, flash_attention_backward.launches)
    out, lse = vmap(call)(*leaves)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(bf)
    grads = torch.autograd.grad(out, leaves, dout)
    assert (flash_attention.launches - before[0],
            flash_attention_backward.launches - before[1]) == (2, 2)
    for s, seed in enumerate(seeds):
        o1, l1 = flash_attention(q[s], k[s], v[s], True, lens, rate, seed,
                                 return_lse=True)
        g1 = flash_attention_backward(q[s], k[s], v[s], o1, l1, dout[s],
                                      True, lens, rate, seed)
        assert torch.equal(out[s], o1) and torch.equal(lse[s], l1)
        assert all(torch.equal(g[s], w) for g, w in zip(grads, g1))

    zero = torch.zeros(S, B, H, T, D, device="cuda", dtype=bf)
    fwd = torch.zeros(S, B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    for r in range((T + D - 1) // D):
        c = j - D * r
        sel = (c >= 0) & (c < D)
        onehot = torch.zeros(T, D, device="cuda", dtype=bf)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(S, B, H, T, D).clone().requires_grad_()
        o = vmap(lambda a, b, c_: flash_attention(a, b, c_, False, None, rate,
                                                  seeds))(zero, k, e)
        (dv,) = torch.autograd.grad(o, e, e.detach())
        fwd[..., sel] = o[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    for s, seed in enumerate(seeds):
        keep = keep_mask(seed, B, H, T, T, rate, "cuda")
        assert torch.equal(fwd[s], keep) and torch.equal(bwd[s], keep), s


# ---------------------------------------------------------------------------
# the generic kernels (csrc/flash_generic.cu): bf16 at every head dim the
# tabled kernels do not take, fp32 at every head dim, 1 to 256
# ---------------------------------------------------------------------------

def _generic_qkv(gen, B, H, Tq, Tk, D, dtype):
    """q, k, v as (B, H, T, D) views of fused (B, T, S, H, D) projections
    in ``dtype``, q pre-scaled."""
    qbuf = torch.randn(B, Tq, 1, H, D, generator=gen, device="cuda")
    kvbuf = torch.randn(B, Tk, 2, H, D, generator=gen, device="cuda")
    q = (qbuf[:, :, 0] * D ** -0.5).to(dtype).transpose(1, 2)
    kv = kvbuf.to(dtype)
    return q, kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)


def _generic_tol(dtype):
    """(output tolerance, gradient tolerance relative to the largest
    entry): bf16 as the tabled kernels'; fp32 2e-5, the same function
    summed in another order (no TF32 on either side)."""
    if dtype == torch.float32:
        return dict(atol=2e-5, rtol=2e-5), 2e-5
    return dict(atol=2e-2, rtol=2e-2), 2e-2


# one head dim in each of the generic builds' widths (32, 64, 128, 256) in
# fp32, and its edges (1, 33, 256)
GENERIC_DIMS = [(torch.float32, d) for d in (1, 25, 33, 64, 100, 128, 200,
                                             256)]
# bf16 at one head dim in each panel width (32, 64, 128, 192, 256), its
# edges (1, 33, 65, 129, 193, 255), and odd head dims above 32 (the wide
# and tall kernels' 2-byte loads)
PANEL_DIMS = [(torch.bfloat16, d) for d in (1, 16, 33, 48, 65, 80, 112, 129,
                                            160, 193, 224, 255)]
ROUTE_EDGES = [
    (2, 2, 70, 135, True, (135, 0), 0.1),     # band offset 65, empty row
    (2, 2, 135, 70, True, None, 0.0),         # tall band, ragged tiles
    (1, 2, 100, 1100, True, (1100,), 0.1),    # Tk > 1024: tk_p 1152
]


def _route_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked, lens,
                               rate, route):
    """The forward and backward (dQ with delta, then dK/dV) of ``route``
    against the plain versions on fused views, launched on that route (the
    counters), bitwise on a rerun; a row with no visible key attends
    uniformly and gets zero dQ."""
    from bpx_torch.ops.flash_attention import _launch_bwd, kernel_route
    assert kernel_route(dtype, D) == route
    q, k, v = _generic_qkv(gen, B, H, Tq, Tk, D, dtype)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = 0x6E6E if rate else None
    tol, grad_tol = _generic_tol(dtype)
    counter = f"{route}_launches"
    before = (flash_attention.launches,
              getattr(flash_attention, counter),
              getattr(flash_attention_backward, counter))
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    got = _launch_bwd(q, k, v, dout, lse, out, masked, kv, rate, seed)
    assert (flash_attention.launches, getattr(flash_attention, counter),
            getattr(flash_attention_backward, counter)) == tuple(
                b + 1 for b in before)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, attention_delta_reference(dout, out), masked, kv,
        rate, seed)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= grad_tol, (name, err.item())
    again = _launch_bwd(q, k, v, dout, lse, out, masked, kv, rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(out, flash_attention(q, k, v, masked, kv, rate, seed))
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert not got[0][b].any() and out[b].abs().sum() > 0


@pytest.mark.parametrize("dtype,D", GENERIC_DIMS)
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", ROUTE_EDGES)
def test_generic_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked,
                                     lens, rate):
    """The generic kernels (fp32) as ``_route_kernels_match_plain``."""
    _route_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked, lens,
                               rate, "generic")


@pytest.mark.parametrize("dtype,D", PANEL_DIMS)
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", ROUTE_EDGES)
def test_panel_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked,
                                   lens, rate):
    """The panel builds (bf16 at untabled head dims) as
    ``_route_kernels_match_plain``."""
    _route_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked, lens,
                               rate, "panel")


def _odd_fused_views_uncopied(gen, cases):
    """At each (dtype, odd head dim) of ``cases`` a fused (B, T, 3, H, D)
    projection's views go to the kernels as they are and give what
    contiguous copies give, both ways."""
    from bpx_torch.ops.flash_attention import _kernel_ready, _launch_bwd
    for dtype, D in cases:
        buf = torch.randn(2, 90, 3, 4, D, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        for t in (q, k, v):
            assert _kernel_ready("t", t, t.device) is t
        dense = [t.contiguous() for t in (q, k, v)]
        out, lse = flash_attention(q, k, v, True, return_lse=True)
        assert torch.equal(out, flash_attention(*dense, True))
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        for a, b in zip(_launch_bwd(q, k, v, dout, lse, out, True, None),
                        _launch_bwd(*dense, dout, lse, out, True, None)):
            assert torch.equal(a, b)


def test_generic_route_takes_odd_fused_views_uncopied(gen):
    """At an odd head dim (33) in fp32 (the generic kernels)."""
    _odd_fused_views_uncopied(gen, [(torch.float32, 33)])


def test_panel_route_takes_odd_fused_views_uncopied(gen):
    """At odd head dims of the narrow, wide and tall panel builds (17, 33,
    65, 129, 193: rows at any even byte, the 2-byte loads) and at 34 and 36
    (rows 4- and 8-byte aligned: cp.async words of 4 and 8 bytes) in bf16,
    the words build by the profiler's name."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    cases = [(torch.bfloat16, d) for d in (17, 33, 65, 129, 193, 34, 36)]
    _odd_fused_views_uncopied(gen, cases)
    for _, D in cases:
        buf = torch.randn(2, 90, 3, 4, D, generator=gen, device="cuda").to(
            torch.bfloat16)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        names = _device_kernels(lambda: flash_attention(q, k, v, True))
        assert any(chip_smoke.fwd_kernel(D, 1, torch.bfloat16) in n
                   for n in names), (D, names)


def _generic_mask(q, k, rate, seed, place=None):
    """The keep bits of the forward and of the backward (dV) at q = 0, read
    with one-hot V = dO as chip_smoke.py's ``kernel_mask`` reads them."""
    from bpx_torch.ops.flash_attention import _launch_bwd
    B, H, T, D = q.shape
    fwd = torch.zeros(B, H, T, T, dtype=torch.bool, device="cuda")
    bwd = torch.zeros_like(fwd)
    j = torch.arange(T, device="cuda")
    for r in range((T + D - 1) // D):
        c = j - D * r
        sel = (c >= 0) & (c < D)
        onehot = torch.zeros(T, D, device="cuda", dtype=q.dtype)
        onehot[sel, c[sel]] = 1
        e = onehot.expand(B, H, T, D)
        out, lse = flash_attention(q, k, e, False, None, rate, seed,
                                   return_lse=True, place=place)
        _, _, dv = _launch_bwd(q, k, e, e, lse, out, False, None, rate, seed,
                               place)
        fwd[..., sel] = out[..., c[sel]] != 0
        bwd[..., sel, :] = (dv[..., c[sel]] != 0).transpose(-1, -2)
    return fwd, bwd


MASK_SEEDS = [(0x6E6E0001, None), ([0x6E6E0001, 0xC0FFEE], None),
              (0x6E6E0001, (4, 2, 4))]


@pytest.mark.parametrize("dtype,D", [(torch.float32, 25)])
@pytest.mark.parametrize("seed,place", MASK_SEEDS)
def test_generic_dropout_mask_is_exact(gen, dtype, D, seed, place):
    """The generic kernels' keep bits as ``_dropout_mask_is_exact``."""
    _dropout_mask_is_exact(gen, dtype, D, seed, place)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, d)
                                     for d in (17, 48, 100, 200)])
@pytest.mark.parametrize("seed,place", MASK_SEEDS)
def test_panel_dropout_mask_is_exact(gen, dtype, D, seed, place):
    """The panel builds' keep bits (the narrow, wide and tall kernels'
    hashes) as ``_dropout_mask_is_exact``."""
    _dropout_mask_is_exact(gen, dtype, D, seed, place)


def _dropout_mask_is_exact(gen, dtype, D, seed, place):
    """The kernels' keep bits, both ways, equal ``keep_mask``'s: one seed,
    two seed groups (each group's bits its own), and placed as the (B/2,
    H/2) piece of a data=2 x tensor=2 mesh (the global call's slice)."""
    B, H, T = 4, 2, 100
    q = torch.zeros(B, H, T, D, device="cuda", dtype=dtype)
    k = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dtype)
    fwd, bwd = _generic_mask(q, k, 0.1, seed, place)
    want = keep_mask(seed, B, H, T, T, 0.1, "cuda", place)
    assert torch.equal(fwd, want) and torch.equal(bwd, want)
    if place is not None:
        glob = keep_mask(seed, 2 * B, 2 * H, T, T, 0.1, "cuda")
        assert torch.equal(want, glob[B:, place[1]:place[1] + H])


@pytest.mark.parametrize("D", [25, 30, 50, 60, 64, 96, 128, 192, 256])
def test_tabled_route_keeps_the_tabled_head_dims(gen, D):
    """bf16 at the nine tabled head dims launches the tabled kernels, by
    the profiler's names, both ways; fp32 at the same head dim the
    generic ones."""
    q, k, v = _qkv(gen, 2, 2, 130, 130, D)
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    qf, kf, vf = (t.float() for t in (q, k, v))

    def calls():
        flash_attention(q, k, v, True)
        flash_attention_backward(q, k, v, out, lse, dout, True, None)
        flash_attention(qf, kf, vf, True)
    names = set()
    for _ in range(5):   # the profiler drops events now and then: every
        # profile runs the same calls, so their kernels are the union
        names |= set(_device_kernels(calls))
        tabled = [n for n in names if "generic" not in n]
        generic = [n for n in names if "generic" in n]
        if (any("flash_fwd" in n for n in tabled)
                and any("flash_bwd" in n for n in tabled) and generic):
            break
    assert any("flash_fwd" in n for n in tabled), names
    assert any("flash_bwd" in n for n in tabled), names
    assert all("flash_" in n for n in tabled), names
    assert generic and all("flash_generic_fwd_kernel<float" in n
                           for n in generic), names


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 255)])
def test_generic_delta_matches_plain(gen, dtype, D):
    """``attention_delta`` on the generic route (the standalone op's
    generic kernel) as ``_delta_matches_plain``."""
    _delta_matches_plain(gen, dtype, D, "generic")


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 48),
                                     (torch.bfloat16, 33),
                                     (torch.bfloat16, 255)])
def test_panel_delta_matches_plain(gen, dtype, D):
    """``attention_delta`` on the panel route as ``_delta_matches_plain``."""
    _delta_matches_plain(gen, dtype, D, "panel")


def _delta_matches_plain(gen, dtype, D, route):
    """The standalone delta kernel of ``route`` against its plain version,
    on strided views."""
    out = torch.randn(3, 70, 4, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    dout = torch.randn(3, 70, 4, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    before = getattr(attention_delta, f"{route}_launches")
    got = attention_delta(dout, out)
    assert getattr(attention_delta, f"{route}_launches") == before + 1
    torch.testing.assert_close(got, attention_delta_reference(dout, out),
                               atol=1e-4, rtol=1e-4)


def test_generic_kernels_fit_the_sm(gen):
    """Each generic build (widths 32, 64, 128, 256), fp32, fits at least
    one block an SM: at width 32 and 64 the forward three or more."""
    from bpx_torch.ops.flash_attention import GENERIC_WIDTHS, blocks_per_sm
    for w in GENERIC_WIDTHS:
        got = blocks_per_sm(w - 1, torch.float32)
        assert min(got.values()) >= 1, (w, got)
        if w <= 64:
            assert got["forward"] >= 3, (w, got)


def test_panel_kernels_fit_the_sm(gen):
    """Each panel build (widths 32, 64, 128, 192, 256) holds the forward
    blocks an SM of the tabled kernel of its width (4 / 3 / 2 / 1 / 1: the
    narrow kernel at D 30's, the wide at D 50's and 128's, the tall at
    192's and 256's), and at least one block of each backward kernel."""
    from bpx_torch.ops.flash_attention import PANEL_WIDTHS, blocks_per_sm
    for w, fwd in zip(PANEL_WIDTHS, (4, 3, 2, 1, 1)):
        got = blocks_per_sm(w - 1)
        assert got["forward"] >= fwd and min(got.values()) >= 1, (w, got)


# ---------------------------------------------------------------------------
# the chunked kernels (csrc/flash_chunked.cu): bf16 and fp32 at every head
# dim above 256
# ---------------------------------------------------------------------------

# past the generic builds (257), the paths' head dims (300, 384), and a
# chunk's multiples and their edges up to mmtrvpa's memory width (1536),
# in both dtypes
CHUNKED_DIMS = [(dt, d) for dt in (torch.bfloat16, torch.float32)
                for d in (257, 300, 384, 511, 768, 1536)]


@pytest.mark.parametrize("dtype,D", CHUNKED_DIMS)
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate,groups", [
    (2, 2, 70, 135, True, (135, 0), 0.1, 2),   # band offset 65, empty row
    (2, 1, 135, 70, True, None, 0.0, 1),       # tall band, ragged tiles
    (1, 2, 100, 1100, True, (1100,), 0.1, 1),  # Tk > 1024: tk_p 1152
])
def test_chunked_kernels_match_plain(gen, dtype, D, B, H, Tq, Tk, masked,
                                     lens, rate, groups):
    """The chunked forward and backward (dQ with delta, then dK/dV)
    against the plain versions on fused views, launched on the chunked
    route (the counters), bitwise on a rerun; a row with no visible key
    attends uniformly and gets zero dQ; the standalone delta on its
    chunked kernel."""
    from bpx_torch.ops.flash_attention import _launch_bwd
    q, k, v = _generic_qkv(gen, B, H, Tq, Tk, D, dtype)
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    seed = ([0x6E6E + g for g in range(groups)] if groups > 1 else 0x6E6E) \
        if rate else None
    tol, grad_tol = _generic_tol(dtype)
    counters = lambda: (flash_attention.launches,
                        flash_attention.chunked_launches,
                        flash_attention_backward.chunked_launches,
                        attention_delta.chunked_launches)
    before = counters()
    out, lse = flash_attention(q, k, v, masked, kv, rate, seed,
                               return_lse=True)
    dout = torch.randn(B, Tq, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    got = _launch_bwd(q, k, v, dout, lse, out, masked, kv, rate, seed)
    delta = attention_delta(dout, out)
    assert counters() == tuple(b + 1 for b in before)
    ref, ref_lse = flash_attention_reference(q, k, v, masked, kv, rate, seed)
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    want_delta = attention_delta_reference(dout, out)
    torch.testing.assert_close(delta, want_delta, atol=1e-4, rtol=1e-4)
    want = flash_attention_backward_reference(
        q, k, v, dout, lse, want_delta, masked, kv, rate, seed)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= grad_tol, (name, err.item())
    again = _launch_bwd(q, k, v, dout, lse, out, masked, kv, rate, seed)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(out, flash_attention(q, k, v, masked, kv, rate, seed))
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert not got[0][b].any() and out[b].abs().sum() > 0


@pytest.mark.parametrize("dtype,B,H,D", [(torch.bfloat16, 8, 2, 384),
                                         (torch.float32, 8, 1, 300)])
def test_chunked_kernels_at_the_paths_classes(gen, dtype, B, H, D):
    """The classes of moviescope at 2 heads (bf16, head_dim 384) and of
    iemocap at 1 head in fp32 (300): 512 x 512 causal, rate 0 and 0.1,
    both ways against the plain versions on fused views."""
    from bpx_torch.ops.flash_attention import _launch_bwd
    q, k, v = _generic_qkv(gen, B, H, 512, 512, D, dtype)
    tol, grad_tol = _generic_tol(dtype)
    dout = torch.randn(B, 512, H, D, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    for rate, seed in ((0.0, None), (0.1, 0xACE)):
        out, lse = flash_attention(q, k, v, True, None, rate, seed,
                                   return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, True, None, rate,
                                                 seed)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
        got = _launch_bwd(q, k, v, dout, lse, out, True, None, rate, seed)
        want = flash_attention_backward_reference(
            q, k, v, dout, lse, attention_delta_reference(dout, out), True,
            None, rate, seed)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max() / w.float().abs().max()
            assert err <= grad_tol, (name, rate, err.item())


def test_chunked_route_takes_fused_views_uncopied(gen):
    """At head_dim 300 a fused (B, T, 3, H, D) projection's views go to the
    chunked kernels as they are, in both dtypes, and give what contiguous
    copies give, both ways."""
    from bpx_torch.ops.flash_attention import _kernel_ready, _launch_bwd
    for dtype in (torch.bfloat16, torch.float32):
        buf = torch.randn(2, 90, 3, 2, 300, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (buf[:, :, i].transpose(1, 2) for i in range(3))
        for t in (q, k, v):
            assert _kernel_ready("t", t, t.device) is t
        dense = [t.contiguous() for t in (q, k, v)]
        out, lse = flash_attention(q, k, v, True, return_lse=True)
        assert torch.equal(out, flash_attention(*dense, True))
        dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
        for a, b in zip(_launch_bwd(q, k, v, dout, lse, out, True, None),
                        _launch_bwd(*dense, dout, lse, out, True, None)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 384),
                                     (torch.float32, 300)])
@pytest.mark.parametrize("seed,place", [
    (0x6E6E0001, None), ([0x6E6E0001, 0xC0FFEE], None),
    (0x6E6E0001, (4, 1, 2))])
def test_chunked_dropout_mask_is_exact(gen, dtype, D, seed, place):
    """The chunked kernels' keep bits, both ways, equal ``keep_mask``'s
    (every chunk block of a tile draws the same bits): one seed, two seed
    groups (each group's bits its own), and placed as the (B/2, H/2)
    piece of a data=2 x tensor=2 mesh (the global call's slice)."""
    B, H, T = 4, 1, 100
    q = torch.zeros(B, H, T, D, device="cuda", dtype=dtype)
    k = torch.randn(B, H, T, D, generator=gen, device="cuda").to(dtype)
    fwd, bwd = _generic_mask(q, k, 0.1, seed, place)
    want = keep_mask(seed, B, H, T, T, 0.1, "cuda", place)
    assert torch.equal(fwd, want) and torch.equal(bwd, want)
    if place is not None:
        glob = keep_mask(seed, 2 * B, 2 * H, T, T, 0.1, "cuda")
        assert torch.equal(want, glob[B:, place[1]:place[1] + H])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_kernels_by_name(gen, dtype):
    """A call past head_dim 256 runs the chunked kernels, by the
    profiler's names: the forward, then the dQ and dK/dV kernels, each
    of the one-group build (and of the seed-group build with two
    groups); 256 stays on its own route."""
    name = "float" if dtype == torch.float32 else "__nv_bfloat16"
    q, k, v = _generic_qkv(gen, 2, 2, 130, 130, 384, dtype)
    out, lse = flash_attention(q, k, v, True, None, return_lse=True)
    dout = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    for groups, seed in ((1, None), (2, [1, 2])):
        rate = 0.1 if seed else 0.0
        build = f"<{name}, {'true' if groups > 1 else 'false'}>"
        want = ["flash_chunked_fwd_kernel" + build,
                "flash_chunked_dq_kernel" + build,
                "flash_chunked_dkdv_kernel" + build]
        names = set()
        for _ in range(5):   # the profiler drops events now and then
            names |= set(_device_kernels(lambda: (
                flash_attention(q, k, v, True, None, rate, seed),
                flash_attention_backward(q, k, v, out, lse, dout, True,
                                         None, rate, seed))))
            if all(any(w in n for n in names) for w in want):
                break
        for w in want:
            assert any(w in n for n in names), (w, names)
        assert all("chunked" in n for n in names if "flash" in n), names


def test_chunked_kernels_fit_the_sm(gen):
    """The chunked kernels fit the blocks their design counts on
    (flash_chunked.cu: 128-column tiles), in both dtypes and at any head
    dim above 256: the forward and the dK/dV kernel three an SM, the dQ
    kernel two."""
    from bpx_torch.ops.flash_attention import blocks_per_sm
    for dtype in (torch.bfloat16, torch.float32):
        for d in (257, 1536):
            got = blocks_per_sm(d, dtype)
            assert got["forward"] >= 3 and got["dK/dV"] >= 3, (dtype, got)
            assert got["dQ"] >= 2, (dtype, got)
