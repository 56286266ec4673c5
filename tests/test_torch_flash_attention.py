"""The port's flash attention (plain versions, CPU) against the JAX
package's Pallas kernels in interpret mode: outputs and log-sum-exp, and
with dropout the forward and its ``jax.vjp`` (the fused single-pass
backward at the model's shapes; the online forward and the split dQ / dK-dV
backward at a long multi-tile shape; lengths and band offsets at the edges
of the CUDA kernels' 64-row tiles; both of bpx's delta paths; the narrow
head dims 25 and 30 of the mmtrvat presets, mmimdb's 128, and 192, 50, 60
and 256, the head dims of mmtrvpa's memory encoders at moviescope's,
iemocap's, cmu-mosei's (counseling's, cmu-mosi's) and mmimdb's widths).

Inputs are made with numpy from a seed; fp32, atol/rtol 2e-5 (the same
function, sums in another order).  The dropout seeds are the same uint32 on
both sides.  On the card, chip_smoke.py holds the CUDA kernels against these
plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bpx.ops.pallas_attention import _fwd as pallas_fwd
from bpx.ops.pallas_attention import flash_attention as pallas_flash

from bpx_torch.ops.flash_attention import (effective_band, flash_attention,
                                           flash_attention_reference)
from bpx_torch.ops.dispatch import plain_versions
from tests.test_torch_loop import few_threads  # noqa: F401

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
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=2 ** 32)
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention(q, k, v, dropout_rate=1.0, dropout_seed=1)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, k[:, :, :8], v)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attention(q, k, v, kv_lens=torch.ones(3, dtype=torch.int32))


def _bpx_fwd_vjp(q, k, v, dout, masked, lens, rate, seed):
    """bpx's Pallas flash (interpret mode) and its custom_vjp backward."""
    def f(q, k, v):
        kv = None if lens is None else jnp.asarray(lens)
        return pallas_flash(q, k, v, masked=masked, kv_lens=kv,
                            dropout_rate=rate,
                            dropout_seed=jnp.uint32(seed) if rate else None,
                            layout="bhtd", out_layout="bhtd")
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in
                                      vjp(jnp.asarray(dout)))


def _port_fwd_bwd(q, k, v, dout, masked, lens, rate, seed):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qt, kt, vt, masked,
                          None if lens is None else torch.from_numpy(lens),
                          rate, seed if rate else None)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), \
        vt.grad.numpy()


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens,rate", [
    (1, 2, 128, 256, 64, True, None, 0.1),          # band, offset 128
    (2, 2, 160, 64, 96, True, None, 0.1),           # band dropped
    (2, 2, 200, 200, 96, True, None, 0.0),          # causal, rate 0
    (4, 1, 128, 128, 64, False, (128, 37, 1, 0), 0.1),  # kv_len 0 row
    (2, 2, 200, 120, 96, True, (120, 50), 0.25),    # band + key padding
])
def test_flash_forward_backward_with_dropout_match_pallas(B, H, Tq, Tk, D,
                                                          masked, lens, rate):
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=2)
    dout = np.random.RandomState(3).randn(B, H, Tq, D).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    seed = 0xFFFFFFF7
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, seed)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, seed)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    if lens is not None and 0 in lens:
        b = lens.index(0)
        assert not got[1][b].any()      # contract: no visible key, dq = 0
        assert got[0][b].any()          # while the forward attended


@pytest.mark.parametrize("B,H,Tq,Tk,D,masked,lens,rate", [
    (1, 2, 63, 65, 64, True, None, 0.0),            # band offset 2
    (1, 2, 65, 63, 96, True, None, 0.1),            # tall band, offset 2
    (2, 1, 65, 129, 96, True, (129, 64), 0.25),     # offset one tile
    (2, 1, 129, 200, 64, True, (200, 130), 0.1),    # offset 71
    (1, 2, 200, 129, 96, True, None, 0.0),          # offset 71, tall band
    (2, 1, 63, 200, 64, True, (200, 65), 0.1),      # offset 137
    (1, 2, 200, 63, 96, True, None, 0.1),           # band dropped
    (2, 1, 129, 65, 64, False, (65, 1), 0.0),       # one visible key
    (2, 1, 200, 200, 96, False, (200, 63), 0.1),    # kv_len one short
])
def test_flash_tile_edges_match_pallas(B, H, Tq, Tk, D, masked, lens, rate):
    """Lengths on either side of the kernels' 64-row tiles (63, 65, 129,
    200) and band offsets that cross a tile edge, D 64 and 96, with and
    without kv_lens and dropout: the forward and backward against bpx."""
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=6)
    dout = np.random.RandomState(7).randn(B, H, Tq, D).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0x1234567)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0x1234567)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("D", [25, 30, 50, 60])
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", [
    (1, 2, 512, 512, True, None, 0.0),          # the mmtrvat class: causal
    (1, 2, 512, 512, True, None, 0.1),          # with attention dropout
    (2, 1, 63, 65, True, (65, 30), 0.1),        # band offset 2, kv_lens
    (2, 1, 65, 129, True, (129, 64), 0.0),      # offset 64, kv_len a tile
    (2, 1, 129, 129, False, (129, 1), 0.1),     # one visible key
    (2, 1, 129, 63, True, (63, 40), 0.0),       # band dropped
])
def test_narrow_head_dims_match_pallas(D, B, H, Tq, Tk, masked, lens, rate):
    """head_dim 25 (iemocap: 300 / 12) and 30 (cmu-mosei, counseling,
    cmu-mosi: 300 / 10), and the memory encoders' 50 and 60 (600 / 12, 600
    / 10), which the Pallas kernels take at their raw width: the forward
    and backward against bpx at the model's 512 x 512 causal class and at
    tile edges with kv_lens, rate 0 and 0.1."""
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=12)
    dout = np.random.RandomState(13).randn(B, H, Tq, D).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0xBADC0DE)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0xBADC0DE)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", [
    (1, 2, 512, 512, True, None, 0.0),          # the mmimdb class: causal
    (1, 2, 512, 512, True, None, 0.1),          # with attention dropout
    (2, 1, 63, 65, True, (65, 30), 0.1),        # band offset 2, kv_lens
    (2, 1, 129, 200, True, (200, 130), 0.1),    # offset 71, kv_lens
    (2, 1, 129, 65, False, (65, 1), 0.0),       # one visible key
])
def test_head_dim_128_matches_pallas(B, H, Tq, Tk, masked, lens, rate):
    """head_dim 128 (mmimdb: 768 / 6), the kernels' widest: the forward
    and backward against bpx at the model's 512 x 512 causal class, rate 0
    and 0.1, and at tile edges with kv_lens.  The absolute tolerance is
    2e-5 of each tensor's largest entry (at least 2e-5): with a single
    visible key dP - delta cancels, dK's true value is 0, and both sides
    hold fp32 noise that grows with the 128-term sums."""
    q, k, v = _inputs(B, H, Tq, Tk, 128, seed=14)
    dout = np.random.RandomState(15).randn(B, H, Tq, 128).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0x600DCAFE)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0x600DCAFE)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", [
    (1, 1, 512, 512, True, None, 0.0),          # mmtrvpa's memory: causal
    (1, 1, 512, 512, True, None, 0.1),          # with attention dropout
    (2, 1, 200, 200, True, None, 0.1),          # its 200 x 200 class
    (2, 1, 63, 65, True, (65, 30), 0.1),        # band offset 2, kv_lens
    (2, 1, 129, 65, False, (65, 1), 0.0),       # one visible key
    (2, 1, 130, 130, False, (130, 0), 0.0),     # kv_len 0: uniform rows
    (2, 1, 65, 65, True, (0, 40), 0.1),         # ... under the band
    (1, 1, 200, 512, True, None, 0.1),          # Tq 200 against Tk 512
])
def test_head_dim_192_matches_pallas(B, H, Tq, Tk, masked, lens, rate):
    """head_dim 192 (mmtrvpa's 2E-wide memory encoders at moviescope's
    widths: 1536 / 8): the forward and backward against bpx at the
    memory encoders' 512 x 512 and 200 x 200 causal classes, rate 0 and
    0.1, at tile edges with kv_lens, at a kv_len of 0 (every key masked:
    the row attends uniformly over all Tk keys), and at 200 queries against
    512 keys; the tolerance of ``test_head_dim_128_matches_pallas``."""
    q, k, v = _inputs(B, H, Tq, Tk, 192, seed=16)
    dout = np.random.RandomState(17).randn(B, H, Tq, 192).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0x5EEDF00D)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0x5EEDF00D)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("D", [50, 60, 256])
@pytest.mark.parametrize("B,H,Tq,Tk,masked,lens,rate", [
    (2, 2, 130, 130, True, None, 0.0),          # causal, as the memory's
    (2, 2, 130, 130, True, None, 0.1),          # with attention dropout
    (2, 2, 63, 65, True, (65, 30), 0.1),        # band offset 2, kv_lens
    (2, 2, 129, 65, False, (65, 1), 0.0),       # one visible key
    (2, 2, 65, 65, True, (0, 40), 0.1),         # kv_len 0 under the band
    (2, 2, 130, 40, True, None, 0.1),           # Tk < 64 < Tq
    (1, 2, 200, 512, True, None, 0.1),          # Tq 200 against Tk 512
])
def test_memory_head_dims_match_pallas(D, B, H, Tq, Tk, masked, lens, rate):
    """head_dim 50, 60 and 256 (mmtrvpa's 2E-wide memory encoders at
    iemocap's, at cmu-mosei's, counseling's and cmu-mosi's, and at mmimdb's
    widths) over two heads of distinct values: the forward and backward
    against bpx, causal at rate 0 and 0.1, at tile edges with kv_lens (one
    0), with fewer keys than a tile against three query tiles (the dQ
    kernel's last query tile first, the dK/dV kernel's split rows), and at
    200 queries against 512 keys; the tolerance of
    ``test_head_dim_128_matches_pallas``."""
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=18)
    dout = np.random.RandomState(19).randn(B, H, Tq, D).astype(np.float32)
    kv = None if lens is None else np.asarray(lens, np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, masked, kv, rate, 0x50602560)
    got = _port_fwd_bwd(q, k, v, dout, masked, kv, rate, 0x50602560)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        atol = TOL["atol"] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=TOL["rtol"], atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("xla_delta", ["0", "1"])
def test_backward_matches_both_delta_paths_of_bpx(monkeypatch, xla_delta):
    """delta = rowsum(dO * O) computed with the backward (the port) against
    bpx computing it inside its kernels (BPX_XLA_DELTA=0) and in XLA
    before them (=1)."""
    monkeypatch.setenv("BPX_XLA_DELTA", xla_delta)
    q, k, v = _inputs(2, 2, 129, 200, 96, seed=8)
    dout = np.random.RandomState(9).randn(2, 2, 129, 96).astype(np.float32)
    kv = np.asarray([200, 77], np.int32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, kv, 0.1, 99)
    got = _port_fwd_bwd(q, k, v, dout, True, kv, 0.1, 99)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_attention_delta_on_cpu_is_the_plain_row_sum():
    """The CPU path of the backward's delta: fp32 rowsum(dO * O), the same
    as a float64 sum to fp32 rounding, for fp32 and bf16 inputs."""
    from bpx_torch.ops.flash_attention import (attention_delta,
                                               attention_delta_reference)
    rng = np.random.RandomState(10)
    dout, out = (rng.randn(2, 3, 65, 96).astype(np.float32) for _ in range(2))
    want = (dout.astype(np.float64) * out).sum(-1)
    got = attention_delta(torch.from_numpy(dout), torch.from_numpy(out))
    assert got.shape == (2, 3, 65) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (dout, out)]
    assert torch.equal(attention_delta(*bf), attention_delta_reference(*bf))
    assert torch.equal(attention_delta_reference(*bf),
                       (bf[0].float() * bf[1].float()).sum(-1))


def test_long_shape_online_forward_and_split_backward_match_pallas():
    """B*H = 2, Tq = 640, Tk = 1280: bpx takes its online forward (Tk >
    1024) and the split dQ / dK-dV backward (Tq > 512), masked and with
    dropout; the port's plain versions compute the same function."""
    B, H, Tq, Tk, D = 1, 2, 640, 1280, 64
    q, k, v = _inputs(B, H, Tq, Tk, D, seed=4)
    dout = np.random.RandomState(5).randn(B, H, Tq, D).astype(np.float32)
    want = _bpx_fwd_vjp(q, k, v, dout, True, None, 0.1, 31337)
    got = _port_fwd_bwd(q, k, v, dout, True, None, 0.1, 31337)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_autograd_and_plain_context_on_cpu():
    """The CPU path through autograd is the plain backward, and nothing
    launches; under no autograd the forward returns no graph."""
    from bpx_torch.ops.flash_attention import flash_attention_backward
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 24, 64))
    flash_attention_backward.launches = 0
    qg = q.clone().requires_grad_(True)
    with plain_versions():
        out = flash_attention(qg, k, v, True, None, 0.1, 5)
    assert out.grad_fn is not None
    out.sum().backward()
    assert qg.grad is not None and flash_attention_backward.launches == 0
    with torch.no_grad():
        assert flash_attention(qg, k, v).grad_fn is None
