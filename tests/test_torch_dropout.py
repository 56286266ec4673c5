"""The port's two dropout hashes against the JAX package's, bit for bit.

* ``bpx_torch.ops.dropout.hash_dropout`` (residual / embedding / hidden
  dropout) against ``bpx.ops.dropout._hash_dropout``: output and backward
  equal, for the same uint32 seed;
* ``bpx_torch.ops.flash_attention.keep_mask`` (the flash kernels' in-kernel
  mask) against ``bpx.ops.pallas_attention._keep_mask`` evaluated outside a
  kernel: equal, including a long key range where ``tk_p != Tk``.

Also the port's seed stream: distinct uint32 seeds per site, the same ones
for the same base.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpx.ops.dropout import _hash_dropout, _hash_keep
from bpx.ops.pallas_attention import _keep_mask

from bpx_torch.ops.dropout import (SeedStream, draw_base_seed, hash_dropout,
                                   hash_keep, maybe_dropout)
from bpx_torch.ops.flash_attention import keep_mask, padded_tk


@pytest.mark.parametrize("shape,rate,seed", [
    ((3, 5, 7), 0.1, 0),
    ((2, 200, 768), 0.25, 0xFFFFFFFF),        # > 2**16 elements, max seed
    ((4, 64, 300), 0.1, 0xFFFFFFFE),
    ((1000,), 0.5, 123456789),
    ((16, 33), 0.999, 42),
])
def test_hash_dropout_matches_bpx_bit_for_bit(shape, rate, seed):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    want_keep = np.asarray(_hash_keep(jnp.uint32(seed), shape, rate))
    assert np.array_equal(hash_keep(seed, shape, rate).numpy(), want_keep)

    want, vjp = jax.vjp(lambda a: _hash_dropout(a, rate, jnp.uint32(seed)),
                        jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = hash_dropout(xt, rate, seed)
    got.backward(torch.from_numpy(g))
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_g))


def test_hash_dropout_bf16_divides_in_bf16():
    """A bf16 stream is divided by bf16(1 - rate), as JAX does with a
    weakly-typed Python scalar."""
    x = np.random.RandomState(1).randn(4, 256).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(_hash_dropout(xb, 0.1, jnp.uint32(9)), np.float32)
    got = hash_dropout(torch.from_numpy(x).to(torch.bfloat16), 0.1, 9)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("B,H,Tq,Tk,rate,seed", [
    (2, 3, 40, 72, 0.1, 1234),
    (1, 2, 64, 1100, 0.3, 0xFFFFFFFF),      # tk_p = 1152 != Tk
    (1, 2, 16, 1280, 0.1, 7),               # long, tk_p = Tk
    (8, 12, 4, 512, 0.5, 99),                # bh up to 95: index wraps
])
def test_flash_keep_mask_matches_bpx(B, H, Tq, Tk, rate, seed):
    tk_p = padded_tk(Tk)
    assert tk_p == (1152 if Tk == 1100 else Tk)
    bh = jnp.arange(B * H, dtype=jnp.int32).reshape(B, H, 1, 1)
    row = jnp.arange(Tq, dtype=jnp.int32).reshape(1, 1, Tq, 1)
    col = jnp.arange(Tk, dtype=jnp.int32).reshape(1, 1, 1, Tk)
    want = np.asarray(_keep_mask(jnp.uint32(seed), bh, row, col, tk_p, rate))
    got = keep_mask(seed, B, H, Tq, Tk, rate).numpy()
    assert np.array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.05


def test_seed_stream_and_base_seed():
    s1, s2 = SeedStream(5), SeedStream(5)
    a = [s1.next() for _ in range(200)]
    assert a == [s2.next() for _ in range(200)]
    assert len(set(a)) == 200 and all(0 <= x < 2 ** 32 for x in a)
    assert a[:5] != [SeedStream(6).next() for _ in range(5)]
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    assert [draw_base_seed(g1) for _ in range(4)] == \
        [draw_base_seed(g2) for _ in range(4)]
    with pytest.raises(ValueError, match="uint32"):
        SeedStream(2 ** 32)
    with pytest.raises(ValueError, match="uint32"):
        hash_dropout(torch.ones(3), 0.1, -1)


def test_maybe_dropout_gates():
    x = torch.ones(10)
    assert maybe_dropout(x, 0.5, False, None) is x
    assert maybe_dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="SeedStream"):
        maybe_dropout(x, 0.5, True, None)
    y = maybe_dropout(x, 0.5, True, SeedStream(1))
    assert set(y.tolist()) <= {0.0, 2.0}
