"""The kernels' vmap rules (the multi-seed step's seed axis) against a
Python loop over the seeds, on the CPU (the ops' plain versions).

* ``bpx_torch::flash_fwd``: O and lse at head dims 25 and 64, rate 0 and
  0.1, with and without ``kv_lens``: the vmapped call (one call over the
  folded S·B batch, one seed per slice) equals slice s's own call with
  seed s, bit for bit; so do the gradients autograd takes through the
  vmapped forward (the multi-seed step's backward), the backward op over
  a folded batch with a seed list, and the keep masks of a folded seed
  list (``keep_mask``).
* ``bpx_torch::layer_norm``: y, mu, rstd per seed (weights per seed), and
  autograd's dx, dw, db through the vmapped call, bit for bit.
* ``hash_dropout``: per-seed masks under ``vmap``, also of an input the
  seeds share, and under ``vmap(grad(...))``.
* ``torch.func.grad`` cannot take the ops (``register_autograd``'s function
  has no ``setup_context``): the reason the multi-seed step takes autograd's
  gradient.  A seed list whose length does not fit raises.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from bpx_torch.ops.dropout import SeedStreams, hash_dropout, hash_keep
from bpx_torch.ops.flash_attention import (flash_attention,
                                           flash_attention_backward,
                                           keep_mask)
from bpx_torch.ops.norm import layer_norm

S, B, H, T = 3, 2, 3, 40
SEEDS = [11, 2 ** 32 - 5, 123456789]
EXACT = dict(rtol=0, atol=0)


def _t(rng, *shape):
    return torch.tensor(rng.randn(*shape), dtype=torch.float32)


def _qkv(D, seed=0):
    """(S, B, H, T, D) q, k, v and dO; q pre-scaled."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (_t(rng, S, B, H, T, D) for _ in range(4))
    return q * D ** -0.5, k, v, do


CASES = [(D, kv, rate) for D in (25, 64) for kv in (False, True)
         for rate in (0.0, 0.1)]


def _kv_lens(kv):
    return torch.tensor([T, 17], dtype=torch.int32) if kv else None


@pytest.mark.parametrize("D,kv,rate", CASES)
def test_flash_forward_vmap_equals_each_seed(D, kv, rate):
    q, k, v, _ = _qkv(D)
    lens = _kv_lens(kv)
    seeds = SEEDS if rate else None
    out, lse = vmap(lambda a, b, c: flash_attention(
        a, b, c, not kv, lens, rate, seeds, return_lse=True))(q, k, v)
    for s in range(S):
        o1, l1 = flash_attention(q[s], k[s], v[s], not kv, lens, rate,
                                 SEEDS[s] if rate else None, return_lse=True)
        torch.testing.assert_close(out[s], o1, **EXACT)
        torch.testing.assert_close(lse[s], l1, **EXACT)


@pytest.mark.parametrize("D,kv,rate", CASES)
def test_flash_backward_seed_groups_equal_each_seed(D, kv, rate):
    """The backward op over the folded S·B batch, one seed a group of B
    rows, as autograd calls it after the vmapped forward."""
    q, k, v, do = (t.flatten(0, 1) for t in _qkv(D, 1))
    lens = None if not kv else _kv_lens(kv).repeat(S)
    seed = lambda s: (SEEDS if s is None else SEEDS[s]) if rate else None
    out, lse = flash_attention(q, k, v, True, lens, rate, seed(None),
                               return_lse=True)
    grads = flash_attention_backward(q, k, v, out, lse, do, True, lens,
                                     rate, seed(None))
    for s in range(S):
        rows = slice(s * B, (s + 1) * B)
        part = [t[rows] for t in (q, k, v, out, lse, do)]
        want = flash_attention_backward(*part, True, _kv_lens(kv), rate,
                                        seed(s))
        for g, w in zip(grads, want):
            torch.testing.assert_close(g[rows], w, **EXACT)


@pytest.mark.parametrize("D,kv,rate", CASES)
def test_autograd_through_the_vmapped_forward_equals_each_seed(D, kv, rate):
    """The multi-seed step's backward: autograd over the folded call."""
    q, k, v, do = _qkv(D, 2)
    lens = _kv_lens(kv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = vmap(lambda a, b, c: flash_attention(
        a, b, c, True, lens, rate, SEEDS if rate else None))(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    for s in range(S):
        one = [t[s].clone().requires_grad_() for t in (q, k, v)]
        o1 = flash_attention(*one, True, lens, rate,
                             SEEDS[s] if rate else None)
        for g, w in zip(got, torch.autograd.grad(o1, one, do[s])):
            torch.testing.assert_close(g[s], w, **EXACT)


@pytest.mark.parametrize("D", [25, 64])
def test_folded_keep_mask_is_each_groups_own(D):
    folded = keep_mask(SEEDS, S * B, H, T, T + 3, 0.1)
    for s, seed in enumerate(SEEDS):
        assert torch.equal(folded[s * B:(s + 1) * B],
                           keep_mask(seed, B, H, T, T + 3, 0.1))
    # one seed is the single-seed path's mask
    assert torch.equal(keep_mask([SEEDS[0]], B, H, T, T, 0.1),
                       keep_mask(SEEDS[0], B, H, T, T, 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_vmap_equals_each_seed(dtype):
    rng = np.random.RandomState(3)
    x = _t(rng, S, 6, 300).to(dtype)
    w, b, dy = _t(rng, S, 300), _t(rng, S, 300), _t(rng, S, 6, 300)
    y, mu, rstd = vmap(lambda a, c, d: layer_norm(
        a, c, d, 1e-6, torch.bfloat16, return_stats=True))(x, w, b)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    y2 = vmap(lambda a, c, d: layer_norm(a, c, d, 1e-6,
                                         torch.bfloat16))(*leaves)
    auto = torch.autograd.grad(y2, leaves, dy.to(torch.bfloat16))
    for s in range(S):
        want = layer_norm(x[s], w[s], b[s], 1e-6, torch.bfloat16,
                          return_stats=True)
        for g, e in zip((y, mu, rstd), want):
            torch.testing.assert_close(g[s], e, **EXACT)
        one = [t[s].clone().requires_grad_() for t in (x, w, b)]
        y1 = layer_norm(*one, 1e-6, torch.bfloat16)
        for g, e in zip(auto, torch.autograd.grad(
                y1, one, dy[s].to(torch.bfloat16))):
            torch.testing.assert_close(g[s], e, **EXACT)


@pytest.mark.parametrize("shared", [False, True])
def test_hash_dropout_vmap_masks_each_seed(shared):
    """Per-seed masks, also where the input is shared by the seeds (the
    stream's axis brings the site under the rule)."""
    rng = np.random.RandomState(4)
    x = _t(rng, 5, 7) if shared else _t(rng, S, 5, 7)
    axis = torch.empty(S, 0)
    leaf = x.clone().requires_grad_()
    y = vmap(lambda a, ax: hash_dropout(a, 0.3, SEEDS, ax),
             in_dims=(None if shared else 0, 0))(leaf, axis)
    dy = _t(rng, S, 5, 7)
    (got,) = torch.autograd.grad(y, leaf, dy)
    for s, seed in enumerate(SEEDS):
        keep = hash_keep(seed, (5, 7), 0.3)
        xs = x if shared else x[s]
        torch.testing.assert_close(y[s], hash_dropout(xs, 0.3, seed),
                                   **EXACT)
        assert torch.equal(y[s] != 0, keep & (xs != 0))
        if not shared:
            torch.testing.assert_close(got[s], hash_dropout(dy[s], 0.3,
                                                            seed), **EXACT)
    if shared:
        want = sum(hash_dropout(dy[s], 0.3, seed)
                   for s, seed in enumerate(SEEDS))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_hash_dropout_under_vmap_of_grad():
    rng = np.random.RandomState(5)
    x = _t(rng, S, 4, 6)
    f = lambda a, ax: (hash_dropout(a, 0.25, SEEDS, ax) ** 2).sum()
    got = vmap(grad(f))(x, torch.empty(S, 0))
    for s, seed in enumerate(SEEDS):
        want = grad(lambda a: (hash_dropout(a, 0.25, seed) ** 2).sum())(x[s])
        torch.testing.assert_close(got[s], want, **EXACT)


def test_seed_streams_are_each_seeds_own_stream():
    from bpx_torch.ops.dropout import SeedStream
    streams = SeedStreams(SEEDS)
    singles = [SeedStream(b) for b in SEEDS]
    for _ in range(5):
        assert streams.next() == [s.next() for s in singles]


def test_torch_func_grad_cannot_take_the_ops():
    q, k, v, _ = _qkv(25)
    with pytest.raises(RuntimeError, match="setup_context"):
        grad(lambda a: flash_attention(a, k[0], v[0]).sum())(q[0])
    x, w = torch.randn(4, 8), torch.ones(8)
    with pytest.raises(RuntimeError, match="setup_context"):
        grad(lambda c: layer_norm(x, c, torch.zeros(8), 1e-6).sum())(w)


def test_seed_lists_that_do_not_fit_raise():
    q, k, v, _ = _qkv(25)
    with pytest.raises(ValueError, match="vmapped axis"):
        vmap(lambda a, b, c: flash_attention(a, b, c, True, None, 0.1,
                                             SEEDS[:2]))(q, k, v)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q[0], k[0], v[0], True, None, 0.1, SEEDS)
    with pytest.raises(ValueError, match="vmap"):
        hash_dropout(torch.ones(S, 2), 0.1, SEEDS)
    with pytest.raises(ValueError, match="vmapped axis"):
        vmap(lambda a: hash_dropout(a, 0.1, SEEDS[:2]))(torch.ones(S, 2))
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q[0], k[0], v[0], True, None, 0.1, [1, 2 ** 32])


def test_the_kernels_seed_limit_raises_before_a_launch():
    from bpx_torch.ops.flash_attention import MAX_SEED_GROUPS, _dropout_args
    on, seeds, n = _dropout_args(0.1, list(range(MAX_SEED_GROUPS)), 64,
                                 MAX_SEED_GROUPS)[:3]
    assert (on, n, list(seeds)) == (1, MAX_SEED_GROUPS,
                                    list(range(MAX_SEED_GROUPS)))
    with pytest.raises(ValueError, match="seed groups"):
        _dropout_args(0.1, list(range(MAX_SEED_GROUPS + 1)), 64,
                      MAX_SEED_GROUPS + 1)
    with pytest.raises(ValueError, match="seed groups"):
        _dropout_args(0.1, [1, 2, 3], 64, 8)
