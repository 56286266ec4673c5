"""Recompute under the port's vmapped multi-seed step, and more seeds than
the flash kernels take in one launch.

* Against the JAX package's ``make_multi_seed_train_step`` with ``remat``
  (full recompute, and ``remat_policy="save_attn"``): ``synthetic-tiny`` at
  depth 1, ``attention_impl="xla"``, every dropout rate 0, SGD, two seeds,
  bpx's stacked initial weights carried over; losses and parameters after
  one step within atol 1e-5 (``tests/test_torch_multiseed.py``'s limits).
* With every dropout on, at ``attention_impl="pallas"`` (the flash op's
  vmap rule, its plain version on the CPU): each seed of the recomputed
  vmapped step against the port's single-seed step with the same
  recompute, and the recomputed vmapped step against the vmapped step
  without recompute, within 2e-6 of each tensor's largest entry; the
  flash calls of a recomputed step are the single-seed step's.
* Twenty seeds through the flash op's vmap rule with dropout: the calls
  come in chunks of at most ``MAX_SEED_GROUPS`` seed groups, each chunk's
  keep masks are each seed's own, and O, lse and the gradients equal
  twenty single-seed calls, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import vmap

from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train import multiseed as jmultiseed

from bpx_torch.interop import stacked_params_from_flax
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.ops.encoder import recomputed
from bpx_torch.ops.flash_attention import (MAX_SEED_GROUPS, flash_attention,
                                           keep_mask)
from bpx_torch.models import get_model
from bpx_torch.train.multiseed import (init_multi_seed,
                                       make_multi_seed_train_step)
from bpx_torch.train.optim import make_optimizer
from tests.test_torch_multiseed import loss_fn, single_step, tiny, torch_batch

POLICIES = [None, "save_attn"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def recompute(exp, policy):
    """``exp`` (a port or a bpx experiment) with ``remat`` and ``policy``."""
    return exp.replace(model=exp.model.replace(remat=True,
                                               remat_policy=policy))


@pytest.mark.parametrize("policy", POLICIES)
def test_recomputed_multiseed_step_matches_bpx(policy):
    jexp, exp = (recompute(e, policy) for e in tiny(dropout=False))
    seeds = [3, 9]
    batch = torch_batch(exp)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jmodel = jget_model(jexp.model)
    tx = optax.sgd(1e-3)
    jstates = jmultiseed.init_multi_seed(jmodel, jexp.model.model, jbatch, tx,
                                         seeds)
    jstep = jax.jit(jmultiseed.make_multi_seed_train_step(
        jmodel, jexp.model.model,
        jlosses.make_loss_fn(jexp.data.task, jexp.data.task_type, False),
        tx))
    rngs = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    jnew, jmetrics = jstep(jstates, jbatch, rngs)

    state = init_multi_seed(exp.model, seeds,
                            lambda ps: torch.optim.SGD(ps, lr=1e-3),
                            device="cpu")
    carried = stacked_params_from_flax(
        jax.tree.map(np.asarray, jstates.params), exp.model)
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(carried[k])
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(batch)
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jmetrics["loss"]), atol=1e-5)
    want = stacked_params_from_flax(jax.tree.map(np.asarray, jnew.params),
                                    exp.model)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, err_msg=k)


SEEDS = [3, 9, 27]


def vmapped_step(exp, initial, calls):
    """One vmapped Adam step of ``exp`` from the seeds' ``initial`` state
    dicts: (metrics, stacked gradients, flash calls)."""
    state = init_multi_seed(exp.model, SEEDS,
                            lambda ps: make_optimizer(ps, 1e-3),
                            device="cpu")
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(torch.stack([sd[k] for sd in initial]))
    calls.clear()
    metrics = make_multi_seed_train_step(state, loss_fn(exp))(
        torch_batch(exp))
    return metrics, {k: p.grad for k, p in state.params.items()}, len(calls)


@pytest.fixture(scope="module")
def dropout_runs():
    """The vmapped step with every dropout on, at attention_impl "pallas",
    without recompute and with each policy, from the same weights; the
    flash calls of each."""
    _, exp = tiny(dropout=True, attention_impl="pallas")
    calls = []
    forward = tflash._forward

    def spy(*a, **kw):
        calls.append(a)
        return forward(*a, **kw)

    tflash._forward = spy
    try:
        initial = [get_model(exp.model, device="cpu", seed=s).state_dict()
                   for s in SEEDS]
        runs = {key: vmapped_step(recompute(exp, key[1]) if key[0] else exp,
                                  initial, calls)
                for key in [(False, None)] + [(True, p) for p in POLICIES]}
        single = {}
        for policy in POLICIES:
            rexp = recompute(exp, policy)
            calls.clear()
            single[policy] = [single_step(rexp, initial[i], seed)
                              for i, seed in enumerate(SEEDS)]
            single[policy].append(len(calls) // len(SEEDS))
    finally:
        tflash._forward = forward
    return exp, runs, single


def close(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() <= 2e-6 * max(scale, 1e-6)


@pytest.mark.parametrize("policy", POLICIES)
def test_each_recomputed_seed_is_its_own_single_seed_step(dropout_runs,
                                                          policy):
    _, runs, single = dropout_runs
    metrics, grads, n_calls = runs[(True, policy)]
    assert len(set(metrics["loss"].tolist())) == len(SEEDS)
    for i, seed in enumerate(SEEDS):
        model, _, one = single[policy][i]
        torch.testing.assert_close(metrics["loss"][i], one["loss"],
                                   rtol=0, atol=2e-6)
        for name, p in model.named_parameters():
            assert close(grads[name][i], p.grad), (policy, seed, name)
    # the folded calls are the single-seed step's, replays included
    assert n_calls == single[policy][-1]


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_keeps_the_vmapped_step(dropout_runs, policy):
    exp, runs, _ = dropout_runs
    metrics, grads, n_calls = runs[(True, policy)]
    base, base_grads, base_calls = runs[(False, None)]
    torch.testing.assert_close(metrics["loss"], base["loss"], rtol=0,
                               atol=2e-6)
    for name, g in grads.items():
        for i in range(len(SEEDS)):
            assert close(g[i], base_grads[name][i]), (policy, name)
    # full recompute replays every flash call; save_attn keeps the
    # encoders' (BERT's layers recompute in full: remat_policy_bert None)
    assert n_calls == (2 * base_calls if policy is None
                       else base_calls + exp.model.bert.num_layers)


class _Layer(torch.nn.Linear):
    def forward(self, x, seeds):
        return super().forward(x)


class _Stack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.layer = _Layer(4, 4)

    def forward(self, x):
        return recomputed(self.layer, None, None, x)


def test_recompute_needs_the_stacked_weights():
    """A layer under the seed vmap whose weights are only partly the
    stacked tensors (the bias left as the template's) raises."""
    stack = _Stack()
    with pytest.raises(RuntimeError, match="stacked weights"):
        vmap(lambda w: torch.func.functional_call(
            stack, {"layer.weight": w}, (torch.ones(3, 4),)))(
            torch.randn(2, 4, 4))


# ---------------------------------------------------------------------------
# more seeds than one launch takes
# ---------------------------------------------------------------------------

def test_twenty_seeds_run_in_chunks_of_each_seeds_own_calls(monkeypatch):
    S, B, H, Tq, Tk, D, rate = 20, 2, 3, 24, 40, 25, 0.1
    rng = np.random.RandomState(0)
    t = lambda *shape: torch.tensor(rng.randn(*shape), dtype=torch.float32)
    q, k, v, do = (t(S, B, H, T, D) for T in (Tq, Tk, Tk, Tq))
    q = q * D ** -0.5
    lens = torch.tensor([Tk, 17], dtype=torch.int32)
    seeds = [int(s) for s in rng.randint(0, 2 ** 32, S, dtype=np.uint64)]
    chunks = []
    forward = tflash._forward

    def spy(q, k, v, masked, kv_lens, rate, seed, place=None):
        chunks.append((q.shape[0], list(seed)))
        return forward(q, k, v, masked, kv_lens, rate, seed, place)

    monkeypatch.setattr(tflash, "_forward", spy)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = vmap(lambda a, b, c: flash_attention(
        a, b, c, True, lens, rate, seeds, return_lse=True))(*leaves)
    (out * do).sum().backward()
    assert [len(s) for _, s in chunks] == [MAX_SEED_GROUPS,
                                           S - MAX_SEED_GROUPS]
    assert [s for _, s in chunks] == [seeds[:MAX_SEED_GROUPS],
                                      seeds[MAX_SEED_GROUPS:]]
    for rows, group in chunks:
        mask = keep_mask(group, rows, H, Tq, Tk, rate)
        for g, seed in enumerate(group):
            assert torch.equal(mask[g * B:(g + 1) * B],
                               keep_mask(seed, B, H, Tq, Tk, rate))
    chunks.clear()
    for s in range(S):
        one = [x[s].clone().requires_grad_() for x in (q, k, v)]
        o, l = flash_attention(*one, True, lens, rate, seeds[s],
                               return_lse=True)
        (o * do[s]).sum().backward()
        assert torch.equal(o, out[s]) and torch.equal(l, lse[s]), s
        for a, b in zip(one, leaves):
            assert torch.equal(a.grad, b.grad[s]), s
    assert len(chunks) == S
