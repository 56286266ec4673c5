"""The port's RAdam and bf16 gradient accumulation against the JAX
package's (``bpx/train/radam.py``, ``bpx/train/steps.py``).

fp32 on the CPU.  RAdam: the same gradients through ``bpx``'s optax
transformation and the port's optimizer for 8 steps, so the run crosses
step 5, where the rectified (adaptive) step starts, with the learning rate
changed in between; rtol 1e-6.  bf16 accumulation: the gradient the
optimizer receives is ``fp32(bf16(bf16(g1) + bf16(g2))) * 1/2`` bit for
bit, and one accumulation step's update matches bpx's within the lockstep
tolerances of ``tests/test_torch_train.py`` (1e-3 relative, plus 1e-3 of
each tensor's largest entry and 1e-5 of the largest anywhere).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bpx.models import get_model as jget_model
from bpx.train import losses as jlosses
from bpx.train import optim as joptim
from bpx.train.state import TrainState
from bpx.train.steps import make_train_step as jmake_train_step
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.config import config_from_dict
from bpx_torch.inputs import model_inputs
from bpx_torch.interop import params_from_flax
from bpx_torch.models import get_model
from bpx_torch.train import losses, optim
from bpx_torch.train.radam import RAdam, step_coefficients
from bpx_torch.train.steps import make_train_step
from bpx_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_model import _tiny_experiment
from tests.test_torch_train import A, FREQS, LR, _no_dropout, _super_batch
from tests.test_torch_loop import few_threads  # noqa: F401

STEPS = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed=1):
    """Two parameters and STEPS gradients for each, from a numpy seed."""
    rng = np.random.RandomState(seed)
    p0 = [rng.randn(7, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in p0]
             for _ in range(STEPS)]
    return p0, grads


@pytest.mark.parametrize("name", ["radam", "plain_radam"])
def test_radam_matches_bpx_across_step_5(name):
    p0, grads = _problem()
    tx = joptim.make_optimizer(LR, name)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    params = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = optim.make_optimizer(params, LR, name)
    assert isinstance(opt, RAdam)
    update = jax.jit(tx.update)
    for i, g in enumerate(grads):
        if i == 6:       # the plateau scheduler's rewrite, on both sides
            state.hyperparams["learning_rate"] = jnp.asarray(LR / 2,
                                                             jnp.float32)
            optim.set_lr(opt, LR / 2)
        upd, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = _t(x)
        opt.step()
        for p, want in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i + 1}")
    assert optim.get_current_lr(opt) == LR / 2
    moments = state.inner_state[0]
    assert opt.param_groups[0]["step"] == STEPS == int(moments.count)
    for i, p in enumerate(params):
        s = opt.state[p]
        np.testing.assert_allclose(s["exp_avg"].numpy(),
                                   np.asarray(moments.mu[i]), rtol=1e-6)
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                   np.asarray(moments.nu[i]), rtol=1e-6)


def test_adaptive_step_starts_at_step_5_unlike_torch_radam():
    """n_sma is 4.996 at step 5 (beta2 0.999): bpx's rule (n_sma > 4)
    takes the rectified step there, torch.optim.RAdam's (rho_t > 5) takes
    the momentum step; both take the momentum step before."""
    assert [step_coefficients(t, 0.9, 0.999)[3] for t in range(1, 7)] == \
        [False] * 4 + [True] * 2
    p0, grads = _problem(2)
    ours = [torch.nn.Parameter(_t(p)) for p in p0]
    theirs = [torch.nn.Parameter(_t(p)) for p in p0]
    opt_a = RAdam(ours, lr=LR)
    opt_b = torch.optim.RAdam(theirs, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    for i, g in enumerate(grads[:5]):
        for a, b, x in zip(ours, theirs, g):
            a.grad, b.grad = _t(x), _t(x)
        opt_a.step()
        opt_b.step()
        same = all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
                   for a, b in zip(ours, theirs))
        assert same == (i < 4), f"step {i + 1}"


def test_radam_state_round_trips_through_a_checkpoint(tmp_path):
    """Saved after 3 steps and restored into a new optimizer, the run goes
    on bit for bit as the uninterrupted one."""
    p0, grads = _problem(4)
    model = torch.nn.ParameterList([torch.nn.Parameter(_t(p)) for p in p0])
    opt = optim.make_optimizer(model.parameters(), LR, "radam")

    def run(model, opt, gs):
        for g in gs:
            for p, x in zip(model, g):
                p.grad = _t(x)
            opt.step()

    run(model, opt, grads[:3])
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(model, opt, 3, {"epoch": 1})
    model2 = torch.nn.ParameterList([torch.nn.Parameter(torch.zeros_like(p))
                                     for p in model])
    opt2 = optim.make_optimizer(model2.parameters(), LR, "radam")
    step, _ = ckpt.restore(model2, opt2)
    assert step == 3
    assert opt2.param_groups[0]["step"] == opt.param_groups[0]["step"] == 3
    for p, q in zip(model, model2):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[q][key])
    run(model, opt, grads[3:])
    run(model2, opt2, grads[3:])
    for p, q in zip(model, model2):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# bf16 gradient accumulation
# ---------------------------------------------------------------------------

class _Spy(torch.optim.SGD):
    """SGD that keeps a copy of the gradients it is handed."""

    def step(self, closure=None):
        self.seen = [p.grad.clone() for g in self.param_groups
                     for p in g["params"]]
        return super().step(closure)


@pytest.fixture(scope="module")
def tiny_step():
    jexp = _no_dropout(_tiny_experiment())
    exp = config_from_dict(dataclasses.asdict(jexp))
    batch = {k: _t(v) for k, v in _super_batch(jexp, 0).items()}
    loss_fn = losses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10)
    return jexp, exp, batch, loss_fn


def _handed(exp, batch, loss_fn, accum_dtype, grad_accum=A):
    model = get_model(exp.model, device="cpu", seed=5)
    opt = _Spy(model.parameters(), lr=0.0)
    make_train_step(model, "mmtrvapt", loss_fn, opt, grad_accum=grad_accum,
                    accum_dtype=accum_dtype)(
        {k: v[:grad_accum] for k, v in batch.items()})
    return model, opt.seen


def _micro_grads(model, batch, loss_fn):
    """Each micro-batch's fp32 gradients on the model's weights (every
    dropout rate 0): a list per micro-batch, in parameter order."""
    micro = []
    for i in range(A):
        model.zero_grad(set_to_none=True)
        mb = {k: v[i] for k, v in batch.items()}
        loss_fn(model(*model_inputs("mmtrvapt", mb)), mb["target"]).backward()
        micro.append([p.grad.clone() for p in model.parameters()])
    model.zero_grad(set_to_none=True)
    return micro


# the bf16 sum's distance from the exact one: g1, g2 and their sum are each
# rounded to 8 significant bits, half a unit each (at most 2**-8 of the
# value; the sum is at most (|g1| + |g2|)(1 + 2**-8)), so after the 1/2 it
# is at most 2**-8 (|g1| + |g2|)(1 + 2**-9)
BF16_ACCUM_ERR = 2.0 ** -8
BF16_ACCUM_BOUND = 1 + 2.0 ** -9


def test_bf16_accumulation_is_exact(tiny_step):
    _, exp, batch, loss_fn = tiny_step
    model, got = _handed(exp, batch, loss_fn, "bfloat16")
    micro = _micro_grads(model, batch, loss_fn)
    bf = torch.bfloat16
    for n, (g, g1, g2) in enumerate(zip(got, *micro)):
        acc = torch.zeros_like(g1, dtype=bf) + g1.to(bf)
        want = (acc + g2.to(bf)).float() * (1.0 / A)
        assert torch.equal(g, want), n
    _, exact = _handed(exp, batch, loss_fn, "float32")
    assert any(not torch.equal(a, b) for a, b in zip(got, exact))
    for a, b, g1, g2 in zip(got, exact, *micro):
        assert ((a - b).abs() <= BF16_ACCUM_ERR * BF16_ACCUM_BOUND
                * (g1.abs() + g2.abs())).all()


def test_bf16_accumulation_at_one_micro_batch_rounds_nothing(tiny_step):
    _, exp, batch, loss_fn = tiny_step
    _, got = _handed(exp, batch, loss_fn, "bfloat16", grad_accum=1)
    _, want = _handed(exp, batch, loss_fn, None, grad_accum=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bf16_accumulation_step_matches_bpx(tiny_step):
    """One RAdam step at A = 2 with ``accum_dtype="bfloat16"`` in both
    packages from the same weights and batch: the updates agree within the
    lockstep tolerances, widened by where bf16 rounds.  RAdam's first step
    is the momentum step, -lr times the gradient, so the update carries
    the accumulated gradient unamplified (Adam's first step, g / (|g| +
    eps), would blow the fp32 noise of a zero gradient up to +-lr).  The
    two packages' fp32 gradients differ in their last bits, which can move
    a bf16 rounding by one unit on either side: each side's sum is within
    ``BF16_ACCUM_ERR * BF16_ACCUM_BOUND * (|g1| + |g2|)`` of the exact
    one, so the updates
    may differ by twice that times lr on top of the lockstep tolerance."""
    jexp, exp, batch, _ = tiny_step
    jmodel = jget_model(jexp.model)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    first = {k: v[0] for k, v in jbatch.items()}
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         *jmodel_inputs("mmtrvapt", first))["params"]
    tx = joptim.make_optimizer(LR, "radam")
    jstep = jax.jit(jmake_train_step(
        jmodel, "mmtrvapt",
        jlosses.make_loss_fn("synthetic", "multilabel", True, FREQS, 10),
        tx, grad_accum=A, accum_dtype="bfloat16"))
    state, _ = jstep(TrainState.create(params, tx), jbatch,
                     jax.random.PRNGKey(1))
    before = params_from_flax(jax.tree.map(np.asarray, params), exp.model)
    want = params_from_flax(jax.tree.map(np.asarray, state.params),
                            exp.model)

    model = get_model(exp.model, device="cpu")
    model.load_state_dict(before)
    opt = optim.make_optimizer(model.parameters(), LR, "radam")
    make_train_step(model, "mmtrvapt",
                    losses.make_loss_fn("synthetic", "multilabel", True,
                                        FREQS, 10),
                    opt, grad_accum=A, accum_dtype="bfloat16")(batch)
    got = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.load_state_dict(before)
    micro = _micro_grads(model, batch, losses.make_loss_fn(
        "synthetic", "multilabel", True, FREQS, 10))
    names = [n for n, _ in model.named_parameters()]
    delta = {n: want[n] - before[n] for n in want}
    floor = 1e-5 * max(float(d.abs().max()) for d in delta.values())
    for n, g1, g2 in zip(names, *micro):
        d = delta[n]
        diff = (got[n] - before[n] - d).abs()
        tol = (1e-3 * d.abs() + 1e-3 * d.abs().max() + floor
               + 2 * LR * BF16_ACCUM_ERR * BF16_ACCUM_BOUND
               * (g1.abs() + g2.abs()))
        assert (diff <= tol).all(), (n, float((diff - tol).max()))
