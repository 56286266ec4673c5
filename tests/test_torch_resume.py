"""Resuming the port's training against the JAX package's resume.

The runs of tests/test_torch_loop.py (``synthetic-tiny`` at depth 1, fp32,
CPU): two epochs, then the same run resumed to three, in both packages
from bpx's initial weights with dropout off.  Each call holds lockstep with
bpx's (per-epoch loss and metrics within rtol 2e-3 / atol 2e-4; learning
rate, stopper, plateau and ``best`` epochs equal), and the resumed call
restores the epoch, the schedule and the weights and Adam moments bit for
bit.  With dropout on, a resumed step draws the base seeds the
uninterrupted run drew at that step.
"""

import dataclasses
import json

import pytest
import torch

import bpx_torch.train.loop as loop
import bpx_torch.train.steps as steps
from bpx_torch.config import config_from_dict
from bpx_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_loop import (assert_lockstep, few_threads,  # noqa: F401
                                   run_bpx, run_port, tiny_experiment,
                                   with_epochs)


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("resume")
    jexp = tiny_experiment(root / "bpx", "run", max_epochs=2)
    exp = config_from_dict(dataclasses.asdict(jexp))
    exp = exp.replace(train=dataclasses.replace(exp.train,
                                                savedir=str(root / "port")))
    out = dict(dir=root / "port" / "run", jdir=root / "bpx" / "run")
    try:
        for key, epochs in (("first", 2), ("resumed", 3)):
            with mp.context() as m:
                out["j" + key] = run_bpx(m, with_epochs(jexp, epochs))
            with mp.context() as m:
                ckpt = CheckpointManager(str(out["dir"]))
                if key == "resumed":
                    out["saved"] = ckpt.load("latest")
                restore = CheckpointManager.restore

                def spy(self, model, optimizer=None, tag="latest"):
                    got = restore(self, model, optimizer, tag)
                    out["restored"] = (
                        {k: v.clone() for k, v in model.state_dict().items()},
                        {k: {n: t.clone() for n, t in s.items()}
                         for k, s in optimizer.state_dict()["state"].items()},
                        got)
                    return got

                m.setattr(CheckpointManager, "restore", spy)
                out[key] = run_port(m, with_epochs(exp, epochs),
                                    out["j" + key])
    finally:
        mp.undo()
    return out


def test_first_run_lockstep_with_bpx(resumed):
    assert len(resumed["first"].val) == 2
    assert_lockstep(resumed["first"], resumed["jfirst"])


def test_resume_lockstep_with_bpx(resumed):
    rec, jrec = resumed["resumed"], resumed["jresumed"]
    start = resumed["saved"]
    with open(resumed["jdir"] / "host_state.json") as f:
        jhost = json.load(f)
    # bpx and the port resumed from the same epoch and ran the rest
    assert len(rec.val) == len(jrec.val) == 3 - resumed["first"].saved[-1]
    assert_lockstep(rec, jrec)
    with open(resumed["dir"] / "host_state.json") as f:
        host = json.load(f)
    assert host["epoch"] == jhost["epoch"]
    assert start["step"] == 3 * resumed["first"].saved[-1]


def test_resume_restores_state_bitwise(resumed):
    weights, moments, (step, host) = resumed["restored"]
    saved = resumed["saved"]
    assert step == saved["step"]
    assert host["epoch"] == resumed["first"].saved[-1]
    assert set(weights) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(weights[k], v), k
    for idx, state in saved["optimizer"]["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(moments[idx][name], state[name])


def test_resumed_dropout_draws_the_uninterrupted_seeds(tmp_path, monkeypatch):
    """Dropout on: the base seeds of every step of a 2-epoch run resumed to
    3 are those of the uninterrupted 3-epoch run at the same steps."""
    draws = []
    draw = steps.draw_base_seed
    monkeypatch.setattr(steps, "draw_base_seed",
                        lambda gen: draws.append(draw(gen)) or draws[-1])
    jexp = tiny_experiment(tmp_path / "u", "run", dropout=True)
    exp = config_from_dict(dataclasses.asdict(jexp))
    loop.train(exp, device="cpu")
    uninterrupted = list(draws)
    assert len(uninterrupted) == 3 * 3 * 2       # epochs x steps x A

    exp2 = exp.replace(train=dataclasses.replace(
        exp.train, savedir=str(tmp_path / "r")))
    draws.clear()
    loop.train(with_epochs(exp2, 2), device="cpu")
    assert draws == uninterrupted[:12]
    step = CheckpointManager(str(tmp_path / "r" / "run")).load()["step"]
    draws.clear()
    loop.train(exp2, device="cpu")
    assert draws == uninterrupted[2 * step:]
    assert len(set(uninterrupted)) == len(uninterrupted)
