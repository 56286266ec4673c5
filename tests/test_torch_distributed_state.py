"""Checkpoints across placements, on gloo ranks: a sharded run's
checkpoint restores into one process, and one process's into a sharded
run, in the port's one file format (whole, unsharded tensors; the
optimizer's state dict keyed by parameter index, as one process writes
it).

The tiny mmtrvapt of ``tests/test_torch_distributed.py`` with every
dropout on takes Adam steps at a learning rate of 1e-5: Adam turns the
fp32 noise of a gradient that is 0 (the key biases') into a step of the
learning rate, which stays under the 1e-4 limit on the weights.  Sharded
saves run on fsdp=2 x tensor=2 (FSDP2's shards and the split's parts both
gathered), sharded restores on data=2 x tensor=2.
"""

import numpy as np
import torch

from bpx_torch.utils.checkpoint import CheckpointManager
from tests import _torch_distributed as td
from tests.test_torch_distributed_dropout import spec_for, with_dropout
from tests.test_torch_distributed import tiny_vapt


def _spec(layout):
    return dict(spec_for(with_dropout(tiny_vapt()), optimizer="adam"),
                lr=1e-5, mesh=layout)


def _close(got, want, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what} {k}")


def _one_process(spec, steps):
    """The one-process run of ``spec``'s first ``steps`` super-batches:
    (model, optimizer)."""
    model, opt, step = td.build_step(spec)
    for b in spec["batches"][:steps]:
        step({k: torch.from_numpy(v) for k, v in b.items()})
    return model, opt


def test_sharded_checkpoint_restores_into_one_process(tmp_path):
    spec = _spec((1, 2, 2))
    spec_path, save = tmp_path / "spec.pt", tmp_path / "run"
    torch.save(spec, spec_path)
    td.spawn(4, td.checkpoint_worker, tmp_path, str(spec_path), str(save),
             "", "save")
    want_model, want_opt = _one_process(spec, 1)
    saved = CheckpointManager(str(save)).load()
    # the one-process format: whole tensors, the optimizer by index
    _close(saved["model"], want_model.state_dict(), 1e-4, "weights")
    want = want_opt.state_dict()
    assert saved["optimizer"]["param_groups"] == want["param_groups"]
    assert set(saved["optimizer"]["state"]) == set(want["state"])
    for i, entry in want["state"].items():
        _close(saved["optimizer"]["state"][i], entry, 1e-6, f"moment {i}")
    # and it restores into one process
    model, opt, _ = td.build_step(spec)
    step, host = CheckpointManager(str(save)).restore(model, opt)
    assert (step, host) == (1, {"epoch": 1})
    _close(model.state_dict(), saved["model"], 0, "restored")


def test_one_process_checkpoint_restores_into_sharded_run(tmp_path):
    spec = _spec((2, 1, 2))
    model, opt = _one_process(spec, 1)
    save = tmp_path / "run"
    CheckpointManager(str(save)).save(model, opt, 1, {"epoch": 1})
    spec_path, out = tmp_path / "spec.pt", tmp_path / "out.pt"
    torch.save(spec, spec_path)
    td.spawn(4, td.checkpoint_worker, tmp_path, str(spec_path), str(save),
             str(out), "restore")
    got = torch.load(out, weights_only=False)
    assert (got["step"], got["host"]) == (1, {"epoch": 1})
    # restored exactly: gathered back, every weight and moment is the file's
    saved = CheckpointManager(str(save)).load()
    _close(got["model"], saved["model"], 0, "restored weights")
    for i, entry in saved["optimizer"]["state"].items():
        _close(got["optimizer"]["state"][i], entry, 0, f"restored moment {i}")
    # and the resumed sharded step is the one-process run's second step
    want, _ = _one_process(spec, 2)
    _close(got["after"], want.state_dict(), 1e-4, "second step")
