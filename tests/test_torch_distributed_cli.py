"""The training CLI on a mesh of gloo ranks: ``cli_main`` with
``--device cpu`` and the ``--mesh_*`` flags, as ``torchrun
--nproc_per_node 2 -m bpx_torch.cli.train ...`` runs it on two cards.

Two ranks train and test a tiny synthetic run on fsdp=2 (FSDP2) for one
epoch, then resume it to two; a second run reads ``--mesh_data 1
--mesh_tensor 2`` (the tensor split); a mesh that does not divide the
world raises on every rank.  The synthetic task is cut to 32 training
samples (two accumulation steps of 2 x 8 an epoch).
"""

import json

import numpy as np
import pytest

from tests import _torch_distributed as td
from tests.test_torch_cli import SMALL


def _argv(tmp_path, name, *extra):
    return SMALL + ["--from_seed", "2", "--to_seed", "2", "--savedir",
                    str(tmp_path), "--name", name, *extra]


def _log(run):
    return (run / "logfile.log").read_text()


def test_cli_trains_and_resumes_on_a_mesh(tmp_path):
    argv = _argv(tmp_path, "fsdp", "--mesh_data", "1", "--mesh_fsdp", "2")
    td.spawn(2, td.cli_worker, tmp_path, argv + ["--max_epochs", "1"], 32)
    run = tmp_path / "fsdp_Seed2_run"
    assert "mesh: {'data': 1, 'fsdp': 2, 'tensor': 1}" in _log(run)
    for name in ("best", "latest", "config.json", "preds_raw.npy",
                 "test_labels_pred.txt"):
        assert (run / name).exists(), name
    first = np.load(run / "preds_raw.npy")
    td.spawn(2, td.cli_worker, tmp_path, argv + ["--max_epochs", "2"], 32)
    log = _log(run)
    assert "resumed from epoch 1" in log
    assert "Epoch 1 |" in log
    with open(run / "host_state.json") as f:
        assert json.load(f)["epoch"] == 2
    assert np.load(run / "preds_raw.npy").shape == first.shape


def test_cli_reads_the_tensor_split(tmp_path):
    argv = _argv(tmp_path, "tp", "--mesh_data", "1", "--mesh_tensor", "2",
                 "--max_epochs", "1")
    td.spawn(2, td.cli_worker, tmp_path, argv, 32)
    log = _log(tmp_path / "tp_Seed2_run")
    assert "mesh: {'data': 1, 'fsdp': 1, 'tensor': 2}" in log
    assert "Test" in (tmp_path / "tp_Seed2_run" / "logfileTest.log"
                      ).read_text()


def test_cli_mesh_that_does_not_divide_the_world_raises(tmp_path):
    argv = _argv(tmp_path, "bad", "--mesh_data", "3", "--max_epochs", "1")
    with pytest.raises(Exception, match=r"mesh 3x1x1 != 2 ranks"):
        td.spawn(2, td.cli_worker, tmp_path, argv, 32)
