"""Export of the port's serving forward (``Predictor.export``,
``ExportedPredictor``, ``python -m bpx_torch.cli.export``) against the JAX
package's (``bpx/serve.py``, ``bpx/cli/export.py``).

A tiny mmtrvapt and a tiny mmtrvat (``attention_impl="pallas"``, one
encoder and one BERT layer), weights initialised in ``bpx`` and carried over
with ``params_from_flax``, are exported and reloaded on the CPU; the reloaded program serves a batch and a
ragged one against bpx's ``Predictor`` and its ``jax.export`` artifact
(tolerance 1e-4, as tests/test_torch_model.py: fp32 sums in another order)
and against the port's eager ``Predictor`` (bit for bit: the same ATen ops and
plain versions).  Its graph holds one ``bpx_torch::flash_fwd`` and one
``bpx_torch::layer_norm`` node per kernel call of the eager forward.  The
export CLI runs on a run directory of the port's tiny trainer, and a
process that serves the archive imports no model code.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from bpx.data.synthetic import example_batch as jexample_batch
from bpx.models import get_model as jget_model
from bpx.serve import ExportedPredictor as JExportedPredictor
from bpx.serve import Predictor as JPredictor
from bpx.train.steps import model_inputs as jmodel_inputs

from bpx_torch.cli import export as export_cli
from bpx_torch.cli import train as train_cli
from bpx_torch.config import config_from_dict
from bpx_torch.data.synthetic import example_batch
from bpx_torch.interop import params_from_flax
from bpx_torch.ops import flash_attention as tflash
from bpx_torch.ops import norm as tnorm
from bpx_torch.ops.audio import adaptive_avg_pool_matrix
from bpx_torch.ops.positions import sinusoidal_table
from bpx_torch.serve import ExportedPredictor, Predictor
from tests.test_torch_cli import SMALL
from tests.test_torch_loop import few_threads  # noqa: F401
from tests.test_torch_model import (TOL, _batch, _tiny_experiment,
                                    _tiny_vat_experiment)
from tests.test_torch_train import _expected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


def _cut(jexp):
    """One encoder layer and one BERT layer: the export path is the same
    at any depth, and bpx's initialisation and compilation are shorter."""
    m = jexp.model
    return jexp.replace(model=m.replace(
        layers=1, bert=dataclasses.replace(m.bert, num_layers=1)))


@pytest.fixture(scope="module", params=["mmtrvapt", "mmtrvat"])
def exported(request, tmp_path_factory):
    """(bpx experiment, bpx params, the port's Predictor, the archive's
    path, the reloaded ExportedPredictor) of one tiny model.  The export
    starts with the model's host-side tables (positions, the audio pooling
    matrix) uncached: tracing runs on fake tensors, and the tables it
    leaves cached must stay real for the eager forward."""
    name = request.param
    jexp = _cut(_tiny_experiment() if name == "mmtrvapt"
                else _tiny_vat_experiment())
    inputs = jmodel_inputs(name, {k: jax.numpy.asarray(v)
                                  for k, v in _batch(jexp, 1).items()})
    params = jget_model(jexp.model).init({"params": jax.random.PRNGKey(0)},
                                         *inputs)["params"]
    exp = config_from_dict(dataclasses.asdict(jexp))
    pred = Predictor(exp, params_from_flax(jax.tree.map(np.asarray, params),
                                           exp.model),
                     batch_size=BATCH, device="cpu")
    sinusoidal_table.cache_clear()
    adaptive_avg_pool_matrix.cache_clear()
    path = tmp_path_factory.mktemp("export") / "model.pt2"
    blob = pred.export(_batch(jexp, BATCH, seed=1), str(path))
    assert path.read_bytes() == blob
    return jexp, params, pred, path, ExportedPredictor.load(str(path))


def _requests(jexp):
    batch = _batch(jexp, BATCH, seed=2)
    return batch, {k: v[1:3] for k, v in batch.items()}


def test_exported_predictor_matches_bpx(exported):
    jexp, params, pred, _, server = exported
    assert (server.batch_size, server.device.type) == (BATCH, "cpu")
    jpred = JPredictor(jexp, params, batch_size=BATCH)
    jserver = JExportedPredictor(jpred.export(_batch(jexp, BATCH)))
    for batch in _requests(jexp):
        n = batch["txt"].shape[0]
        probs, gates = server(batch, return_gates=True)
        assert probs.shape == (n, jexp.model.n_classes)
        for want in (jpred, jserver):
            wp, wg = want(batch, return_gates=True)
            np.testing.assert_allclose(probs, np.asarray(wp, np.float32),
                                       **TOL)
            np.testing.assert_allclose(gates, np.asarray(wg, np.float32),
                                       **TOL)
        ep, eg = pred(batch, return_gates=True)
        np.testing.assert_array_equal(probs, ep)
        np.testing.assert_array_equal(gates, eg)
        np.testing.assert_array_equal(server(batch), probs)


def test_exported_graph_has_one_node_per_kernel_call(exported, monkeypatch):
    jexp, _, pred, _, server = exported
    nodes = collections.Counter(
        str(n.target) for n in server.program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("bpx_torch"))
    calls = collections.Counter()
    for module, key in ((tflash, "bpx_torch.flash_fwd.default"),
                        (tnorm, "bpx_torch.layer_norm.default")):
        def counted(*args, _f=module._forward, _key=key):
            calls[_key] += 1
            return _f(*args)
        monkeypatch.setattr(module, "_forward", counted)
    pred(_batch(jexp, BATCH))
    assert nodes == calls
    ln, flash, _ = _expected(pred.exp.model, False)
    assert (nodes["bpx_torch.flash_fwd.default"],
            nodes["bpx_torch.layer_norm.default"]) == (flash, ln)


SERVE = """
import sys
import numpy as np
from bpx_torch.serve import ExportedPredictor
server = ExportedPredictor.load(sys.argv[1])
batch = dict(np.load(sys.argv[2]))
probs, gates = server(batch, return_gates=True)
np.save(sys.argv[3], probs)
assert "bpx_torch.models" not in sys.modules, "imported the model code"
assert "bpx_torch.config" not in sys.modules, "imported the config"
"""


def test_export_cli_on_a_trained_run(tmp_path, few_threads):  # noqa: F811
    """``python -m bpx_torch.cli.export`` on a run directory of the
    port's trainer against ``Predictor.from_checkpoint``, and the archive
    served in a process that imports no model code."""
    train_cli.cli_main(SMALL + ["--max_epochs", "1", "--from_seed", "1",
                                "--to_seed", "1", "--savedir", str(tmp_path),
                                "--name", "exp", "--attention_impl",
                                "pallas"])
    run = tmp_path / "exp_Seed1_run"
    out = tmp_path / "model.pt2"
    assert export_cli.main([str(run), "--out", str(out), "--batch_size",
                            str(BATCH), "--tag", "best",
                            "--device", "cpu"]) == str(out)
    exp = config_from_dict(json.loads(
        (run / "config.json").read_text()))
    pred = Predictor.from_checkpoint(exp, str(run), batch_size=BATCH,
                                     tag="best", device="cpu")
    batch = example_batch(exp, BATCH)
    ragged = {k: v[:3] for k, v in example_batch(exp, BATCH + 2).items()}
    server = ExportedPredictor.load(str(out))
    for b in (batch, ragged):
        np.testing.assert_array_equal(server(b), pred(b))

    np.savez(tmp_path / "batch.npz", **ragged)
    res = subprocess.run(
        [sys.executable, "-c", SERVE, str(out), str(tmp_path / "batch.npz"),
         str(tmp_path / "probs.npy")], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(tmp_path / "probs.npy"),
                                  pred(ragged))


def test_example_batch_matches_bpx():
    for j in (_tiny_experiment(), _tiny_vat_experiment()):
        exp = config_from_dict(dataclasses.asdict(j))
        want, got = jexample_batch(j, 3), example_batch(exp, 3)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype


def test_export_cli_help_exits_zero():
    res = subprocess.run([sys.executable, "-m", "bpx_torch.cli.export",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout and "--batch_size" in res.stdout
