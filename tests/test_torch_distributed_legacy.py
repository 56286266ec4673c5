"""The notebook-era models' sharded step on gloo ranks, under the tensor
split.

Their 2E-wide memory encoders and crossmodal encoders are
``TransformerEncoder``s and their BERT ``BertLayer``s, which the split
cuts as it cuts BPMulT's; their GMU layers (original, bimodal,
hierarchical, softmax) and BERT's pooler stay whole on every rank.  The
model is moviescope's mmtrvapt pattern of
``tests/test_torch_distributed.py``, shrunk (hidden 32 over 2 heads, so
the memory encoders' 64 over 2), as each registry name.

* Every name at data=2 x tensor=2 with every dropout on, and mmtrvpa
  also at 2 x 2 x 2, against the port's one-process step (which
  ``tests/test_torch_legacy_train.py`` holds against bpx): loss within
  atol 1e-5, whole weights 1e-4.
* mmtrvpa and bertclf without dropout at data=2 x tensor=2 against bpx's
  single-device SGD step from its initial weights, within atol 1e-4.

Every case of one world size runs in one spawn (``sharded_runs``).
"""

import dataclasses

import numpy as np
import pytest

from tests import _torch_distributed as td
from tests.test_torch_distributed import (FREQS, LR, assert_matches_bpx,
                                          bpx_sgd_step, no_dropout,
                                          super_batch, tiny_vapt)
from tests.test_torch_distributed_dropout import spec_for, with_dropout

NAMES = ("mmtrvpa", "tmmtrvpa", "gmu", "gmu_bi", "gmu_hier", "gmu_softmax",
         "bertclf", "bert")
AGAINST_BPX = ("mmtrvpa", "bertclf")
DATA2_TENSOR2 = (2, 1, 2)


def as_model(jexp, name):
    return jexp.replace(model=jexp.model.replace(model=name))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process specs, bpx's steps, and the port's sharded steps of
    every case."""
    specs, one, bpx = {}, {}, {}
    for name in NAMES:
        one[name] = spec_for(as_model(with_dropout(tiny_vapt()), name),
                             steps=1)
        specs[name] = dict(one[name], mesh=DATA2_TENSOR2)
    specs["mmtrvpa_2x2x2"] = dict(one["mmtrvpa"], mesh=(2, 2, 2))
    for name in AGAINST_BPX:
        jexp = as_model(tiny_vapt(), name)
        jexp = jexp.replace(model=no_dropout(jexp.model))
        batch = super_batch(jexp, 0)
        bpx[name] = bpx_sgd_step(jexp, batch, "synthetic", "multilabel",
                                 FREQS)
        specs[f"bpx_{name}"] = dict(
            exp=dataclasses.asdict(jexp), state=bpx[name][0],
            optimizer="sgd", lr=LR, task="synthetic",
            task_type="multilabel", freqs=FREQS, accum=2, batches=[batch],
            mesh=DATA2_TENSOR2)
    got = td.sharded_runs(tmp_path_factory.mktemp("legacy"), specs)
    return dict(one=one, bpx=bpx, got=got)


def assert_equals_one_process(got, spec):
    one = td.run_steps(spec)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                               rtol=1e-5)
    assert set(got["state"]) == set(one["state"])
    for n, w in one["state"].items():
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("name", NAMES)
def test_legacy_data2_tensor2_equals_one_process(runs, name):
    assert_equals_one_process(runs["got"][name], runs["one"][name])


def test_mmtrvpa_2x2x2_equals_one_process(runs):
    assert_equals_one_process(runs["got"]["mmtrvpa_2x2x2"],
                              runs["one"]["mmtrvpa"])


@pytest.mark.parametrize("name", AGAINST_BPX)
def test_legacy_data2_tensor2_matches_bpx_single_device(runs, name):
    init, loss, after = runs["bpx"][name]
    assert_matches_bpx(runs["got"][f"bpx_{name}"], loss, after)
    moved = max(float((after[n] - init[n]).abs().max()) for n in init)
    assert moved > 1e-2
