"""The port's sharded step with ``group_encoders`` on gloo ranks.

A grouped pair runs two encoders as one over (2, B, T, E) stacks, every
weight with a leading pair axis of 2, and folds its two members into the
batch of one attention call.  On a mesh the tensor split cuts each
member's heads and FFN (the dims after the pair axis), FSDP2 shards the
pair's weights on their dim 1, and every dropout places each member's
rows in its own part of the global batch.

* Without dropout, against bpx's single-device grouped SGD step (grad
  accumulation 2, fp32) from its initial weights: data=2 (DDP), fsdp=2
  (FSDP2), data=2 x tensor=2 and 2 x 2 x 2, the whole weights and the
  loss within atol 1e-4, as ``tests/test_torch_distributed.py`` holds the
  ungrouped model.
* With every dropout and recompute (``remat``), against the port's own
  one-process grouped step at data=2 x tensor=2: loss within atol 1e-5,
  weights 1e-4, as ``tests/test_torch_distributed_dropout.py``.

The layouts of one world size share one spawn (``sharded_runs``).
"""

import dataclasses

import numpy as np
import pytest

from tests import _torch_distributed as td
from tests.test_torch_distributed import (FREQS, LR, assert_matches_bpx,
                                          bpx_sgd_step, no_dropout,
                                          super_batch, tiny_vapt)
from tests.test_torch_distributed_dropout import spec_for, with_dropout

LAYOUTS = {"data2": (2, 1, 1), "fsdp2": (1, 2, 1), "data2_tensor2": (2, 1, 2),
           "2x2x2": (2, 2, 2)}


def grouped(jexp):
    return jexp.replace(model=jexp.model.replace(group_encoders=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """bpx's grouped step, and the port's sharded steps of every case in
    one spawn per world size."""
    jexp = grouped(tiny_vapt())
    jexp = jexp.replace(model=no_dropout(jexp.model))
    batch = super_batch(jexp, 0)
    init, loss, after = bpx_sgd_step(jexp, batch, "synthetic", "multilabel",
                                     FREQS)
    plain = dict(exp=dataclasses.asdict(jexp), state=init, optimizer="sgd",
                 lr=LR, task="synthetic", task_type="multilabel",
                 freqs=FREQS, accum=2, batches=[batch])
    specs = {key: dict(plain, mesh=layout) for key, layout in LAYOUTS.items()}
    drop = grouped(with_dropout(tiny_vapt()))
    # a pair's two members share one attention dropout rate
    drop = drop.replace(model=drop.model.replace(
        remat=True, attn_dropout_v=drop.model.attn_dropout_a))
    one = spec_for(drop, steps=1)
    specs["dropout_remat"] = dict(one, mesh=LAYOUTS["data2_tensor2"])
    got = td.sharded_runs(tmp_path_factory.mktemp("grouped"), specs)
    return dict(bpx=(init, loss, after), one=one, got=got)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_grouped_step_matches_bpx_single_device(runs, layout):
    init, loss, after = runs["bpx"]
    assert_matches_bpx(runs["got"][layout], loss, after)
    moved = max(float((after[n] - init[n]).abs().max())
                for n in init if n.startswith("g_"))
    assert moved > 1e-2


def test_sharded_grouped_dropout_remat_equals_one_process(runs):
    """Every dropout (the pairs' flash dropout as two placed seed groups,
    their hash dropouts at dim 1) and the pairs' full recompute, two SGD
    steps at data=2 x tensor=2, against one process; the masks matter:
    the same steps without dropout differ."""
    one = td.run_steps(runs["one"])
    got = runs["got"]["dropout_remat"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                               rtol=1e-5)
    for n, w in one["state"].items():
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-4, err_msg=n)
    jexp = grouped(tiny_vapt())
    off = dict(runs["one"], exp=dataclasses.asdict(
        jexp.replace(model=no_dropout(jexp.model))))
    assert abs(td.run_steps(off)["loss"][0] - one["loss"][0]) > 1e-3
