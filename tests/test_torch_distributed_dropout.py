"""The port's sharded train step with every dropout on, against its own
one-process step, on gloo ranks.

bpx's dropout keys cannot be reproduced without JAX, so the reference is
the port's one-process step with the same seed: a sharded step draws the
same base seeds on every rank and hashes each mask at the global index of
the rows, heads and feature columns its rank holds (the flash blocks'
placement, the hash dropout's), so it must take the same step.  Limits:
atol 1e-5 on the loss and 1e-4 on the whole weights.  Cases:

* mmtrvapt (the flash path) at data=2 x tensor=2 and 2 x 2 x 2, two SGD
  steps (Adam would turn the fp32 noise of gradients that are 0, such as
  the key biases', into steps of the learning rate);
* the einsum attention (``attention_impl="xla"``) at tensor=2, whose
  probabilities' dropout is placed at the rank's heads;
* bf16 gradient accumulation at A = 2 under FSDP2 (fsdp=2): each
  micro-batch's gradient is reduced before it is rounded, as one process
  rounds it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bpx_torch.config import config_from_dict
from bpx_torch.models import get_model
from tests import _torch_distributed as td
from tests.test_torch_distributed import no_dropout, super_batch, tiny_vapt
from tests.test_torch_loop import few_threads  # noqa: F401

FREQS = [5, 2, 9, 1, 4]


def with_dropout(jexp, impl="pallas"):
    """Every dropout of the tiny mmtrvapt on, at distinct rates."""
    m = jexp.model.replace(
        attn_dropout=0.1, attn_dropout_a=0.2, attn_dropout_v=0.15,
        relu_dropout=0.1, res_dropout=0.1, out_dropout=0.1,
        embed_dropout=0.1, attention_impl=impl,
        bert=dataclasses.replace(jexp.model.bert, hidden_dropout=0.1,
                                 attention_dropout=0.1))
    return jexp.replace(model=m)


def spec_for(jexp, optimizer="sgd", accum_dtype=None, steps=2):
    exp = config_from_dict(dataclasses.asdict(jexp))
    model = get_model(exp.model, device="cpu", seed=5)
    return dict(exp=dataclasses.asdict(jexp),
                state={k: v.clone() for k, v in model.state_dict().items()},
                optimizer=optimizer, lr=0.1, task="synthetic",
                task_type="multilabel", freqs=FREQS, accum=2,
                accum_dtype=accum_dtype, gen_seed=7,
                batches=[super_batch(jexp, s) for s in range(steps)])


def assert_sharded_equals_one_process(tmp_path, spec, layout):
    one = td.run_steps(spec)
    spec = dict(spec, mesh=layout)
    spec_path, out_path = tmp_path / "spec.pt", tmp_path / "out.pt"
    torch.save(spec, spec_path)
    td.spawn(int(np.prod(layout)), td.step_worker, tmp_path, str(spec_path),
             str(out_path))
    got = torch.load(out_path, weights_only=False)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], one["grad_norm"],
                               rtol=1e-5)
    for n, w in one["state"].items():
        np.testing.assert_allclose(got["state"][n].numpy(), w.numpy(),
                                   rtol=0, atol=1e-4, err_msg=n)
    return one, got


@pytest.mark.parametrize("layout", [(2, 1, 2), (2, 2, 2)],
                         ids=["data2_tensor2", "2x2x2"])
def test_sharded_dropout_step_equals_one_process(tmp_path, layout):
    spec = spec_for(with_dropout(tiny_vapt()))
    one, _ = assert_sharded_equals_one_process(tmp_path, spec, layout)
    # the masks matter: without dropout the same step differs
    jexp = tiny_vapt()
    off = dict(spec, exp=dataclasses.asdict(
        jexp.replace(model=no_dropout(jexp.model))))
    assert abs(td.run_steps(off)["loss"][0] - one["loss"][0]) > 1e-3


def test_einsum_attention_dropout_split_heads(tmp_path):
    spec = spec_for(with_dropout(tiny_vapt(), impl="xla"), steps=1)
    assert_sharded_equals_one_process(tmp_path, spec, (1, 1, 2))


def test_bf16_accumulation_under_fsdp_equals_one_process(tmp_path):
    spec = spec_for(with_dropout(tiny_vapt()), accum_dtype="bfloat16",
                    steps=1)
    one, got = assert_sharded_equals_one_process(tmp_path, spec, (1, 2, 1))
    # bf16 rounding moved the step: it is not the fp32 accumulation's
    fp32 = td.run_steps(dict(spec, accum_dtype=None))
    assert max(float((fp32["state"][n] - w).abs().max())
               for n, w in one["state"].items()) > 0
