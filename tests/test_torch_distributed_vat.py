"""The port's sharded train step against the JAX package's single-device
step: iemocap's mmtrvat pattern, shrunk, with the narrow heads and the
class-weighted cross-entropy, on gloo ranks.

The model has hidden 50 over 2 heads (head_dim 25, as iemocap's 300 over
12; under tensor=2 each rank runs one head of 25), one encoder and one
BERT layer, the preset's recompute (``remat``, so FSDP2 meets
``torch.utils.checkpoint``), and classification targets with inverse-
frequency class weights: the loss is ``sum(w * nll) / sum(w)`` over the
whole batch, which a mean of the ranks' weighted means is not.  As in
``tests/test_torch_distributed.py``: one SGD step of bpx on one device and
of the port on data=2 (DDP) and fsdp=2 x tensor=2 (FSDP2 over the split),
loss and whole weights within atol 1e-4.
"""

import dataclasses

import pytest

from bpx.config import BertConfig as JBertConfig
from bpx.config import get_preset as jget_preset

from tests.test_torch_distributed import (assert_matches_bpx, bpx_sgd_step,
                                          no_dropout, sharded_step,
                                          super_batch)
from tests.test_torch_loop import few_threads  # noqa: F401

CLASSES = 8
FREQS = [5, 2, 9, 1, 4, 3, 6, 2]


def tiny_vat():
    """iemocap's mmtrvat at hidden 50 over 2 heads, one encoder and one
    BERT layer, the preset's remat, fp32."""
    exp = jget_preset("iemocap")
    model = exp.model.replace(
        hidden_sz=50, num_heads=2, layers=1, n_classes=CLASSES,
        num_vectors_l=16, num_vectors_a=16, num_vectors_v=16,
        orig_d_l=32, orig_d_v=20, orig_d_a=8, compute_dtype="float32",
        bert=dataclasses.replace(JBertConfig.tiny(vocab_size=64),
                                 hidden_size=32, num_heads=2, num_layers=1,
                                 intermediate_size=64, gelu="tanh"))
    data = dataclasses.replace(exp.data, task_type="classification",
                               audio_raw_len=16, video_len=12)
    return exp.replace(model=no_dropout(model), data=data)


@pytest.fixture(scope="module")
def bpx_vat():
    jexp = tiny_vat()
    assert jexp.model.remat and jexp.model.attention_impl == "pallas"
    batch = super_batch(jexp, 3, classes=CLASSES)
    init, loss, after = bpx_sgd_step(jexp, batch, "iemocap",
                                     "classification", FREQS)
    return jexp, batch, init, loss, after


@pytest.mark.parametrize("layout", [(2, 1, 1), (1, 2, 2)],
                         ids=["data2", "fsdp2_tensor2"])
def test_narrow_heads_weighted_ce_step_matches_bpx(tmp_path, bpx_vat,
                                                   layout):
    jexp, batch, init, loss, after = bpx_vat
    got = sharded_step(tmp_path, jexp, init, batch, layout, "iemocap",
                       "classification", FREQS)
    assert_matches_bpx(got, loss, after)
