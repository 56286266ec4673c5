"""Batch inference / serving (counterpart: ``bpx/serve.py::Predictor``).

Usage::

    from bpx_torch.config import get_preset
    from bpx_torch.serve import Predictor

    predictor = Predictor(get_preset("moviescope"), batch_size=8)  # cuda
    probs = predictor(batch)                       # (n, n_classes) numpy
    probs, gates = predictor(batch, return_gates=True)

``batch`` is a dict of numpy arrays keyed like the JAX package's batches
(``txt``, ``mask``, ``segment``, ``video``, ``audio``, and ``poster`` for
mmtrvapt; the presets of mmtrvat take no poster); a client
batch smaller than ``batch_size`` is padded by repeating its last row and
sliced back.  Weights are random from ``seed`` unless a ``state_dict`` is
given (e.g. from :func:`bpx_torch.interop.params_from_flax`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bpx_torch.config import ExperimentConfig
from bpx_torch.inputs import model_inputs
from bpx_torch.models import get_model


def _padded_call(fn, batch: Dict[str, np.ndarray], batch_size: int,
                 return_gates: bool):
    """Pad a ragged client batch to ``batch_size`` (repeating the last
    row), run ``fn(batch) -> (probs, gates)``, slice back to the client
    rows."""
    n = batch["txt"].shape[0]
    B = batch_size
    if n > B:
        raise ValueError(f"client batch {n} exceeds compiled size {B}")

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] == B:
            return x
        return np.concatenate(
            [x, np.repeat(x[-1:], B - x.shape[0], axis=0)], axis=0)

    probs, gates = fn({k: pad(v) for k, v in batch.items() if k != "valid"})
    probs = probs[:n]
    if return_gates:
        return probs, gates[:n]
    return probs


class Predictor:
    def __init__(self, exp: ExperimentConfig,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 batch_size: int = 8, device=None, seed: int = 0):
        self.exp = exp
        self.batch_size = batch_size
        self.model = get_model(exp.model, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        task, task_type = exp.data.task, exp.data.task_type
        self._sigmoid = task_type == "multilabel" or task == "cmu-mosi"

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]):
        """(probs, gates) as fp32 numpy for a batch of exactly the device
        batch (no padding)."""
        inputs = [self._to_device(x)
                  for x in model_inputs(self.exp.model.model, batch)]
        logits, gates = self.model(*inputs, output_gates=True)
        logits = logits.float()
        probs = (torch.sigmoid(logits) if self._sigmoid
                 else torch.softmax(logits, dim=-1))
        return probs.cpu().numpy(), gates.float().cpu().numpy()

    def __call__(self, batch: Dict[str, np.ndarray],
                 return_gates: bool = False):
        """Predict on a host batch of any size <= ``batch_size``."""
        return _padded_call(self.forward, batch, self.batch_size,
                            return_gates)
