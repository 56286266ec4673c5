"""Batch inference / serving (counterpart: ``bpx/serve.py``).

Usage::

    from bpx_torch.config import get_preset
    from bpx_torch.serve import ExportedPredictor, Predictor

    predictor = Predictor(get_preset("moviescope"), batch_size=8)  # cuda
    probs = predictor(batch)                       # (n, n_classes) numpy
    probs, gates = predictor(batch, return_gates=True)

    predictor.export(batch, "model.pt2")           # build time
    server = ExportedPredictor.load("model.pt2")   # deploy time
    probs = server(batch)

``batch`` is a dict of numpy arrays keyed like the JAX package's batches
(``txt``, ``mask``, ``segment``, ``video``, ``audio``, and ``poster`` for
mmtrvapt); each model reads the keys it takes (``inputs._INPUT_KEYS``: the
notebook-era ``gmu_bi`` no audio, ``bertclf`` text only) and ignores the
rest.  The gates are the final fusion's, (n, 0) for ``bertclf``, which has
none.  A client batch smaller than ``batch_size`` is padded by repeating
its last row and sliced back.  Weights are random from ``seed`` unless a
``state_dict`` is given (e.g. from
:func:`bpx_torch.interop.params_from_flax`), or restored from a run
directory of the port's trainer::

    predictor = Predictor.from_checkpoint(exp, "runs/name_Seed1_run")

:meth:`Predictor.export` traces the serving forward (the model, the task's
sigmoid or softmax, the gates) with ``torch.export`` at ``(batch_size, ...)``
on the predictor's device and writes ``torch.export.save``'s archive, the
weights inside it; it takes every model of the registry.  The kernels stay
one custom-op node each (``bpx_torch::flash_fwd``, ``bpx_torch::layer_norm``);
the rest of the graph is ATen.  :class:`ExportedPredictor` serves the archive with torch and
``bpx_torch.ops`` alone (which register the ops and build the kernels): no
model code, config, checkpoint or dataset.
"""

from __future__ import annotations

import io
import json
from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch
from torch import nn

from bpx_torch.inputs import _INPUT_KEYS
# the kernels' custom ops, which an exported program calls
from bpx_torch.ops import _cuda, flash_attention, norm  # noqa: F401

if TYPE_CHECKING:
    from bpx_torch.config import ExperimentConfig

#: the archive's entry naming the model inputs, in the graph's order
_INPUTS_ENTRY = "bpx_inputs.json"


def _pad(batch: Dict[str, np.ndarray], batch_size: int
         ) -> Dict[str, np.ndarray]:
    """A client batch padded to ``batch_size`` rows by repeating its last
    row (``valid`` dropped)."""
    n = batch["txt"].shape[0]
    if n > batch_size:
        raise ValueError(f"client batch {n} exceeds compiled size "
                         f"{batch_size}")

    def pad(x):
        x = np.asarray(x)
        if x.shape[0] == batch_size:
            return x
        return np.concatenate(
            [x, np.repeat(x[-1:], batch_size - x.shape[0], axis=0)], axis=0)

    return {k: pad(v) for k, v in batch.items() if k != "valid"}


def _padded_call(fn, batch: Dict[str, np.ndarray], batch_size: int,
                 return_gates: bool):
    """Pad a ragged client batch to ``batch_size`` (repeating the last
    row), run ``fn(batch) -> (probs, gates)``, slice back to the client
    rows."""
    n = batch["txt"].shape[0]
    probs, gates = fn(_pad(batch, batch_size))
    probs = probs[:n]
    if return_gates:
        return probs, gates[:n]
    return probs


def _to_numpy(probs: torch.Tensor, gates: torch.Tensor):
    return probs.cpu().numpy(), gates.cpu().numpy()


class _Serving(nn.Module):
    """The serving forward: the model's logits and gates, the task's
    sigmoid (multilabel, cmu-mosi) or softmax, all in fp32."""

    def __init__(self, model: nn.Module, sigmoid: bool):
        super().__init__()
        self.model = model
        self.sigmoid = sigmoid

    def forward(self, *inputs):
        logits, gates = self.model(*inputs, output_gates=True)
        logits = logits.float()
        probs = (torch.sigmoid(logits) if self.sigmoid
                 else torch.softmax(logits, dim=-1))
        return probs, gates.float()


class Predictor:
    def __init__(self, exp: "ExperimentConfig",
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 batch_size: int = 8, device=None, seed: int = 0):
        from bpx_torch.models import get_model
        self.exp = exp
        self.batch_size = batch_size
        self.model = get_model(exp.model, device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        task, task_type = exp.data.task, exp.data.task_type
        self._serving = _Serving(
            self.model, task_type == "multilabel" or task == "cmu-mosi")

    @classmethod
    def from_checkpoint(cls, exp: "ExperimentConfig", ckpt_dir: str,
                        example_batch: Optional[Dict[str, np.ndarray]] = None,
                        batch_size: int = 8, tag: str = "best",
                        device=None) -> "Predictor":
        """Serve the weights of ``ckpt_dir``'s ``tag`` checkpoint (a run
        directory of :mod:`bpx_torch.train.loop`).  ``example_batch`` is
        accepted for the JAX package's signature and not needed: the port
        builds its modules from the config alone."""
        from bpx_torch.utils.checkpoint import CheckpointManager
        pred = cls(exp, batch_size=batch_size, device=device)
        CheckpointManager(ckpt_dir).restore(pred.model, tag=tag)
        return pred

    def _inputs(self, batch: Dict[str, np.ndarray]):
        return tuple(torch.from_numpy(np.ascontiguousarray(batch[k]))
                     .to(self.device)
                     for k in _INPUT_KEYS[self.exp.model.model])

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]):
        """(probs, gates) as fp32 numpy for a batch of exactly the device
        batch (no padding)."""
        return _to_numpy(*self._serving(*self._inputs(batch)))

    def warmup(self, example_batch: Dict[str, np.ndarray]) -> None:
        """Build the kernels' library (on a card) and serve the example
        once at the padded shapes, before traffic: the first request then
        pays no build and no cuBLAS/cuDNN set-up."""
        if self.device.type == "cuda":
            _cuda.library()
        self(example_batch)

    def export(self, example_batch: Dict[str, np.ndarray],
               path: Optional[str] = None) -> bytes:
        """Trace the serving forward with ``torch.export`` at
        ``(batch_size, ...)`` on the predictor's device, in eval mode,
        without grad, and return (and write to ``path``) its
        ``torch.export.save`` archive: the weights travel inside it, and
        :class:`ExportedPredictor` serves it.

        The example is served once first (:meth:`warmup`), so the model's
        host-side tables (positions, the audio pooling matrix) are built
        from real tensors and traced in as constants."""
        self.warmup(example_batch)
        inputs = self._inputs(_pad(example_batch, self.batch_size))
        self.model.eval()
        with torch.no_grad():
            program = torch.export.export(self._serving, inputs)
        buf = io.BytesIO()
        keys = list(_INPUT_KEYS[self.exp.model.model])
        torch.export.save(program, buf,
                          extra_files={_INPUTS_ENTRY: json.dumps(keys)})
        blob = buf.getvalue()
        if path is not None:
            with open(path, "wb") as f:
                f.write(blob)
        return blob

    def __call__(self, batch: Dict[str, np.ndarray],
                 return_gates: bool = False):
        """Predict on a host batch of any size <= ``batch_size``."""
        return _padded_call(self.forward, batch, self.batch_size,
                            return_gates)


class ExportedPredictor:
    """Serve a :meth:`Predictor.export` archive.  The batch size, device
    and input dtypes are read from the program's input spec; the host-side
    contract (pad a ragged client batch, slice back) is
    :class:`Predictor`'s."""

    def __init__(self, blob: bytes):
        extra = {_INPUTS_ENTRY: ""}
        self.program = torch.export.load(io.BytesIO(blob), extra_files=extra)
        self._keys = json.loads(extra[_INPUTS_ENTRY])
        user = set(self.program.graph_signature.user_inputs)
        self._specs = [n.meta["val"] for n in self.program.graph.nodes
                       if n.op == "placeholder" and n.name in user]
        self.batch_size = self._specs[0].shape[0]
        self.device = self._specs[0].device
        self._forward = self.program.module()
        if self.device.type == "cuda":
            _cuda.library()

    @classmethod
    def load(cls, path: str) -> "ExportedPredictor":
        with open(path, "rb") as f:
            return cls(f.read())

    @torch.inference_mode()
    def forward(self, batch: Dict[str, np.ndarray]):
        """(probs, gates) as fp32 numpy for a batch of exactly
        ``batch_size`` rows."""
        inputs = [torch.from_numpy(np.ascontiguousarray(batch[k]))
                  .to(self.device, spec.dtype)
                  for k, spec in zip(self._keys, self._specs)]
        return _to_numpy(*self._forward(*inputs))

    def __call__(self, batch: Dict[str, np.ndarray],
                 return_gates: bool = False):
        return _padded_call(self.forward, batch, self.batch_size,
                            return_gates)
