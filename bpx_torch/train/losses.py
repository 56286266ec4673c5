"""Loss functions (counterpart: ``bpx/train/losses.py``).

* multilabel -> BCE-with-logits, mean over all elements, with an optional
  inverse-frequency per-class ``pos_weight`` on the positive term only;
* classification -> cross-entropy, optionally class-weighted with torch's
  weighted-mean normalisation;
* cmu-mosi -> L1 regression on the squeezed (B, 1) head.

Every loss is computed in fp32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def inverse_frequency_weights(label_freqs: Sequence[float],
                              train_data_len: int) -> np.ndarray:
    """``(freq / N) ** -1`` per class."""
    freqs = np.asarray(label_freqs, dtype=np.float64)
    return np.asarray((freqs / float(train_data_len)) ** -1,
                      dtype=np.float32)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Mean BCE over all elements; ``pos_weight`` scales only the positive
    term (torch ``BCEWithLogitsLoss`` semantics)."""
    logits = logits.float()
    targets = targets.float()
    pos = targets * F.logsigmoid(logits)
    if pos_weight is not None:
        pos = pos * pos_weight
    return -torch.mean(pos + (1.0 - targets) * F.logsigmoid(-logits))


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """CE with torch's weighted-mean reduction:
    ``sum_i w_{y_i} * nll_i / sum_i w_{y_i}``."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, targets.long()[:, None])[:, 0]
    if class_weights is None:
        return nll.mean()
    w = class_weights[targets.long()]
    return (w * nll).sum() / w.sum()


def l1_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds.float() - targets.float()))


def make_loss_fn(task: str, task_type: str, weight_classes: bool = True,
                 label_freqs: Optional[Sequence[float]] = None,
                 train_data_len: Optional[int] = None,
                 device=None) -> Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]:
    """The per-task loss ``loss_fn(logits, targets)``; class weights, when
    used, live on ``device``."""
    weights = None
    if (weight_classes and task != "cmu-mosi" and label_freqs is not None
            and train_data_len):
        weights = torch.tensor(
            inverse_frequency_weights(label_freqs, train_data_len),
            device=device)

    if task_type == "multilabel":
        return lambda logits, targets: bce_with_logits(logits, targets,
                                                       weights)
    if task == "cmu-mosi":
        return lambda logits, targets: l1_loss(logits[:, 0], targets)
    return lambda logits, targets: weighted_cross_entropy(logits, targets,
                                                          weights)
