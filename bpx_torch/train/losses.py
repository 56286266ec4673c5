"""Loss functions (counterpart: ``bpx/train/losses.py``).

* multilabel -> BCE-with-logits, mean over all elements, with an optional
  inverse-frequency per-class ``pos_weight`` on the positive term only;
* classification -> cross-entropy, optionally class-weighted with torch's
  weighted-mean normalisation;
* cmu-mosi -> L1 regression on the squeezed (B, 1) head.

Every loss is computed in fp32 whatever the logits' dtype.

On a mesh each rank holds an even part of the batch and DDP / FSDP2
average the ranks' gradients, so a rank's loss is its share of the global
loss times the number of ranks: the plain means need nothing, the
class-weighted cross-entropy divides its rank's sum by the weights summed
over the ranks (``groups``, the ``(data, fsdp)`` process groups), as
the JAX package's one global ``sum(w * nll) / sum(w)`` does under GSPMD.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
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
                           class_weights: Optional[torch.Tensor] = None,
                           groups: Sequence[object] = ()) -> torch.Tensor:
    """CE with torch's weighted-mean reduction:
    ``sum_i w_{y_i} * nll_i / sum_i w_{y_i}``; with ``groups``, a rank's
    share of the batch's over those groups' ranks, times their number
    (the module docstring)."""
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, targets.long()[:, None])[:, 0]
    if class_weights is None:
        return nll.mean()
    w = class_weights[targets.long()]
    if not groups:
        return (w * nll).sum() / w.sum()
    total = w.sum().detach().clone()
    ranks = 1
    for group in groups:
        dist.all_reduce(total, group=group)
        ranks *= dist.get_world_size(group)
    return (w * nll).sum() * ranks / total


def l1_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(preds.float() - targets.float()))


def make_loss_fn(task: str, task_type: str, weight_classes: bool = True,
                 label_freqs: Optional[Sequence[float]] = None,
                 train_data_len: Optional[int] = None,
                 device=None, groups: Sequence[object] = ()
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The per-task loss ``loss_fn(logits, targets)``; class weights, when
    used, live on ``device``.  ``groups``: the ``(data, fsdp)`` process
    groups of a mesh (``sharding.dp_groups``), for a rank's share."""
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
                                                          weights, groups)
