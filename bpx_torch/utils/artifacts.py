"""Prediction / gate artifact dumps (counterpart:
``bpx/utils/artifacts.py``).

Writes ``test_labels_pred.txt`` / ``test_labels_gold.txt`` /
``test_labels.txt`` / ``preds_raw.npy`` / ``gates.npy`` with the same names
and formats as the JAX package, so analysis tooling reads either run.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def store_preds_to_disk(tgts: np.ndarray, preds: np.ndarray,
                        savedir: str, labels: Sequence,
                        task_type: str,
                        preds_raw: Optional[np.ndarray] = None,
                        gates: Optional[np.ndarray] = None) -> None:
    os.makedirs(savedir, exist_ok=True)

    def fmt_rows(arr):
        if task_type == "multilabel":
            return [" ".join(str(int(x)) for x in row) for row in arr]
        return [str(x) for x in np.asarray(arr).reshape(-1)]

    with open(os.path.join(savedir, "test_labels_pred.txt"), "w") as f:
        f.write("\n".join(fmt_rows(preds)))
    with open(os.path.join(savedir, "test_labels_gold.txt"), "w") as f:
        f.write("\n".join(fmt_rows(tgts)))
    with open(os.path.join(savedir, "test_labels.txt"), "w") as f:
        f.write(" ".join(str(l) for l in labels))
    if preds_raw is not None:
        np.save(os.path.join(savedir, "preds_raw.npy"), preds_raw)
    if gates is not None:
        np.save(os.path.join(savedir, "gates.npy"), gates)
