"""Streaming confusion matrix, accumulated on the device.

Counterpart of ``instageo_tpu/train/metrics.py:ConfusionMatrix``. The JAX
package counts in two float32 words because the TPU lacks a fast int64
scatter; here the counts are exact int64, added with one ``index_add_`` per
batch and no host synchronisation until ``compute()``. The masking rules
and the ``compute()`` formulas are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    den = np.asarray(den, dtype=float)
    out = np.zeros_like(den, dtype=float)
    np.divide(num, den, out=out, where=den != 0)
    return out


class ConfusionMatrix:
    """(C, C) counts of (true, predicted) class pairs, rows true."""

    def __init__(self, num_classes: int, device=None) -> None:
        self.num_classes = num_classes
        self.matrix = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                                  device=device)
        self.total = torch.zeros((), dtype=torch.int64, device=device)

    def update(self, y_true: torch.Tensor, y_pred: torch.Tensor,
               ignore_index: Optional[int] = None) -> "ConfusionMatrix":
        """Add a batch of any shape. Labels or predictions outside [0, C)
        and labels equal to ``ignore_index`` are not counted."""
        c = self.num_classes
        yt = y_true.reshape(-1).long()
        yp = y_pred.reshape(-1).long()
        valid = (yt >= 0) & (yt < c) & (yp >= 0) & (yp < c)
        if ignore_index is not None:
            valid &= yt != ignore_index
        # Invalid pairs go to a spill cell past the matrix.
        cell = torch.where(valid, yt * c + yp, c * c)
        counts = torch.zeros(c * c + 1, dtype=torch.int64, device=self.matrix.device)
        counts.index_add_(0, cell, torch.ones_like(cell))
        self.matrix += counts[:-1].view(c, c)
        self.total += valid.sum()
        return self

    def compute(self, include_per_class: bool = True) -> Dict:
        """Accuracy and macro precision, recall, F1 and IoU (jaccard), with
        the per-class values."""
        m = self.matrix.cpu().numpy()
        total = int(self.total.item())
        tp = np.diag(m)
        fp = m.sum(axis=0) - tp
        fn = m.sum(axis=1) - tp
        precision = _safe_div(tp, tp + fp)
        recall = _safe_div(tp, tp + fn)
        f1 = _safe_div(2 * precision * recall, precision + recall)
        jaccard = _safe_div(tp, tp + fp + fn)
        out: Dict = {
            "accuracy": tp.sum() / total if total else float("nan"),
            "precision": precision.mean(),
            "recall": recall.mean(),
            "f1": f1.mean(),
            "jaccard": jaccard.mean(),
        }
        if include_per_class:
            out.update({
                "precision_per_class": precision.tolist(),
                "recall_per_class": recall.tolist(),
                "f1_per_class": f1.tolist(),
                "jaccard_per_class": jaccard.tolist(),
            })
        return out
