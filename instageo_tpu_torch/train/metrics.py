"""Streaming metrics, accumulated on the device.

Counterparts of ``instageo_tpu/train/metrics.py``'s ``ConfusionMatrix``,
``AucHistogram`` and ``RegressionStats``. The JAX package counts in two
float32 words because the TPU lacks a fast int64 scatter; here counts are
exact int64 (``index_add_``) and the regression sums float64, updated in
place with no host synchronisation until ``compute()``/``score()``, so an
update can be recorded into a CUDA graph. ``zero_()`` empties an
accumulator in place. The masking rules and the final formulas are the JAX
package's.

``RunningConfusionMatrix``, ``RunningAUC`` and ``RunningRegressionMetrics``
are the JAX package's host-side API (numpy or tensors on the host in, the
reference's dicts out) over the same accumulators on the CPU: one copy of
the math.
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

    @classmethod
    def empty(cls, num_classes: int, device=None) -> "ConfusionMatrix":
        return cls(num_classes, device=device)

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

    def merge(self, other: "ConfusionMatrix") -> "ConfusionMatrix":
        """Add ``other``'s counts into this accumulator."""
        self.matrix += other.matrix.to(self.matrix.device)
        self.total += other.total.to(self.total.device)
        return self

    def zero_(self) -> "ConfusionMatrix":
        self.matrix.zero_()
        self.total.zero_()
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


class AucHistogram:
    """One-vs-rest ROC-AUC from (C, n_bins) histograms of each class's
    score, split by whether the pixel's label is that class."""

    def __init__(self, num_classes: int, n_bins: int = 1024, device=None) -> None:
        self.num_classes, self.n_bins = num_classes, n_bins
        self.pos_hist = torch.zeros((num_classes, n_bins), dtype=torch.int64, device=device)
        self.neg_hist = torch.zeros((num_classes, n_bins), dtype=torch.int64, device=device)

    @classmethod
    def empty(cls, num_classes: int, n_bins: int = 1024, device=None) -> "AucHistogram":
        return cls(num_classes, n_bins, device=device)

    def update(self, y_true: torch.Tensor, y_score: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> "AucHistogram":
        """y_true (N,), y_score (N, C) probabilities; ``valid`` (N,) masks
        pixels out. Bin = floor(clip(score, 0, 1)·(n_bins − 1)), in float64
        for float64 scores, else in float32."""
        c, nb = self.num_classes, self.n_bins
        y = y_true.reshape(-1).long()
        scores = y_score.reshape(-1, c)
        if scores.dtype != torch.float64:
            scores = scores.float()
        bins = torch.floor(scores.clamp(0.0, 1.0) * (nb - 1)).long()
        cell = bins + torch.arange(c, device=bins.device) * nb  # (N, C)
        is_c = y[:, None] == torch.arange(c, device=y.device)
        ok = (torch.ones_like(y, dtype=torch.bool) if valid is None
              else valid.reshape(-1).bool())[:, None]
        spill = c * nb  # masked pixels count into a cell past the histogram
        for hist, mask in ((self.pos_hist, is_c & ok), (self.neg_hist, ~is_c & ok)):
            idx = torch.where(mask, cell, spill).reshape(-1)
            # index_add_ and not bincount: bincount reads its input's maximum
            # back to the host on a CUDA device.
            counts = torch.zeros(spill + 1, dtype=torch.int64, device=idx.device)
            counts.index_add_(0, idx, torch.ones_like(idx))
            hist += counts[:-1].view(c, nb)
        return self

    def zero_(self) -> "AucHistogram":
        self.pos_hist.zero_()
        self.neg_hist.zero_()
        return self

    def score(self, include_per_class: bool = True) -> Dict:
        """Macro (and per-class) AUC from the cumulative histograms."""
        pos = self.pos_hist.cpu().numpy().astype(np.float64)
        neg = self.neg_hist.cpu().numpy().astype(np.float64)
        n_pos = pos.sum(axis=1)
        n_neg = neg.sum(axis=1)
        cum_neg_before = np.cumsum(neg, axis=1) - neg
        auc_num = (pos * cum_neg_before).sum(axis=1) + 0.5 * (pos * neg).sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            per_class = np.where((n_pos > 0) & (n_neg > 0), auc_num / (n_pos * n_neg), np.nan)
        macro = np.nanmean(per_class) if not np.all(np.isnan(per_class)) else float("nan")
        if include_per_class:
            return {"roc_auc_macro": macro, "roc_auc_per_class": per_class.tolist()}
        return {"roc_auc_macro": macro}


_REG_SUMS = ("n", "sum_x", "sum_y", "sum_xy", "sum_x2", "sum_y2", "sum_abs_error",
             "sum_squared_error", "within_ee_count")


class RegressionStats:
    """Sums for streaming RMSE, MAE, R², Pearson and the expected-error
    share, in float64 on the device (R² and Pearson subtract n·x̄² from
    Σx², which float32 sums would cancel catastrophically)."""

    def __init__(self, device=None) -> None:
        self.sums = torch.zeros(len(_REG_SUMS), dtype=torch.float64, device=device)

    @classmethod
    def empty(cls, device=None) -> "RegressionStats":
        return cls(device=device)

    def update(self, y_true: torch.Tensor, y_pred: torch.Tensor,
               valid: Optional[torch.Tensor] = None, ee_bias: float = 0.05,
               ee_coef: float = 0.15) -> "RegressionStats":
        x = y_true.reshape(-1).double()
        y = y_pred.reshape(-1).double()
        v = torch.ones_like(x) if valid is None else valid.reshape(-1).double()
        x, y = x * v, y * v
        abs_err = (y - x).abs()
        within = (abs_err <= ee_bias + ee_coef * x).double() * v
        self.sums += torch.stack([v.sum(), x.sum(), y.sum(), (x * y).sum(), (x * x).sum(),
                                  (y * y).sum(), (abs_err * v).sum(),
                                  (abs_err * abs_err * v).sum(), within.sum()])
        return self

    def zero_(self) -> "RegressionStats":
        self.sums.zero_()
        return self

    def compute(self, include_ee: bool = False, ee_bias: float = 0.05,
                ee_coef: float = 0.15) -> Dict:
        s = dict(zip(_REG_SUMS, self.sums.cpu().tolist()))
        return _finalize_regression(s, include_ee, ee_bias, ee_coef)


def _finalize_regression(s: Dict[str, float], include_ee: bool,
                         ee_bias: float, ee_coef: float) -> Dict:
    """The metric formulas from the raw sums."""
    n = s["n"]
    if n == 0:
        nan = float("nan")
        return {"mae": nan, "rmse": nan, "r2_score": nan,
                "pearson_corrcoef": nan, "ee_percentage": None,
                "ee_bias": ee_bias, "ee_coef": ee_coef}
    mae = s["sum_abs_error"] / n
    rmse = float(np.sqrt(s["sum_squared_error"] / n))
    x_mean = s["sum_x"] / n
    y_mean = s["sum_y"] / n
    ss_tot = s["sum_x2"] - n * x_mean * x_mean
    r2 = 1 - s["sum_squared_error"] / ss_tot if (n >= 2 and ss_tot != 0) else float("nan")
    cov = s["sum_xy"] - n * x_mean * y_mean
    std_x = np.sqrt(max(s["sum_x2"] - n * x_mean * x_mean, 0.0))
    std_y = np.sqrt(max(s["sum_y2"] - n * y_mean * y_mean, 0.0))
    pearson = cov / (std_x * std_y) if (n >= 2 and std_x and std_y) else float("nan")
    return {
        "mae": mae,
        "rmse": rmse,
        "r2_score": r2,
        "pearson_corrcoef": pearson,
        "ee_percentage": (s["within_ee_count"] / n * 100) if include_ee else None,
        "ee_bias": ee_bias,
        "ee_coef": ee_coef,
    }


# ---------------------------------------------------------------------------
# The reference's host-side API over the accumulators above
# ---------------------------------------------------------------------------


def _host(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).cpu()


class RunningConfusionMatrix:
    """Streaming confusion matrix on the host (the reference's API)."""

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None) -> None:
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.reset()

    def update(self, y_true, y_pred) -> None:
        y_true, y_pred = _host(y_true).reshape(-1), _host(y_pred).reshape(-1)
        if y_true.shape != y_pred.shape:
            raise ValueError("y_true and y_pred shapes differ.")
        self.state.update(y_true, y_pred, self.ignore_index)

    def compute(self, include_per_class: bool = True) -> Dict:
        return self.state.compute(include_per_class)

    def reset(self) -> None:
        self.state = ConfusionMatrix(self.num_classes)


class RunningAUC:
    """Streaming one-vs-rest ROC-AUC on the host (the reference's API):
    scores are mapped from [min_score, max_score] onto [0, 1] in float64."""

    def __init__(self, num_classes: int, n_bins: int = 1024,
                 min_score: float = 0.0, max_score: float = 1.0) -> None:
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.min_score = min_score
        self.max_score = max_score
        self.reset()

    def update(self, y_true, y_score) -> None:
        y_true = _host(y_true).reshape(-1)
        y_score = _host(y_score).double()
        if y_score.dim() == 1:
            if self.num_classes != 2:
                raise ValueError("For 1-D y_score, num_classes must be 2.")
            y_score = torch.stack([1 - y_score, y_score], dim=1)
        if y_true.shape[0] != y_score.shape[0]:
            raise ValueError("y_true and y_score length mismatch.")
        if y_score.shape[1] != self.num_classes:
            raise ValueError("Second dim of y_score must equal num_classes.")
        span = self.max_score - self.min_score
        norm = (y_score.clamp(self.min_score, self.max_score) - self.min_score) / span
        self.state.update(y_true, norm)

    def score(self, include_per_class: bool = True) -> Dict:
        return self.state.score(include_per_class)

    def reset(self) -> None:
        self.state = AucHistogram(self.num_classes, self.n_bins)


class RunningRegressionMetrics:
    """Streaming regression metrics on the host (the reference's API)."""

    def __init__(self, ee_bias: float = 0.05, ee_coef: float = 0.15,
                 include_ee: bool = False) -> None:
        self.ee_bias = ee_bias
        self.ee_coef = ee_coef
        self.include_ee = include_ee
        self.reset()

    def update(self, y_true, y_pred) -> None:
        y_true, y_pred = _host(y_true).reshape(-1), _host(y_pred).reshape(-1)
        if y_true.shape != y_pred.shape:
            raise ValueError("y_true and y_pred shapes differ.")
        self.state.update(y_true, y_pred, ee_bias=self.ee_bias, ee_coef=self.ee_coef)

    def compute(self) -> Dict:
        return self.state.compute(self.include_ee, self.ee_bias, self.ee_coef)

    def reset(self) -> None:
        self.state = RegressionStats()
