"""Regression diagnostics: the prediction-vs-truth density plot.

Counterpart of ``instageo_tpu/train/plots.py``: a hexbin joint density with
marginal histograms and the regression metrics, written as a PNG. It draws
with matplotlib, imported when a plot is asked for; where matplotlib is
missing, ``model.plot_reg_results`` is refused with an error naming it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def require_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend, or an ImportError naming
    matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("model.plot_reg_results draws through matplotlib, which is not "
                          "installed; unset it or install matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def create_regression_plot(
    preds: np.ndarray,
    labels: np.ndarray,
    metrics: Dict[str, float],
    out_path: str,
    step_type: str = "val",
) -> Optional[str]:
    """Joint density of predictions vs ground truth with the metrics'
    annotations, written to ``out_path``; None for no predictions."""
    plt = require_matplotlib()
    from matplotlib.gridspec import GridSpec

    preds = np.asarray(preds).ravel()
    labels = np.asarray(labels).ravel()
    if preds.size == 0:
        return None

    fig = plt.figure(figsize=(8, 8))
    gs = GridSpec(4, 4, figure=fig, hspace=0.05, wspace=0.05)
    ax_main = fig.add_subplot(gs[1:, :3])
    ax_top = fig.add_subplot(gs[0, :3], sharex=ax_main)
    ax_right = fig.add_subplot(gs[1:, 3], sharey=ax_main)

    hb = ax_main.hexbin(labels, preds, gridsize=50, cmap="viridis", mincnt=1, bins="log")
    lo = min(labels.min(), preds.min())
    hi = max(labels.max(), preds.max())
    ax_main.plot([lo, hi], [lo, hi], "r--", lw=1, label="y = x")
    ax_main.set_xlabel("Ground truth")
    ax_main.set_ylabel("Prediction")
    ax_main.legend(loc="upper left")
    fig.colorbar(hb, ax=ax_right, fraction=0.3)

    ax_top.hist(labels, bins=60, color="#3b82f6", alpha=0.7)
    ax_top.axis("off")
    ax_right.hist(preds, bins=60, orientation="horizontal", color="#f59e0b", alpha=0.7)
    ax_right.axis("off")

    annot = "\n".join(
        f"{k.split('_', 1)[-1]}: {v:.4f}"
        for k, v in metrics.items()
        if isinstance(v, float) and any(s in k for s in ("RMSE", "MAE", "R2", "Pearson")))
    ax_main.text(0.98, 0.02, annot, transform=ax_main.transAxes, ha="right", va="bottom",
                 fontsize=10, bbox=dict(facecolor="white", alpha=0.8))
    fig.suptitle(f"{step_type} predictions vs ground truth")

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
