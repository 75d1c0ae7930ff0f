"""Dataset statistics (``mode=stats``): mean/std/class weights.

The port's copy of ``instageo_tpu/train/stats.py`` (numpy): per-band mean
and per-band average of batch variances (not the pooled variance), class
weights ``total/(n_classes·count)`` with the ignored and negative labels
left out.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


def compute_class_weights(counts: Dict[int, int]) -> List[float]:
    total = sum(counts.values())
    num_classes = len(counts)
    weights = {cls: total / (num_classes * cnt) for cls, cnt in counts.items()}
    out = [0.0] * (int(max(counts.keys())) + 1)
    for cls, w in weights.items():
        out[int(cls)] = w
    return out


def compute_stats(
    data_loader: Iterable,
    is_reg_task: bool = False,
    ignore_index: int = -1,
) -> Tuple[List[float], List[float], Optional[List[float]]]:
    """Stream over (x, y) batches; x is (B, C, T, H, W).

    ``ignore_index`` and every negative label are left out of the class
    counts: a negative key would index the weight list from the end.
    """
    mean = None
    var = None
    nb_samples = 0
    class_counts: Counter = Counter()
    for x, y in data_loader:
        x = np.asarray(x, np.float64)
        b, c = x.shape[0], x.shape[1]
        flat = x.reshape(b, c, -1)
        nb_samples += b
        batch_mean = flat.mean(axis=2).sum(axis=0)
        batch_var = flat.var(axis=2).sum(axis=0)
        mean = batch_mean if mean is None else mean + batch_mean
        var = batch_var if var is None else var + batch_var
        if not is_reg_task:
            vals, cnts = np.unique(np.asarray(y), return_counts=True)
            class_counts.update({int(v): int(c_) for v, c_ in zip(vals, cnts)})
    if nb_samples == 0:
        return [], [], None
    mean = mean / nb_samples
    std = np.sqrt(var / nb_samples)
    class_weights = None
    if not is_reg_task:
        class_counts.pop(int(ignore_index), None)
        class_counts = Counter({k: v for k, v in class_counts.items() if k >= 0})
        if class_counts:
            class_weights = compute_class_weights(dict(class_counts))
    return mean.tolist(), std.tolist(), class_weights
