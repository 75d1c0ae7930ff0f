"""Best-model checkpointing and resume.

Counterpart of ``instageo_tpu/train/checkpointing.py``: one best checkpoint
per run, ``<run_dir>/instageo_best_checkpoint`` (the reference's
``ModelCheckpoint(save_top_k=1, filename="instageo_best_checkpoint")``),
with the epoch's metrics beside it in ``instageo_best_checkpoint.metrics.json``.
The checkpoint is a directory holding ``state.pt``, written with
``torch.save``: the model's ``state_dict``, the optimizer's ``state_dict``,
the step and the epoch count. The JAX package's orbax directories are not
read here (that would need JAX); ``factory.load_finetuned`` reads the
reference's ``.ckpt`` files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

BEST_NAME = "instageo_best_checkpoint"
STATE_FILE = "state.pt"


class BestCheckpointer:
    """Keeps the single best checkpoint of a run (save_top_k=1)."""

    def __init__(self, run_dir: str, name: str = BEST_NAME) -> None:
        self.path = os.path.abspath(os.path.join(run_dir, name))
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def save(self, state: Dict[str, Any], metrics: Optional[Dict] = None) -> str:
        """Write ``state`` (``Trainer.state_dict()``) and the numeric
        ``metrics``; the file is replaced atomically."""
        os.makedirs(self.path, exist_ok=True)
        target = os.path.join(self.path, STATE_FILE)
        tmp = target + f".tmp{os.getpid()}"
        torch.save(state, tmp)
        os.replace(tmp, target)
        if metrics is not None:
            with open(self.path + ".metrics.json", "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()
                           if isinstance(v, (int, float))}, f)
        return self.path

    def restore(self, map_location="cpu") -> Dict[str, Any]:
        """The saved state, as :func:`load_checkpoint` reads it."""
        return load_checkpoint(self.path, map_location)


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """A checkpoint directory written by :class:`BestCheckpointer`, loaded
    with ``torch.load(weights_only=True)``."""
    if not os.path.isdir(path):
        raise ValueError(f"{path}: not a checkpoint directory of this package; "
                         "for a reference .ckpt use factory.load_finetuned")
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def load_best_metric(path: str, monitor: str) -> Optional[float]:
    """The monitored metric from a checkpoint's metrics sidecar, if any."""
    metrics_path = os.path.abspath(path) + ".metrics.json"
    if not os.path.exists(metrics_path):
        return None
    with open(metrics_path) as f:
        saved = json.load(f)
    return float(saved[monitor]) if monitor in saved else None
