"""Training and evaluation loops of the segmentation model.

Counterpart of ``instageo_tpu/train/trainer.py:Trainer`` for one device and
one optimizer step per batch. A step is the JAX trainer's
``_micro_grads`` + ``_train_step_body``: the train-mode forward (BatchNorm
on batch statistics, updating its running statistics; dropout from the
step's generator), the masked loss in float32, the backward, AdamW, weight
clipping, and the loss and confusion matrix accumulated on the device. The
host reads the metrics once per epoch, in ``_finalize``, under the JAX
trainer's metric names.

The configuration is a nested mapping with the JAX config's keys
(``train.learning_rate``, ``train.weight_decay``, ``train.class_weights``,
``train.ignore_index``, ``train.scheduler``, ``train.batch_size``,
``train.num_epochs``, ``model.num_classes``, ``model.freeze_backbone``,
``model.weight_clip_range``). Options of the JAX trainer that are not
ported yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.models.seg import set_dropout_generator, train_mode
from instageo_tpu_torch.train.losses import masked_cross_entropy
from instageo_tpu_torch.train.metrics import ConfusionMatrix
from instageo_tpu_torch.train.optim import (
    clip_params,
    cosine_warm_restarts,
    make_optimizer,
)

log = logging.getLogger(__name__)

# Options of the JAX trainer that this one does not take yet: (section, key,
# the value that means "off").
_NOT_PORTED = (
    ("train", "grad_accum", 1),
    ("train", "distillation", False),
    ("tpu", "steps_per_call", 1),
    (None, "is_reg_task", False),
)


def pad_batch(arrays: Sequence[np.ndarray], batch_size: int,
              label_fill: float = -100, repeat_inputs: bool = False) -> tuple:
    """Pad (inputs, labels) along the leading dim to ``batch_size``; labels
    get ``label_fill``. ``repeat_inputs`` pads the inputs by cycling the
    real samples instead of with zeros, so that train-mode BatchNorm
    statistics stay on-distribution. Returns (inputs, labels, n_real)."""
    x, y = arrays
    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad_n = batch_size - n
    if repeat_inputs and n > 0:
        x_fill = x[np.arange(pad_n) % n]
    else:
        x_fill = np.zeros((pad_n,) + x.shape[1:], x.dtype)
    x_pad = np.concatenate([x, x_fill], axis=0)
    y_pad = np.concatenate([y, np.full((pad_n,) + y.shape[1:], label_fill, y.dtype)],
                           axis=0)
    return x_pad, y_pad, n


def _get(cfg: Mapping, section: Optional[str], key: str, default=None):
    node = cfg if section is None else (cfg.get(section) or {})
    value = node.get(key, default)
    return default if value is None else value


class EpochMetrics:
    """Device-side accumulators of one epoch: the loss sum, the number of
    batches and the confusion matrix."""

    def __init__(self, num_classes: int, device: torch.device) -> None:
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        self.batches = 0
        self.cm = ConfusionMatrix(max(num_classes, 2), device=device)

    @torch.no_grad()
    def update(self, logits: torch.Tensor, labels: torch.Tensor, loss: torch.Tensor,
               ignore_index: int) -> None:
        self.loss_sum += loss.detach().float()
        self.batches += 1
        self.cm.update(labels, logits.argmax(dim=1), ignore_index=ignore_index)


class Trainer:
    """Trains ``model`` (a ``PrithviSeg`` with float32 parameters) on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, cfg: Mapping, model: nn.Module, device=None,
                 steps_per_epoch: int = 1) -> None:
        for section, key, off in _NOT_PORTED:
            if _get(cfg, section, key, off) != off:
                raise NotImplementedError(
                    f"{section + '.' if section else ''}{key} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.num_classes = int(_get(cfg, "model", "num_classes", 2))
        self.ignore_index = int(_get(cfg, "train", "ignore_index", -100))
        cw = _get(cfg, "train", "class_weights")
        # On the device once: a copy from a host list every step would
        # synchronise the host with the card.
        self.class_weights = (torch.tensor(list(cw), dtype=torch.float32, device=self.device)
                              if cw else None)
        self.clip_range = _get(cfg, "model", "weight_clip_range")
        lr = float(_get(cfg, "train", "learning_rate", 1e-4))
        self.optimizer = make_optimizer(
            model, lr, float(_get(cfg, "train", "weight_decay", 1e-2)),
            freeze_backbone=bool(_get(cfg, "model", "freeze_backbone", False)))
        self.schedule = (cosine_warm_restarts(lr, steps_per_epoch)
                         if _get(cfg, "train", "scheduler", False) else None)
        self.step = 0

    # -- one step ------------------------------------------------------------

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return masked_cross_entropy(logits, labels, self.ignore_index, self.class_weights)

    def train_step(self, x: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator,
                   metrics: Optional[EpochMetrics] = None) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on the
        device, not synchronised). Dropout draws its seeds from
        ``generator`` (a CPU generator)."""
        model = train_mode(self.model, generator)
        logits = model(x)
        loss = self._loss(logits, labels)
        model.zero_grad(set_to_none=True)
        loss.backward()
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        clip_params(model, self.clip_range)
        self.step += 1
        if metrics is not None:
            metrics.update(logits, labels, loss, self.ignore_index)
        return loss.detach()

    # -- epochs --------------------------------------------------------------

    def prepare_batch(self, x, y, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad a host batch to ``batch_size`` (inputs by repeating real
        samples, labels with ``ignore_index``), cast the inputs to the
        model's compute dtype on the host, and move both to the device."""
        x, y = np.asarray(x), np.asarray(y)
        target = max(batch_size, x.shape[0])
        x, y, _ = pad_batch((x, y), target, self.ignore_index, repeat_inputs=True)
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        dtype = getattr(self.model, "dtype", torch.float32)
        if dtype == torch.bfloat16:
            # The model computes in bf16 anyway; the cast halves the bytes
            # moved to the device.
            xt = xt.to(dtype)
        yt = torch.from_numpy(np.ascontiguousarray(y)).long()
        return xt.to(self.device), yt.to(self.device)

    def run_train_epoch(self, batches: Iterable, generator: torch.Generator,
                        batch_size: int) -> Dict:
        """One pass over ``batches`` of host (x, y); each step's dropout
        seeds come from a generator seeded from ``generator``."""
        metrics = EpochMetrics(self.num_classes, self.device)
        for x, y in batches:
            x, y = self.prepare_batch(x, y, batch_size)
            seed = int(torch.randint(0, 2**63 - 1, (), generator=generator))
            self.train_step(x, y, torch.Generator().manual_seed(seed), metrics)
        return self._finalize(metrics, "train")

    @torch.no_grad()
    def run_eval_epoch(self, batches: Iterable, batch_size: int,
                       step_type: str = "val") -> Dict:
        """Eval-mode forward, loss and metrics over ``batches`` (no AUC)."""
        model = self.model.eval()
        set_dropout_generator(model, None)
        metrics = EpochMetrics(self.num_classes, self.device)
        for x, y in batches:
            x, y = self.prepare_batch(x, y, batch_size)
            logits = model(x)
            metrics.update(logits, y, self._loss(logits, y), self.ignore_index)
        return self._finalize(metrics, step_type)

    def _finalize(self, metrics: EpochMetrics, step_type: str) -> Dict:
        """One host transfer per epoch; the JAX trainer's metric names."""
        out: Dict = {f"{step_type}_loss": metrics.loss_sum.item() / (metrics.batches or 1)}
        m = metrics.cm.compute()
        out.update({
            f"{step_type}_Acc": m["accuracy"],
            f"{step_type}_IoU": m["jaccard"],
            f"{step_type}_F1": m["f1"],
            f"{step_type}_Precision": m["precision"],
            f"{step_type}_Recall": m["recall"],
        })
        for idx, v in enumerate(m["jaccard_per_class"][: self.num_classes]):
            out[f"{step_type}_IoU_{idx}"] = v
        for idx, v in enumerate(m["f1_per_class"][: self.num_classes]):
            out[f"{step_type}_F1_{idx}"] = v
        return out

    def fit(self, train_loader: Callable, val_loader: Callable, checkpointer=None,
            seed: int = 1042) -> Dict:
        """``train.num_epochs`` epochs of training and validation; returns
        the last epoch's metrics. The dropout stream follows ``seed``."""
        if checkpointer is not None:
            raise NotImplementedError("checkpointing is not ported yet")
        num_epochs = int(_get(self.cfg, "train", "num_epochs", 1))
        batch_size = int(_get(self.cfg, "train", "batch_size", 8))
        generator = torch.Generator().manual_seed(seed)
        history: Dict = {}
        for epoch in range(num_epochs):
            t0 = time.time()
            train_m = self.run_train_epoch(train_loader(), generator, batch_size)
            val_m = self.run_eval_epoch(val_loader(), batch_size, "val")
            history = {**train_m, **val_m, "epoch": epoch,
                       "epoch_time_s": time.time() - t0}
            log.info("epoch %d: %s", epoch, history)
        return history

    def restore(self, ckpt_path: str) -> None:
        raise NotImplementedError("checkpoint restore is not ported yet")
