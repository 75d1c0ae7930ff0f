"""Training and evaluation loops of the segmentation and regression model.

Counterpart of ``instageo_tpu/train/trainer.py:Trainer`` for one device and
one optimizer step per batch. A step is the JAX trainer's
``_micro_grads`` + ``_train_step_body``: the train-mode forward (BatchNorm
on batch statistics, updating its running statistics; dropout from the
step's generator), the masked loss in float32 (weighted cross entropy, or
MSE under ``is_reg_task``, plus the distillation term against a frozen
teacher), the backward, AdamW, weight clipping, and the loss and metrics
accumulated on the device. ``train.grad_accum`` splits a batch into
sequential micro-batches with one optimizer step. The host reads the
metrics once per epoch, in ``_finalize``, under the JAX trainer's names.
``fit`` keeps the best checkpoint (``val_IoU`` max, ``val_RMSE`` min) and
``restore`` resumes from one.

The configuration is a nested mapping with the JAX config's keys
(``train.*``, ``model.*``, ``is_reg_task``, ``tpu.steps_per_call``).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.data.dataloader import epoch_seed
from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.models.seg import set_dropout_generator, train_mode
from instageo_tpu_torch.train.checkpointing import load_best_metric, load_checkpoint
from instageo_tpu_torch.train.factory import check_tpu_config
from instageo_tpu_torch.train.losses import (
    kl_distillation_loss,
    masked_cross_entropy,
    masked_mse,
    mse_distillation_loss,
)
from instageo_tpu_torch.train.metrics import AucHistogram, ConfusionMatrix, RegressionStats
from instageo_tpu_torch.train.optim import (
    clip_params,
    cosine_warm_restarts,
    make_optimizer,
)

log = logging.getLogger(__name__)


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


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The dropout stream of one epoch: a CPU generator seeded from (seed,
    epoch), so a resumed run draws what an unbroken one would."""
    return torch.Generator().manual_seed(epoch_seed(seed, epoch))


class EpochMetrics:
    """Device-side accumulators of one epoch: the loss sum, the number of
    batches, and the confusion matrix (and AUC histograms on test epochs)
    or the regression sums."""

    def __init__(self, num_classes: int, device: torch.device, is_reg: bool = False,
                 with_auc: bool = False) -> None:
        self.loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        self.batches = 0
        c = max(num_classes, 2)
        self.reg = RegressionStats(device=device) if is_reg else None
        self.cm = None if is_reg else ConfusionMatrix(c, device=device)
        self.auc = AucHistogram(c, device=device) if with_auc and not is_reg else None


class Trainer:
    """Trains ``model`` (a ``PrithviSeg`` with float32 parameters) on
    ``device`` (``cuda`` unless the caller asks for the CPU). ``teacher``:
    the frozen distillation teacher (``factory.build_teacher``), used when
    ``train.distillation`` is set."""

    def __init__(self, cfg: Mapping, model: nn.Module, device=None,
                 steps_per_epoch: int = 1, teacher: Optional[nn.Module] = None) -> None:
        check_tpu_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model
        self.is_reg = bool(_get(cfg, None, "is_reg_task", False))
        self.num_classes = int(_get(cfg, "model", "num_classes", 2))
        self.ignore_index = int(_get(cfg, "train", "ignore_index", -100))
        cw = _get(cfg, "train", "class_weights")
        # On the device once: a copy from a host list every step would
        # synchronise the host with the card.
        self.class_weights = (torch.tensor(list(cw), dtype=torch.float32, device=self.device)
                              if cw else None)
        self.clip_range = _get(cfg, "model", "weight_clip_range")
        self.use_log_scale = bool(_get(cfg, "model", "use_log_scale", False))
        self.include_ee = bool(_get(cfg, "model", "include_ee_metric", False))
        self.distillation = bool(_get(cfg, "train", "distillation", False))
        self.teacher = teacher
        self.grad_accum = max(1, int(_get(cfg, "train", "grad_accum", 1)))
        self.monitor = "val_RMSE" if self.is_reg else "val_IoU"
        self.monitor_mode = "min" if self.is_reg else "max"
        self.best_metric = float("inf") if self.is_reg else -float("inf")
        lr = float(_get(cfg, "train", "learning_rate", 1e-4))
        self.optimizer = make_optimizer(
            model, lr, float(_get(cfg, "train", "weight_decay", 1e-2)),
            freeze_backbone=bool(_get(cfg, "model", "freeze_backbone", False)))
        self.schedule = (cosine_warm_restarts(lr, steps_per_epoch)
                         if _get(cfg, "train", "scheduler", False) else None)
        self.step = 0
        self.epoch = 0  # epochs completed, restored with the checkpoint

    # -- one step ------------------------------------------------------------

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor,
              teacher_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.is_reg:
            preds = logits[:, 0]
            loss = masked_mse(preds, labels, float(self.ignore_index), self.use_log_scale)
            if teacher_logits is not None:
                loss = loss + mse_distillation_loss(
                    preds, teacher_logits[:, 0], labels, float(self.ignore_index))
            return loss
        loss = masked_cross_entropy(logits, labels, self.ignore_index, self.class_weights)
        if teacher_logits is not None:
            loss = loss + kl_distillation_loss(logits, teacher_logits, labels,
                                               self.ignore_index)
        return loss

    @torch.no_grad()
    def _teacher_logits(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        if not (self.distillation and self.teacher is not None):
            return None
        return self.teacher(x)

    @torch.no_grad()
    def _update_metrics(self, metrics: EpochMetrics, logits: torch.Tensor,
                        labels: torch.Tensor, loss: torch.Tensor) -> None:
        metrics.loss_sum += loss.detach().float()
        metrics.batches += 1
        if self.is_reg:
            preds = logits[:, 0].float()
            labels_f = labels.float()
            if self.use_log_scale:
                preds = torch.expm1(preds)
            metrics.reg.update(labels_f, preds, labels_f != float(self.ignore_index))
            return
        metrics.cm.update(labels, logits.argmax(dim=1), ignore_index=self.ignore_index)
        if metrics.auc is not None:
            probs = torch.softmax(logits.float(), dim=1)
            labels_flat = labels.reshape(-1)
            metrics.auc.update(labels_flat, probs.permute(0, 2, 3, 1).reshape(-1, probs.shape[1]),
                               valid=labels_flat != self.ignore_index)

    def _micro_backward(self, x: torch.Tensor, labels: torch.Tensor,
                        metrics: Optional[EpochMetrics]) -> torch.Tensor:
        """``train.grad_accum`` = a > 1: the batch splits into a sequential
        micro-batches, one forward and backward each, gradients added into
        ``.grad``. Each micro-batch's gradient is weighted by its share of
        the batch's valid pixels (every loss is a mean over valid pixels,
        so this is the whole batch's gradient even when padding gathers in
        the last micro-batches). BatchNorm updates per micro-batch; each
        micro-batch counts as one metrics batch, its loss scaled by
        w_i·a/Σw. Returns the valid-weighted mean loss."""
        a = self.grad_accum
        if x.shape[0] % a:
            raise ValueError(f"batch of {x.shape[0]} does not split into "
                             f"train.grad_accum={a} micro-batches")
        m = x.shape[0] // a
        ign = float(self.ignore_index) if self.is_reg else self.ignore_index
        w = (labels != ign).reshape(a, -1).sum(dim=1).float()
        w_total = w.sum().clamp_min(1.0)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(a):
            xb, yb = x[i * m:(i + 1) * m], labels[i * m:(i + 1) * m]
            logits = self.model(xb)
            loss = self._loss(logits, yb, self._teacher_logits(xb))
            (loss * (w[i] / w_total)).backward()
            total += loss.detach() * (w[i] / w_total)
            if metrics is not None:
                self._update_metrics(metrics, logits, yb, loss.detach() * w[i] * a / w_total)
        return total

    def train_step(self, x: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator,
                   metrics: Optional[EpochMetrics] = None) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on the
        device, not synchronised). Dropout draws its seeds from
        ``generator`` (a CPU generator)."""
        model = train_mode(self.model, generator)
        model.zero_grad(set_to_none=True)
        if self.grad_accum > 1:
            loss = self._micro_backward(x, labels, metrics)
        else:
            logits = model(x)
            loss = self._loss(logits, labels, self._teacher_logits(x))
            loss.backward()
            if metrics is not None:
                self._update_metrics(metrics, logits, labels, loss)
        if self.schedule is not None:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        clip_params(model, self.clip_range)
        self.step += 1
        return loss.detach()

    # -- epochs --------------------------------------------------------------

    def prepare_batch(self, x, y, batch_size: int, accum: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch (arrays or CPU tensors) on the device: padded to
        ``batch_size`` rounded up to a multiple of ``accum`` micro-batches
        (``train.grad_accum`` by default; eval passes 1) by repeating real
        inputs and filling labels with ``ignore_index``; inputs in the
        model's compute dtype, labels int64 (float32 for regression).
        Pinned tensors are copied without blocking the host; pageable bf16
        inputs are cast on the host, which halves the bytes copied."""
        accum = self.grad_accum if accum is None else max(1, int(accum))
        n = x.shape[0]
        target = -(-max(batch_size, n) // accum) * accum
        if n != target:
            fill = float(self.ignore_index) if self.is_reg else self.ignore_index
            x, y, _ = pad_batch((np.asarray(x), np.asarray(y)), target, fill,
                                repeat_inputs=True)
        xt = torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32)
                             if isinstance(x, np.ndarray) else x)
        yt = torch.as_tensor(y)
        dtype = getattr(self.model, "dtype", torch.float32)
        if dtype == torch.bfloat16 and not xt.is_pinned():
            xt = xt.to(dtype)
        xt = xt.to(self.device, non_blocking=True).to(dtype)
        yt = yt.to(self.device, non_blocking=True)
        return xt, (yt.float() if self.is_reg else yt.long())

    def run_train_epoch(self, batches: Iterable, generator: torch.Generator,
                        batch_size: int) -> Dict:
        """One pass over ``batches`` of host (x, y); each step's dropout
        seeds come from a generator seeded from ``generator``."""
        metrics = EpochMetrics(self.num_classes, self.device, self.is_reg)
        for x, y in batches:
            x, y = self.prepare_batch(x, y, batch_size)
            seed = int(torch.randint(0, 2**63 - 1, (), generator=generator))
            self.train_step(x, y, torch.Generator().manual_seed(seed), metrics)
        return self._finalize(metrics, "train")

    @torch.no_grad()
    def run_eval_epoch(self, batches: Iterable, batch_size: int,
                       step_type: str = "val", collect_outputs: bool = False) -> Dict:
        """Eval-mode forward, loss and metrics over ``batches`` (AUC on
        ``test`` epochs of a segmentation task). ``collect_outputs`` (a
        regression task) adds the valid predictions and labels as
        ``_preds`` / ``_labels``."""
        model = self.model.eval()
        set_dropout_generator(model, None)
        with_auc = step_type == "test" and not self.is_reg
        metrics = EpochMetrics(self.num_classes, self.device, self.is_reg, with_auc)
        collected_p, collected_y = [], []
        for x, y in batches:
            n_real = x.shape[0]
            x, y = self.prepare_batch(x, y, batch_size, accum=1)
            logits = model(x)
            self._update_metrics(metrics, logits, y, self._loss(logits, y))
            if collect_outputs and self.is_reg:
                preds = logits[:n_real, 0].float()
                if self.use_log_scale:
                    preds = torch.expm1(preds)
                labels = y[:n_real]
                valid = labels != float(self.ignore_index)
                collected_p.append(preds[valid].cpu().numpy())
                collected_y.append(labels[valid].cpu().numpy())
        out = self._finalize(metrics, step_type)
        if collect_outputs and collected_p:
            out["_preds"] = np.concatenate(collected_p)
            out["_labels"] = np.concatenate(collected_y)
        return out

    def _finalize(self, metrics: EpochMetrics, step_type: str) -> Dict:
        """One host transfer per epoch; the JAX trainer's metric names."""
        out: Dict = {f"{step_type}_loss": metrics.loss_sum.item() / (metrics.batches or 1)}
        if self.is_reg:
            m = metrics.reg.compute(include_ee=self.include_ee)
            out.update({
                f"{step_type}_RMSE": m["rmse"],
                f"{step_type}_MAE": m["mae"],
                f"{step_type}_R2": m["r2_score"],
                f"{step_type}_Pearson": m["pearson_corrcoef"],
            })
            if m["ee_percentage"] is not None:
                out[f"{step_type}_EE_Percentage"] = m["ee_percentage"]
            return out
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
        if metrics.auc is not None:
            out[f"{step_type}_roc_auc"] = metrics.auc.score()["roc_auc_macro"]
        return out

    # -- fit, test, checkpoints ------------------------------------------------

    def fit(self, train_loader: Callable, val_loader: Callable, checkpointer=None,
            seed: int = 1042, log_fn: Optional[Callable] = None) -> Dict:
        """``train.num_epochs`` epochs of training and validation; returns
        the last epoch's metrics. Epoch e's dropout stream comes from (seed,
        e), e counting the epochs of a restored run too. Saves through
        ``checkpointer`` when the monitored metric improves (NaN never
        does)."""
        num_epochs = int(_get(self.cfg, "train", "num_epochs", 1))
        batch_size = int(_get(self.cfg, "train", "batch_size", 8))
        history: Dict = {}
        for epoch in range(num_epochs):
            t0 = time.time()
            train_m = self.run_train_epoch(train_loader(), epoch_generator(seed, self.epoch),
                                           batch_size)
            val_m = self.run_eval_epoch(val_loader(), batch_size, "val")
            self.epoch += 1
            history = {**train_m, **val_m, "epoch": epoch,
                       "epoch_time_s": time.time() - t0}
            if log_fn:
                log_fn(history)
            log.info("epoch %d: %s", epoch, history)
            score = val_m.get(self.monitor)
            improved = (score is not None and not np.isnan(score)
                        and ((score > self.best_metric) if self.monitor_mode == "max"
                             else (score < self.best_metric)))
            if improved:
                self.best_metric = score
                if checkpointer is not None:
                    checkpointer.save(self.state_dict(), metrics=history)
        return history

    def test(self, test_loader: Callable, batch_size: Optional[int] = None) -> Dict:
        batch_size = batch_size or int(_get(self.cfg, "train", "batch_size", 8))
        return self.run_eval_epoch(test_loader(), batch_size, "test")

    def state_dict(self) -> Dict[str, Any]:
        """What a checkpoint holds: model, optimizer, step and epoch."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step, "epoch": self.epoch}

    def restore(self, ckpt_path: str) -> None:
        """Resume from a checkpoint directory written by ``BestCheckpointer``:
        step, epoch, parameters, BatchNorm statistics, AdamW moments, and
        ``best_metric`` from the sidecar, so that a worse epoch after the
        resume does not overwrite the better checkpoint. The schedule goes
        on from the restored step."""
        state = load_checkpoint(ckpt_path)
        self.model.load_state_dict(state["model"], strict=True)
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))
        best = load_best_metric(ckpt_path, self.monitor)
        if best is not None:
            self.best_metric = best
