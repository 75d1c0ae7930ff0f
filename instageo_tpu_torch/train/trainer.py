"""Training and evaluation loops of the segmentation and regression model.

Counterpart of ``instageo_tpu/train/trainer.py:Trainer`` for one device. A
step is the JAX trainer's
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

``tpu.steps_per_call`` = k > 1 (``factory.steps_per_call``; ``auto`` is 8
for the crop config at batch 8 on a card, 1 on the CPU) groups k batches,
the counterpart of the JAX trainer's scanned train and eval steps: the k
host batches go to static (k, B, ...) device buffers in one copy, with the
k steps' dropout seeds (drawn on the host as the one-step loop draws them)
and learning rates. On a CUDA device one ``CapturedGraph`` holds the k
whole steps and is replayed once per full group; the first full group runs
as ordinary steps, which warms up the libraries and AdamW's state before
the capture. On the CPU the same grouped code runs without a graph. A tail
group smaller than k, and eval epochs that collect outputs, run step by
step. Either way the run is the one-step run: the same batches, seeds and
rates in the same order.

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
from instageo_tpu_torch.models.seg import (
    Dropout,
    SeedSlots,
    draw_seed,
    set_dropout_generator,
    set_dropout_seeds,
    train_mode,
)
from instageo_tpu_torch.ops._build import CapturedGraph
from instageo_tpu_torch.train.checkpointing import load_best_metric, load_checkpoint
from instageo_tpu_torch.train.factory import check_tpu_config, steps_per_call
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
    load_optimizer_state,
    make_optimizer,
    set_learning_rate,
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

    def zero_(self) -> "EpochMetrics":
        """Empty every accumulator in place (a captured graph adds into
        these tensors)."""
        self.loss_sum.zero_()
        self.batches = 0
        for acc in (self.reg, self.cm, self.auc):
            if acc is not None:
                acc.zero_()
        return self


class _Group:
    """The static device buffers of k grouped steps of one batch shape: the
    inputs and labels (k, B, ...), the dropout seed slots, the learning
    rates (on a card), each step's loss, and the graph once captured.
    Everything a graph reads or writes is allocated before its capture."""

    def __init__(self, k: int, x: torch.Tensor, y: torch.Tensor, device: torch.device,
                 seeds_per_step: int, x_dtype: torch.dtype, y_dtype: torch.dtype) -> None:
        self.k = k
        self.xs = torch.empty((k,) + tuple(x.shape), dtype=x_dtype, device=device)
        self.ys = torch.empty((k,) + tuple(y.shape), dtype=y_dtype, device=device)
        # The k host batches as they come (float32 inputs), pinned on a card:
        # one host copy each, then one device copy that casts.
        pin = device.type == "cuda"
        self.stage_x = torch.empty(self.xs.shape, dtype=x.dtype, pin_memory=pin)
        self.stage_y = torch.empty(self.ys.shape, dtype=y.dtype, pin_memory=pin)
        self.staged: Optional[torch.cuda.Event] = None
        self.seeds = SeedSlots(k * seeds_per_step, device)
        self.seeds_per_step = seeds_per_step
        self.lrs = torch.zeros(k, dtype=torch.float32, device=device)
        self.lr_values: list = [None] * k
        self.losses = torch.zeros(k, dtype=torch.float32, device=device)
        self.warm = not pin  # a card runs the first group as plain steps
        self.graph: Optional[CapturedGraph] = None


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
        in_chans = int(getattr(getattr(model, "arch", None), "in_chans", 6))
        self._auto_spc = str((cfg.get("tpu") or {}).get("steps_per_call", 1)) == "auto"
        self.steps_per_call = steps_per_call(cfg, self.device.type, in_chans)
        self._spc_args = (cfg, self.device.type, in_chans)
        # Grouped steps: static buffers and graphs per (kind, shapes), and
        # the epoch accumulators that the graphs add into, per kind.
        self._groups: Dict[tuple, _Group] = {}
        self._group_metrics: Dict[tuple, EpochMetrics] = {}

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

    def _step_body(self, x: torch.Tensor, labels: torch.Tensor,
                   metrics: Optional[EpochMetrics]) -> torch.Tensor:
        """One optimizer step's device work, with the rate already set:
        forward, loss, backward, AdamW, clipping, the metrics. Nothing in it
        reads back to the host, so a CUDA graph can hold it."""
        model = self.model
        model.zero_grad(set_to_none=True)
        if self.grad_accum > 1:
            loss = self._micro_backward(x, labels, metrics)
        else:
            logits = model(x)
            loss = self._loss(logits, labels, self._teacher_logits(x))
            loss.backward()
            if metrics is not None:
                self._update_metrics(metrics, logits, labels, loss)
        self.optimizer.step()
        clip_params(model, self.clip_range)
        return loss.detach()

    def train_step(self, x: torch.Tensor, labels: torch.Tensor,
                   generator: torch.Generator,
                   metrics: Optional[EpochMetrics] = None) -> torch.Tensor:
        """One optimizer step on a device batch; returns the loss (on the
        device, not synchronised). Dropout draws its seeds from
        ``generator`` (a CPU generator)."""
        train_mode(self.model, generator)
        if self.schedule is not None:
            set_learning_rate(self.optimizer, self.schedule(self.step))
        loss = self._step_body(x, labels, metrics)
        if metrics is not None:
            metrics.batches += self.grad_accum
        self.step += 1
        return loss

    # -- epochs --------------------------------------------------------------

    def prepare_batch(self, x, y, batch_size: int, accum: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch on the device, padded as ``_host_batch`` pads it;
        inputs in the model's compute dtype, labels int64 (float32 for
        regression). Pinned tensors are copied without blocking the host;
        pageable bf16 inputs are cast on the host, which halves the bytes
        copied."""
        xt, yt = self._host_batch(x, y, batch_size, accum)
        dtype = getattr(self.model, "dtype", torch.float32)
        if dtype == torch.bfloat16 and not xt.is_pinned():
            xt = xt.to(dtype)
        xt = xt.to(self.device, non_blocking=True).to(dtype)
        yt = yt.to(self.device, non_blocking=True)
        return xt, (yt.float() if self.is_reg else yt.long())

    def _k_for(self, batch_size: int) -> int:
        """Steps per group this epoch: ``auto`` re-clamped for the batch
        size in effect (eval may pass a larger one), an integer as given."""
        if self.steps_per_call > 1 and self._auto_spc:
            return min(self.steps_per_call, steps_per_call(*self._spc_args, batch_size))
        return self.steps_per_call

    def _host_batch(self, x, y, batch_size: int, accum: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host batch (arrays or CPU tensors) as CPU tensors, float32
        inputs and the labels' dtype: padded to ``batch_size`` rounded up to
        a multiple of ``accum`` micro-batches (``train.grad_accum`` by
        default; eval passes 1) by repeating real inputs and filling labels
        with ``ignore_index``. A float32 tensor stays as it is (pinned
        memory stays pinned)."""
        accum = self.grad_accum if accum is None else max(1, int(accum))
        n = x.shape[0]
        target = -(-max(batch_size, n) // accum) * accum
        if n != target:
            fill = float(self.ignore_index) if self.is_reg else self.ignore_index
            x, y, _ = pad_batch((np.asarray(x), np.asarray(y)), target, fill,
                                repeat_inputs=True)
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x, dtype=np.float32)
        return torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(y)

    def _group_for(self, kind: str, k: int, x: torch.Tensor, y: torch.Tensor,
                   seeds_per_step: int) -> _Group:
        key = (kind, k, tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        group = self._groups.get(key)
        if group is None:
            group = self._groups[key] = _Group(
                k, x, y, self.device, seeds_per_step,
                getattr(self.model, "dtype", torch.float32),
                torch.float32 if self.is_reg else torch.int64)
        return group

    def _epoch_metrics(self, kind: str, with_auc: bool = False) -> EpochMetrics:
        """The accumulators of a grouped epoch, emptied: one object per kind
        for the trainer's life, since graphs add into its tensors."""
        key = (kind, with_auc)
        if key not in self._group_metrics:
            self._group_metrics[key] = EpochMetrics(self.num_classes, self.device,
                                                    self.is_reg, with_auc)
        return self._group_metrics[key].zero_()

    def _to_device(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """One host-to-device copy that does not wait for the device: from
        pinned memory on a card."""
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def _stage(self, group: _Group, host: list) -> None:
        """The k host batches into the group's buffers: into its host stage
        (on a card, once the previous group's copy from it is done), then one
        copy each for the inputs and the labels, cast to the compute and label
        dtypes on the device."""
        if group.staged is not None:
            group.staged.synchronize()
        for j, (x, y) in enumerate(host):
            group.stage_x[j].copy_(x)
            group.stage_y[j].copy_(y)
        group.xs.copy_(group.stage_x, non_blocking=True)
        group.ys.copy_(group.stage_y, non_blocking=True)
        if self.device.type == "cuda":
            group.staged = torch.cuda.Event()
            group.staged.record()

    def _seeds_per_step(self) -> int:
        """Dropout seeds one train step draws: one per drawing ``Dropout``
        call, once per micro-batch."""
        calls = sum(1 for m in self.model.modules() if isinstance(m, Dropout) and 0 < m.p < 1)
        return calls * self.grad_accum

    def _train_group_body(self, group: _Group) -> torch.Tensor:
        """The k steps of a group from its buffers: each takes its rate from
        ``lrs`` (a card) or ``lr_values`` (the CPU) and its dropout seeds
        from the next slots; each loss goes to ``losses``. A CUDA graph
        captures exactly this."""
        group.seeds.taken = 0
        set_dropout_seeds(self.model.train(), group.seeds)
        metrics = self._group_metrics[("train", False)]
        for j in range(group.k):
            if self.schedule is not None:
                set_learning_rate(self.optimizer, group.lrs[j] if self.device.type == "cuda"
                                  else group.lr_values[j])
            group.losses[j].copy_(self._step_body(group.xs[j], group.ys[j], metrics))
        if group.seeds.taken != group.seeds.buffer.numel():
            raise RuntimeError(f"a group of {group.k} steps took {group.seeds.taken} dropout "
                               f"seeds, expected {group.seeds.buffer.numel()}")
        return group.losses

    def _run_train_group(self, batches: list, generator: torch.Generator, batch_size: int,
                         metrics: EpochMetrics, losses: Optional[list]) -> None:
        """k host batches as one group: staged and replayed (or, on the CPU,
        run) with the seeds and rates the one-step loop would take."""
        host = [self._host_batch(x, y, batch_size) for x, y in batches]
        group = self._group_for("train", len(batches), *host[0], self._seeds_per_step())
        if not group.warm:  # the card's first full group: plain steps, then capture
            self._run_train_steps(batches, generator, batch_size, metrics, losses)
            group.warm = True
            group.graph = CapturedGraph(lambda: self._train_group_body(group))
            set_dropout_generator(self.model, None)
            return
        seeds = []
        for j in range(group.k):
            step_gen = torch.Generator().manual_seed(draw_seed(generator))
            seeds += [draw_seed(step_gen) for _ in range(group.seeds_per_step)]
            if self.schedule is not None:
                group.lr_values[j] = self.schedule(self.step + j)
        self._to_device(group.seeds.buffer, torch.tensor(seeds, dtype=torch.int64))
        if self.schedule is not None and self.device.type == "cuda":
            self._to_device(group.lrs, torch.tensor(group.lr_values, dtype=torch.float32))
        self._stage(group, host)
        if group.graph is not None:
            group.graph.replay()
        else:
            self._train_group_body(group)
        metrics.batches += group.k * self.grad_accum
        self.step += group.k
        if losses is not None:
            losses.extend(group.losses.clone().unbind(0))

    def _run_train_steps(self, batches: Iterable, generator: torch.Generator,
                         batch_size: int, metrics: EpochMetrics,
                         losses: Optional[list]) -> None:
        for x, y in batches:
            x, y = self.prepare_batch(x, y, batch_size)
            loss = self.train_step(x, y, torch.Generator().manual_seed(draw_seed(generator)),
                                   metrics)
            if losses is not None:
                losses.append(loss)

    def run_train_epoch(self, batches: Iterable, generator: torch.Generator,
                        batch_size: int, losses: Optional[list] = None) -> Dict:
        """One pass over ``batches`` of host (x, y); each step's dropout
        seeds come from a generator seeded from ``generator``. With
        ``steps_per_call`` k > 1, full groups of k batches run grouped (see
        the module docstring). ``losses``: a list that gets each step's loss
        (a device tensor), in order."""
        k = self._k_for(batch_size)
        if k == 1:
            metrics = EpochMetrics(self.num_classes, self.device, self.is_reg)
            self._run_train_steps(batches, generator, batch_size, metrics, losses)
            return self._finalize(metrics, "train")
        metrics = self._epoch_metrics("train")
        pending = []
        for batch in batches:
            pending.append(batch)
            if len(pending) == k:
                self._run_train_group(pending, generator, batch_size, metrics, losses)
                pending = []
        self._run_train_steps(pending, generator, batch_size, metrics, losses)  # the tail
        return self._finalize(metrics, "train")

    def _eval_step(self, x: torch.Tensor, y: torch.Tensor, metrics: EpochMetrics
                   ) -> torch.Tensor:
        logits = self.model(x)
        self._update_metrics(metrics, logits, y, self._loss(logits, y))
        return logits

    def _eval_group_body(self, group: _Group, metrics: EpochMetrics) -> None:
        for j in range(group.k):
            self._eval_step(group.xs[j], group.ys[j], metrics)

    def _run_eval_group(self, batches: list, batch_size: int, metrics: EpochMetrics,
                        kind: str) -> None:
        host = [self._host_batch(x, y, batch_size, accum=1) for x, y in batches]
        group = self._group_for(kind, len(batches), *host[0], 0)
        if not group.warm:
            for x, y in batches:
                self._eval_step(*self.prepare_batch(x, y, batch_size, accum=1), metrics)
            metrics.batches += group.k
            group.warm = True
            group.graph = CapturedGraph(lambda: self._eval_group_body(group, metrics))
            return
        self._stage(group, host)
        if group.graph is not None:
            group.graph.replay()
        else:
            self._eval_group_body(group, metrics)
        metrics.batches += group.k

    @torch.no_grad()
    def run_eval_epoch(self, batches: Iterable, batch_size: int,
                       step_type: str = "val", collect_outputs: bool = False) -> Dict:
        """Eval-mode forward, loss and metrics over ``batches`` (AUC on
        ``test`` epochs of a segmentation task). ``collect_outputs`` (a
        regression task) adds the valid predictions and labels as
        ``_preds`` / ``_labels``, step by step. With ``steps_per_call`` k > 1
        (re-clamped for ``batch_size``) full groups of k batches run grouped,
        as in training."""
        model = self.model.eval()
        set_dropout_generator(model, None)
        with_auc = step_type == "test" and not self.is_reg
        k = self._k_for(batch_size)
        collect = collect_outputs and self.is_reg
        if k > 1 and not collect_outputs:
            metrics = self._epoch_metrics(f"eval_{step_type}", with_auc)
            pending = []
            for batch in batches:
                pending.append(batch)
                if len(pending) == k:
                    self._run_eval_group(pending, batch_size, metrics,
                                         f"eval_{step_type}_{with_auc}")
                    pending = []
            for x, y in pending:
                self._eval_step(*self.prepare_batch(x, y, batch_size, accum=1), metrics)
                metrics.batches += 1
            return self._finalize(metrics, step_type)
        metrics = EpochMetrics(self.num_classes, self.device, self.is_reg, with_auc)
        collected_p, collected_y = [], []
        for x, y in batches:
            n_real = x.shape[0]
            x, y = self.prepare_batch(x, y, batch_size, accum=1)
            logits = self._eval_step(x, y, metrics)
            metrics.batches += 1
            if collect:
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
            load_optimizer_state(self.optimizer, state["optimizer"])
            self._groups.clear()  # graphs hold the replaced optimizer state
        self.step = int(state.get("step", 0))
        self.epoch = int(state.get("epoch", 0))
        best = load_best_metric(ckpt_path, self.monitor)
        if best is not None:
            self.best_metric = best
