"""Masked losses for segmentation, regression and distillation.

Counterpart of ``instageo_tpu/train/losses.py``: every loss is a masked mean
over the valid pixels, ``Σ loss·mask / max(Σ mask, 1)``, computed in
float32. The weighted cross entropy is ``Σ w[y]·nll·mask / max(Σ mask, 1)``,
which is not torch's ``reduction="mean"`` with ``weight=`` (that divides by
``Σ w[y]``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.float()
    return (values * mask).sum() / mask.sum().clamp_min(1.0)


def masked_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    class_weights: Optional[Union[Sequence[float], torch.Tensor]] = None,
) -> torch.Tensor:
    """Weighted masked CE. logits (B, C, H, W), labels (B, H, W) int.

    The mean over valid pixels of ``w[y]·nll(y)``. Labels other than
    ``ignore_index`` that fall outside [0, C) count as valid and are
    clipped into range, as in the JAX package. ``class_weights`` may be a
    float32 tensor on the logits' device, which is used without a copy.
    """
    num_classes = logits.shape[1]
    labels = labels.long()
    mask = labels != ignore_index
    safe = labels.clamp(0, num_classes - 1)
    weight = None
    if class_weights is not None:
        weight = torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)
    nll = F.cross_entropy(logits.float(), safe, weight=weight, reduction="none")
    return _masked_mean(nll, mask)


def masked_mse(
    preds: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: float = -1.0,
    use_log_scale: bool = False,
) -> torch.Tensor:
    """Masked MSE. preds/labels (B, H, W); optional log1p target scale."""
    preds, labels = preds.float(), labels.float()
    mask = labels != ignore_index
    if use_log_scale:
        # Masked-out entries stay finite (log1p(-1) = -inf would give inf·0).
        labels = torch.where(mask, torch.log1p(labels.clamp_min(-0.999999)), 0.0)
    return _masked_mean((preds - labels) ** 2, mask)


def kl_distillation_loss(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
) -> torch.Tensor:
    """KL(softmax(teacher) ‖ softmax(student)) per pixel, averaged over the
    valid pixels. Logits (B, C, H, W); labels (B, H, W) define validity."""
    logp_s = F.log_softmax(student_logits.float(), dim=1)
    logp_t = F.log_softmax(teacher_logits.float(), dim=1)
    kl = (logp_t.exp() * (logp_t - logp_s)).sum(dim=1)
    return _masked_mean(kl, labels != ignore_index)


def mse_distillation_loss(
    student_out: torch.Tensor,
    teacher_out: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: float = -1.0,
) -> torch.Tensor:
    """Mean squared student-vs-teacher error over the valid pixels."""
    sq = (student_out.float() - teacher_out.float()) ** 2
    return _masked_mean(sq, labels != ignore_index)


def segmentation_loss_with_distillation(
    student_logits: torch.Tensor,
    teacher_logits: torch.Tensor,
    labels: torch.Tensor,
    ignore_index: int = -100,
    class_weights: Optional[Sequence[float]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = masked CE + KL distillation."""
    ce = masked_cross_entropy(student_logits, labels, ignore_index, class_weights)
    kl = kl_distillation_loss(student_logits, teacher_logits, labels, ignore_index)
    total = ce + kl
    return total, {"loss": total, "ce_loss": ce, "distill_loss": kl}
