"""Device-side input preprocessing and the fused raw-chip predict.

Counterpart of ``instageo_tpu/ops/preprocess.py``: chips cross to the device
as raw integers (uint16 is half the bytes of host-normalised float32), and
band select → constant multiply → per-band normalise → centre crop →
(B, C, T, H, W) runs on the device. The fused predict's phases are the
profiler's ranges ``instageo.serve.upload``, ``instageo.serve.preprocess``
and ``instageo.serve.argmax`` (``utils/telemetry.py:span``); the model
adds ``instageo.model.encoder`` and ``instageo.model.head``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.utils.telemetry import span


def raw_to_device(raw: Union[np.ndarray, torch.Tensor],
                  device: torch.device) -> torch.Tensor:
    """Raw chips onto ``device`` unconverted. uint16 travels as its int16 bit
    pattern (torch's uint16 has few device ops) and is widened to int32 there."""
    if isinstance(raw, torch.Tensor):
        return raw.to(device)
    raw = np.ascontiguousarray(raw)
    if raw.dtype == np.uint16:
        x = torch.from_numpy(raw.view(np.int16)).to(device)
        return x.to(torch.int32).bitwise_and_(0xFFFF)
    return torch.from_numpy(raw).to(device)


def preprocess_chips(
    raw: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    temporal_size: int = 1,
    bands: Optional[torch.Tensor] = None,
    constant_multiplier: float = 1.0,
    out_dtype: torch.dtype = torch.float32,
    img_size: Optional[int] = None,
) -> torch.Tensor:
    """(B, T·C_raw, H, W) raw ints -> normalised (B, C, T, H, W).

    ``mean``/``std`` are per-band (C,) tensors on ``raw``'s device; ``bands``
    (an index tensor on the same device) selects from the flattened T·C axis.
    ``img_size`` centre-crops chips larger than the model input.
    """
    x = raw
    if bands is not None:
        x = x.index_select(1, bands)
    h, w = x.shape[-2:]
    if img_size is not None and (h, w) != (img_size, img_size):
        if h < img_size or w < img_size:
            raise ValueError(f"chips {h}x{w} smaller than img_size {img_size}")
        off_h = (h - img_size) // 2
        off_w = (w - img_size) // 2
        x = x[..., off_h:off_h + img_size, off_w:off_w + img_size]
    b, tc, h, w = x.shape
    c = tc // temporal_size
    x = x.float() * constant_multiplier
    x = x.reshape(b, temporal_size, c, h, w)
    x = (x - mean[None, None, :, None, None]) / std[None, None, :, None, None]
    return x.permute(0, 2, 1, 3, 4).to(out_dtype)


def make_fused_predict_fn(model: nn.Module, mean, std, *,
                          temporal_size: int = 1,
                          bands: Optional[Sequence[int]] = None,
                          constant_multiplier: float = 1.0,
                          is_reg_task: bool = False,
                          img_size: Optional[int] = None
                          ) -> Callable[[Union[np.ndarray, torch.Tensor]], torch.Tensor]:
    """raw (B, T·C_raw, H, W) chips -> predictions on the model's device:
    int8 argmax classes (B, H, W), or float32 channel 0 for regression.

    The normalisation constants and band indices go to the device once,
    here; the model's weights already live there.
    """
    device = next(model.parameters()).device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)
    bands_t = (None if bands is None
               else torch.as_tensor(list(bands), dtype=torch.long, device=device))

    @torch.inference_mode()
    def predict(raw):
        with span("instageo.serve.upload"):
            x = raw_to_device(raw, device)
        with span("instageo.serve.preprocess"):
            x = preprocess_chips(x, mean_t, std_t, temporal_size=temporal_size,
                                 bands=bands_t, constant_multiplier=constant_multiplier,
                                 img_size=img_size)
        logits = model(x, channels_last=True)
        with span("instageo.serve.argmax"):
            if is_reg_task:
                return logits[..., 0].float()
            return logits.argmax(dim=-1).to(torch.int8)

    return predict
