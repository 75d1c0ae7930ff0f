"""Batched chip inference: device forward + threaded GeoTIFF writes.

Counterpart of ``instageo_tpu/serve/infer.py``: batches of raw chips go to
the device, one forward per batch (argmax int8 for segmentation, float32
channel 0 for regression), and predictions are written on a thread pool
with the source chip's georeferencing and the ``chip`` → ``prediction``
name swap.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn

log = logging.getLogger(__name__)


def save_prediction(
    prediction: np.ndarray,
    source_chip_path: str,
    out_dir: str,
    is_reg_task: bool = False,
) -> str:
    """Write one prediction GeoTIFF with its source chip's georeferencing."""
    with GeoTiffReader(source_chip_path) as src:
        transform = src.transform
        crs = src.crs
        src_hw = (src.height, src.width)
    name = os.path.basename(source_chip_path).replace("chip", "prediction")
    out_path = os.path.join(out_dir, name)
    arr = prediction.astype(np.float32 if is_reg_task else np.int8)
    if arr.shape != src_hw and transform is not None:
        # The model predicted a centre crop of the chip: anchor the raster
        # at the crop's origin, not the chip's.
        row_off = (src_hw[0] - arr.shape[0]) // 2
        col_off = (src_hw[1] - arr.shape[1]) // 2
        x0, y0 = transform * (col_off, row_off)
        transform = Affine(transform.a, transform.b, x0,
                           transform.d, transform.e, y0)
    write_geotiff(out_path, arr[None], transform=transform, crs=crs)
    return out_path


def make_predict_fn(model: nn.Module, is_reg_task: bool = False,
                    probabilities: bool = False
                    ) -> Callable[[Union[np.ndarray, torch.Tensor]], torch.Tensor]:
    """Preprocessed (B, C, T, H, W) chips -> predictions on the model's device:
    int8 argmax classes, float32 channel 0 for regression, or the float32
    per-class softmax (B, H, W, C) with ``probabilities``."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def predict(x):
        x = torch.as_tensor(x).to(device)
        logits = model(x, channels_last=True)
        if is_reg_task:
            return logits[..., 0].float()
        if probabilities:
            return torch.softmax(logits.float(), dim=-1)
        return logits.argmax(dim=-1).to(torch.int8)

    return predict


class _HostCopy:
    """A device result copied to host memory without blocking the host."""

    def __init__(self, preds: torch.Tensor) -> None:
        if preds.device.type == "cuda":
            self.host = torch.empty(preds.shape, dtype=preds.dtype, pin_memory=True)
            self.host.copy_(preds, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = preds, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()  # waits for this batch only
        return self.host.numpy()


def chip_inference_from_paths(
    chip_paths: List[str],
    out_dir: str,
    model: nn.Module,
    mean,
    std,
    *,
    temporal_size: int = 1,
    bands: Optional[Sequence[int]] = None,
    constant_multiplier: float = 1.0,
    is_reg_task: bool = False,
    batch_size: int = 64,
    num_write_threads: int = 4,
    img_size: Optional[int] = None,
) -> Tuple[int, float]:
    """Raw chip files -> device -> prediction files. Returns (chips, seconds).

    Batch N+1 is decoded on a thread while the device runs batch N; batch
    N's predictions come back and are written on a thread pool while the
    device runs batch N+1. The tail batch is padded to ``batch_size`` so the
    device sees one shape.
    """
    if not chip_paths:
        return 0, 0.0
    os.makedirs(out_dir, exist_ok=True)
    with GeoTiffReader(chip_paths[0]) as r:
        shape = (r.count, r.height, r.width)
        dtype = np.dtype(r.dtypes[0])

    def decode_batch(paths):
        out = np.empty((batch_size,) + shape, dtype)
        for i, p in enumerate(paths):
            with GeoTiffReader(p) as rr:
                out[i] = rr.read()
        out[len(paths):] = 0  # tail padding
        return out

    predict = make_fused_predict_fn(
        model, mean, std, temporal_size=temporal_size, bands=bands,
        constant_multiplier=constant_multiplier, is_reg_task=is_reg_task,
        img_size=img_size)

    n = 0
    t0 = time.time()
    pending = None
    with ThreadPoolExecutor(num_write_threads) as pool, \
            ThreadPoolExecutor(1) as decode_pool:
        futures = []

        def flush(copy, files):
            for p, f in zip(copy.numpy(), files):
                futures.append(
                    pool.submit(save_prediction, p, f, out_dir, is_reg_task))

        next_raw = decode_pool.submit(decode_batch, chip_paths[:batch_size])
        for i in range(0, len(chip_paths), batch_size):
            files = chip_paths[i:i + batch_size]
            raw = next_raw.result()
            nxt = chip_paths[i + batch_size:i + 2 * batch_size]
            next_raw = decode_pool.submit(decode_batch, nxt) if nxt else None
            copy = _HostCopy(predict(raw)[:len(files)])
            if pending is not None:
                flush(*pending)
            pending = (copy, files)
            n += len(files)
        if pending is not None:
            flush(*pending)
        for f in futures:
            f.result()
    dt = time.time() - t0
    log.info("chip_inference_from_paths: %d chips in %.2fs (%.1f chips/s)",
             n, dt, n / dt if dt else 0.0)
    return n, dt
