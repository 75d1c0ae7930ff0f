"""Granule-scale inference: whole tiles -> stitched prediction rasters.

Counterpart of ``instageo_tpu/serve/granule.py``. The tile goes to the
device once, in its own dtype (``ops/chip_ops.tile_to_device``: uint16 as
its int16 bit pattern, so a T=3 HLS tile of 3660² px is 482 MB, not the
965 MB of int32); the host loops over chip batches: one indexed read
gathers a batch's chips (``ops/chip_ops.extract_chips_px``), only they are
widened, then the preprocess, the forward and the nodata mask run, and
slice assignments stitch the batch into one device canvas in chip order,
so where clamped edge chips overlap the later chip wins. As in the JAX
package, the last batch is padded to ``batch_size`` with copies of the
first chip, which write nothing, so the forward runs at one shape. The
canvas crosses to the host once per tile. Chips never touch the host.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.ops.chip_ops import extract_chips_px, tile_to_device
from instageo_tpu_torch.ops.preprocess import preprocess_chips

log = logging.getLogger(__name__)


def chip_grid(h: int, w: int, chip_size: int, overlap: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The chip grid that covers a whole (h, w) tile.

    Starts step by ``chip_size − 2·overlap`` and the last start on each
    axis is clamped to the tile's edge, so remainders (3660 = 16·224 + 76)
    are predicted, not dropped. Returns ``coords`` (N, 2) pixel starts
    (x, y) in row-major order and ``bounds`` (N, 4) chip-relative interior
    crops (y0, y1, x0, x1) that skip the ``overlap`` margin except along
    the tile's edges.
    """
    if h < chip_size or w < chip_size:
        raise ValueError(f"tile {h}x{w} smaller than chip_size {chip_size}")
    if not 0 <= overlap < chip_size // 2:
        raise ValueError(f"overlap must be in [0, chip_size/2), got {overlap}")
    stride = chip_size - 2 * overlap

    def _starts(dim: int) -> np.ndarray:
        s = list(range(0, dim - chip_size + 1, stride))
        if s[-1] != dim - chip_size:
            s.append(dim - chip_size)
        return np.asarray(s, np.int64)

    coords = np.stack(np.meshgrid(_starts(w), _starts(h)), -1).reshape(-1, 2)
    cx, cy = coords[:, 0], coords[:, 1]
    bounds = np.stack([
        np.where(cy > 0, overlap, 0),
        chip_size - np.where(cy + chip_size < h, overlap, 0),
        np.where(cx > 0, overlap, 0),
        chip_size - np.where(cx + chip_size < w, overlap, 0),
    ], axis=1).astype(np.int64)
    return coords, bounds


def granule_inference(
    tile: np.ndarray,
    model: nn.Module,
    mean: Sequence[float],
    std: Sequence[float],
    *,
    chip_size: int = 224,
    temporal_size: int = 1,
    bands: Optional[Sequence[int]] = None,
    constant_multiplier: float = 1.0,
    is_reg_task: bool = False,
    batch_size: int = 32,
    no_data_value: float = 0,
    overlap: int = 0,
    stats: Optional[Dict[str, Any]] = None,
) -> Tuple[np.ndarray, float]:
    """Predict over a whole (T·C, H, W) tile on the model's device; returns
    (pred (H, W), seconds): int8 classes, −1 where every band the model sees
    is ``no_data_value``; float32 with NaN there for regression.

    ``overlap > 0`` discards each chip prediction's ``overlap``-pixel border
    (except along tile edges) when stitching, against seams at chip edges.
    ``stats``, if given, receives the chip and batch counts and the
    seconds of the host-to-device copy (host clock, synchronised), of the
    device loop (CUDA events; None on the CPU), of its first batch (host
    clock, synchronised: what a process's first forward sets up, a kernel
    build included, lands there) and of the copy back.
    """
    t0 = time.time()
    _, h, w = tile.shape
    coords, bounds = chip_grid(h, w, chip_size, overlap)
    n = len(coords)
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)
    bands_t = (None if bands is None
               else torch.as_tensor(list(bands), dtype=torch.long, device=device))
    out_dtype = torch.float32 if is_reg_task else torch.int8
    fill = float("nan") if is_reg_task else -1

    n_pad = -(-n // batch_size) * batch_size
    t_copy = time.perf_counter()
    tile_dev = tile_to_device(tile, device)
    coords_dev = torch.from_numpy(np.concatenate(
        [coords, np.zeros((n_pad - n, 2), coords.dtype)])).to(device)
    if on_card:
        torch.cuda.synchronize(device)
    h2d_s = time.perf_counter() - t_copy
    if on_card:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    canvas = torch.zeros((h, w), dtype=out_dtype, device=device)
    first_batch_s = None
    t_first = time.perf_counter()
    with torch.inference_mode():
        for b0 in range(0, n_pad, batch_size):
            chips = extract_chips_px(tile_dev, coords_dev[b0:b0 + batch_size], chip_size,
                                     uint16=tile.dtype == np.uint16).contiguous()
            x = preprocess_chips(chips, mean_t, std_t, temporal_size=temporal_size,
                                 bands=bands_t, constant_multiplier=constant_multiplier)
            logits = model(x, channels_last=True)
            # Pixels where every band the model sees is nodata (a QA band
            # left out may hold data there) get the output's nodata value.
            sel = chips if bands_t is None else chips.index_select(1, bands_t)
            no_data = (sel == no_data_value).all(dim=1)
            preds = (logits[..., 0].float() if is_reg_task
                     else logits.argmax(dim=-1).to(torch.int8))
            preds = torch.where(no_data, fill, preds)
            for j in range(min(batch_size, n - b0)):  # padding chips write nothing
                cx, cy = (int(v) for v in coords[b0 + j])
                y0, y1, x0, x1 = (int(v) for v in bounds[b0 + j])
                canvas[cy + y0:cy + y1, cx + x0:cx + x1] = preds[j, y0:y1, x0:x1]
            if first_batch_s is None:
                if on_card:
                    torch.cuda.synchronize(device)
                first_batch_s = time.perf_counter() - t_first
    device_s = None
    if on_card:
        end.record()
        end.synchronize()
        device_s = start.elapsed_time(end) / 1e3
    t_back = time.perf_counter()
    pred = canvas.cpu().numpy()
    d2h_s = time.perf_counter() - t_back
    dt = time.time() - t0
    if stats is not None:
        stats.update(chips=n, batches=n_pad // batch_size, h2d_s=h2d_s, device_s=device_s,
                     first_batch_s=first_batch_s, d2h_s=d2h_s, seconds=dt)
    log.info("granule_inference: %d chips in %.2fs (%.1f chips/s)", n, dt,
             n / dt if dt else 0)
    return pred, dt


def granule_inference_to_file(
    tile_path_or_array,
    out_path: str,
    model: nn.Module,
    mean: Sequence[float],
    std: Sequence[float],
    transform: Optional[Affine] = None,
    crs: Optional[int] = None,
    **kwargs,
) -> str:
    """Whole-granule prediction -> one georeferenced GeoTIFF."""
    if isinstance(tile_path_or_array, str):
        from instageo_tpu_torch.data.geotiff import GeoTiffReader

        with GeoTiffReader(tile_path_or_array) as r:
            tile = r.read()
            transform = transform or r.transform
            crs = crs or r.crs
    else:
        tile = np.asarray(tile_path_or_array)
    pred, _ = granule_inference(tile, model, mean, std, **kwargs)
    write_geotiff(out_path, pred[None], transform=transform, crs=crs,
                  nodata=-1 if pred.dtype == np.int8 else None)
    return out_path
