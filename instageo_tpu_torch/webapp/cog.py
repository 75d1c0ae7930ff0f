"""COG converter: mosaic task chips/predictions into display COGs + stats.

The port's own copy of ``instageo_tpu/webapp/cog.py`` (reference
``instageo/new_apps/backend/app/cog_converter.py``, which runs
``gdal_merge.py`` + ``gdal_translate -of COG``): merges ``chips/`` (first 3
bands as RGB) and ``predictions/`` into single COGs with the codec's tiled
multi-overview writer, two merges running concurrently, plus per-class pixel
statistics from the merged prediction. numpy on the host, as in the JAX
package.
"""

from __future__ import annotations

import glob
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_cog

log = logging.getLogger(__name__)


def merge_rasters(paths: List[str], bands: Optional[List[int]] = None,
                  fill_value: float = 0) -> Tuple[np.ndarray, Affine, Optional[int]]:
    """Mosaic same-CRS rasters onto their union grid (gdal_merge equivalent)."""
    if not paths:
        raise ValueError("No rasters to merge")
    metas = []
    crs = None
    for p in paths:
        with GeoTiffReader(p) as r:
            metas.append((p, r.transform, r.width, r.height, r.count))
            crs = crs or r.crs
    res_x = metas[0][1].a
    res_y = metas[0][1].e  # negative
    min_x = min(m[1].c for m in metas)
    max_y = max(m[1].f for m in metas)
    max_x = max(m[1].c + m[2] * res_x for m in metas)
    min_y = min(m[1].f + m[3] * res_y for m in metas)
    width = int(round((max_x - min_x) / res_x))
    height = int(round((min_y - max_y) / res_y))
    n_bands = len(bands) if bands else metas[0][4]

    first_dtype = None
    mosaic = None
    for p, tr, w, h, _count in metas:
        with GeoTiffReader(p) as r:
            arr = r.read(bands) if bands else r.read()
        if mosaic is None:
            first_dtype = arr.dtype
            mosaic = np.full((n_bands, height, width), fill_value, first_dtype)
        col0 = int(round((tr.c - min_x) / res_x))
        row0 = int(round((tr.f - max_y) / res_y))
        mosaic[:, row0 : row0 + h, col0 : col0 + w] = arr
    transform = Affine(res_x, 0.0, min_x, 0.0, res_y, max_y)
    return mosaic, transform, crs


class COGConverter:
    """Reference COGConverter surface (cog_converter.py:24-221)."""

    def __init__(self, data_dir: str, block_size: int = 256,
                 num_overviews: int = 6) -> None:
        self.data_dir = data_dir
        self.block_size = block_size
        self.num_overviews = num_overviews

    def _merge_to_cog(self, pattern: str, out_name: str,
                      bands: Optional[List[int]], nodata: float) -> Optional[str]:
        paths = sorted(glob.glob(os.path.join(self.data_dir, pattern)))
        if not paths:
            return None
        mosaic, transform, crs = merge_rasters(paths, bands=bands,
                                               fill_value=nodata)
        out_path = os.path.join(self.data_dir, out_name)
        write_cog(out_path, mosaic, transform=transform, crs=crs,
                  nodata=nodata, tile_size=self.block_size,
                  num_overviews=self.num_overviews)
        return out_path

    def merge_task_files_to_cog(self, task_id: str) -> Dict[str, Any]:
        """Concurrent chips (RGB) + predictions merges (reference :57-190)."""
        with ThreadPoolExecutor(2) as pool:
            chips_fut = pool.submit(
                self._merge_to_cog, "chips/*.tif", f"{task_id}_chips.tif",
                [3, 2, 1], 0)  # RGB display order from B04/B03/B02
            preds_fut = pool.submit(
                self._merge_to_cog, "predictions/*.tif",
                f"{task_id}_predictions.tif", None, -1)
            chips_cog = chips_fut.result()
            preds_cog = preds_fut.result()
        return {"chips_cog": chips_cog, "predictions_cog": preds_cog}

    def compute_seg_stats(self, predictions_cog: Optional[str]) -> Dict[str, Any]:
        """Per-class pixel histogram (reference :192-221)."""
        if not predictions_cog or not os.path.exists(predictions_cog):
            return {}
        with GeoTiffReader(predictions_cog) as r:
            arr = r.read(1)
            nodata = r.nodata
        valid = arr[arr != (nodata if nodata is not None else -1)]
        classes, counts = np.unique(valid, return_counts=True)
        total = int(counts.sum())
        return {
            "total_pixels": total,
            "classes": {
                str(int(c)): {"count": int(n),
                              "fraction": float(n / total) if total else 0.0}
                for c, n in zip(classes, counts)
            },
            # Reference-shaped fields (cog_converter.py:192-221) the
            # frontend visualization dialog consumes directly.
            "class_counts": {str(int(c)): int(n)
                             for c, n in zip(classes, counts)},
            "valid_pixels": total,
            "unique_values": int(len(classes)),
        }
