"""Chip-grid geometry of the data pipeline.

The port's own copy of the two numpy functions of
``instageo_tpu/data/pipeline.py`` that the chip ops consume: a point's chip
on the grid and its pixel. The DataFrame-based chip creation waits for the
data CLIs (ROADMAP item 13).
"""

from __future__ import annotations

import numpy as np

from instageo_tpu_torch.data.geotiff import Affine


def get_chip_coords(xs: np.ndarray, ys: np.ndarray, transform: Affine,
                    chip_size: int) -> np.ndarray:
    """Unique (x, y) chip-grid indices for points."""
    inv = transform.invert()
    cols = np.floor(inv.a * xs + inv.b * ys + inv.c).astype(int)
    rows = np.floor(inv.d * xs + inv.e * ys + inv.f).astype(int)
    return np.unique(np.stack((cols // chip_size, rows // chip_size), axis=-1),
                     axis=0)


def point_rowcol(xs: np.ndarray, ys: np.ndarray, transform: Affine) -> np.ndarray:
    """(row, col) pixel indices for points under a transform."""
    inv = transform.invert()
    cols = np.floor(inv.a * xs + inv.b * ys + inv.c).astype(int)
    rows = np.floor(inv.d * xs + inv.e * ys + inv.f).astype(int)
    return np.stack([rows, cols], axis=-1)
