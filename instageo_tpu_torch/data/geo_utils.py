"""Geo utilities: bboxes, chip grids, raster windows (shapely-free).

The port's own copy of ``instageo_tpu/data/geo_utils.py``: geometries are
plain ``(lon_min, lat_min, lon_max, lat_max)`` tuples; the grid and point
records are lists of dicts (``data/table.py``) where the JAX package has
DataFrames.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from instageo_tpu_torch.data.crs import Transformer, to_mgrs
from instageo_tpu_torch.data.geotiff import Affine
from instageo_tpu_torch.data.table import Record, explode

BBox = Tuple[float, float, float, float]


def make_valid_bbox(lon_min: float, lat_min: float, lon_max: float,
                    lat_max: float) -> BBox:
    """Order coordinates; buffer degenerate (zero-area) boxes by 1e-3 deg."""
    epsilon = 1e-3
    lo_x, hi_x = min(lon_min, lon_max), max(lon_min, lon_max)
    lo_y, hi_y = min(lat_min, lat_max), max(lat_min, lat_max)
    if hi_x > lo_x and hi_y > lo_y:
        return lo_x, lo_y, hi_x, hi_y
    return lo_x - epsilon, lo_y - epsilon, hi_x + epsilon, hi_y + epsilon


def get_polygon_tile_ids(bbox: BBox) -> Set[str]:
    """MGRS (precision 0) tiles of a bbox's four corners (corner sampling,
    not full coverage)."""
    lon_min, lat_min, lon_max, lat_max = bbox
    return {
        to_mgrs(lat_min, lon_min, 0),
        to_mgrs(lat_max, lon_max, 0),
        to_mgrs(lat_max, lon_min, 0),
        to_mgrs(lat_min, lon_max, 0),
    }


def slice_raster_window(
    data: np.ndarray,
    transform: Affine,
    bbox: BBox,
    bbox_crs: Optional[int] = None,
    raster_crs: Optional[int] = None,
    chip_size: Optional[int] = None,
) -> Optional[Tuple[np.ndarray, Affine]]:
    """Crop a (bands, H, W) raster to a bbox, optionally exactly chip_size.

    The bbox is reprojected into the raster CRS, converted to row/col
    bounds via the inverse affine, and sliced; ``chip_size`` pins the
    output size. Returns (window, window_transform) or None when empty.
    """
    minx, miny, maxx, maxy = bbox
    if bbox_crs is not None and raster_crs is not None and bbox_crs != raster_crs:
        t = Transformer.from_crs(bbox_crs, raster_crs, always_xy=True)
        minx, miny = (float(v) for v in t.transform(minx, miny))
        maxx, maxy = (float(v) for v in t.transform(maxx, maxy))
    r0, c0 = transform.rowcol(minx, miny)
    r1, c1 = transform.rowcol(maxx, maxy)
    row_min, row_max = sorted((r0, r1))
    col_min, col_max = sorted((c0, c1))
    row_min, col_min = max(row_min, 0), max(col_min, 0)
    row_end = row_min + chip_size if chip_size else row_max
    col_end = col_min + chip_size if chip_size else col_max
    window = data[..., row_min:row_end, col_min:col_end]
    if window.size == 0:
        return None
    x0, y0 = transform * (col_min, row_min)
    win_transform = Affine(transform.a, transform.b, x0,
                           transform.d, transform.e, y0)
    return window, win_transform


def get_complete_chips_coords(
    coord_min: float,
    coord_max: float,
    spatial_resolution: float,
    chip_size: int,
    max_bound: float,
) -> np.ndarray:
    """Pixel-coordinate ladder covering whole chips."""
    n_chips = int(np.ceil((coord_max - coord_min) / (spatial_resolution * chip_size)))
    n_pixels = n_chips * chip_size
    if coord_min + n_pixels * spatial_resolution > max_bound:
        n_pixels = (n_chips - 1) * chip_size
    return np.arange(coord_min, coord_min + n_pixels * spatial_resolution,
                     spatial_resolution)


def create_grid_polygons(
    bbox_list: List[List[float]],
    date: str,
    chip_size: int,
    spatial_resolution: float,
    crs: int,
) -> List[Record]:
    """bboxes -> chip-grid records ``label_filename, date, bbox, bbox_4326,
    mgrs_tile_id``: one record per (chip, overlapping MGRS tile)."""
    records = []
    # The world-edge clamp only makes sense in degrees: projected
    # coordinates (eastings ~500000 m) would trip a 180/90 bound on
    # every bbox and drop the last chip row/col (or every chip of a
    # single-chip bbox).
    max_x, max_y = (180.0, 90.0) if crs == 4326 else (np.inf, np.inf)
    for bbox in bbox_list:
        lon_min, lat_min, lon_max, lat_max = bbox
        lons = get_complete_chips_coords(lon_min, lon_max, spatial_resolution,
                                         chip_size, max_x)
        lats = get_complete_chips_coords(lat_min, lat_max, spatial_resolution,
                                         chip_size, max_y)
        n_chips_x = len(lons) // chip_size
        n_chips_y = len(lats) // chip_size
        for x in range(n_chips_x):
            for y in range(n_chips_y):
                xs = lons[x * chip_size : (x + 1) * chip_size]
                ys = lats[y * chip_size : (y + 1) * chip_size]
                chip_bbox = (float(xs.min()), float(ys.min()),
                             float(xs.max()), float(ys.max()))
                records.append({
                    "label_filename": f"label_x{x}_y{y}_{date}.tif",
                    "date": date,
                    "bbox": chip_bbox,
                })
    if not records:
        return records
    if crs != 4326:
        t = Transformer.from_crs(crs, 4326, always_xy=True)

        def to4326(b):
            x0, y0 = t.transform(b[0], b[1])
            x1, y1 = t.transform(b[2], b[3])
            return (float(x0), float(y0), float(x1), float(y1))

        for r in records:
            r["bbox_4326"] = to4326(r["bbox"])
    else:
        for r in records:
            r["bbox_4326"] = r["bbox"]
    for r in records:
        r["mgrs_tile_id"] = sorted(get_polygon_tile_ids(r["bbox_4326"]))
    return explode(records, "mgrs_tile_id")


def points_in_bbox(rows: Sequence[Record], bbox: BBox,
                   x_col: str = "x", y_col: str = "y") -> List[Record]:
    """Point records inside a bbox (inclusive)."""
    minx, miny, maxx, maxy = bbox
    return [r for r in rows
            if minx <= r[x_col] <= maxx and miny <= r[y_col] <= maxy]


def bbox_intersects(a: BBox, b: BBox) -> bool:
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


def bbox_contains(outer: BBox, inner: BBox) -> bool:
    return (outer[0] <= inner[0] and outer[1] <= inner[1]
            and outer[2] >= inner[2] and outer[3] >= inner[3])


def point_within(bbox: BBox, x: float, y: float) -> bool:
    return bbox[0] <= x <= bbox[2] and bbox[1] <= y <= bbox[3]
