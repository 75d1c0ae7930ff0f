"""Data cleaner CLI: chip QA and segmentation-map cleaning, after chip creation.

Counterpart of ``instageo_tpu/data/data_cleaner.py``, with the same flags
(on ``argparse``, absl's spellings, ``data/flags.py``) and outputs, over
records (``data/table.py``) instead of a DataFrame::

    python -m instageo_tpu_torch.data.data_cleaner \\
        --chips_dataset_csv=hls_dataset.csv --output_chips_dataset_csv=clean.csv \\
        --drop_chips --clean_seg_maps --cleaning_method=buffer

It drops chips whose no-data share exceeds a threshold (``any``/``all``
bands), and cleans seg maps by ``buffer`` (every labelled pixel's value
written over its (2w+1)² window, then the chip's no-data pixels reset) or
``limit`` (only the pixels of a points CSV kept). Everything runs on the
host: the buffer writes overlapping windows by numpy fancy assignment, in
which the last point wins; a scatter on the card would not keep that order.
"""

from __future__ import annotations

import logging
import os
import re
import sys
from typing import List, Optional, Sequence

import numpy as np

from instageo_tpu_torch.data import flags as _flags
from instageo_tpu_torch.data.crs import Transformer, to_mgrs
from instageo_tpu_torch.data.geotiff import GeoTiffReader, write_geotiff
from instageo_tpu_torch.data.table import Record, read_csv, write_csv

CLEANER_FLAGS = (
    _flags.Flag("chips_dataset_csv", "string", None, "CSV with Input and Label columns."),
    _flags.Flag("output_chips_dataset_csv", "string", None, "Where to save the cleaned CSV."),
    _flags.Flag("drop_chips", "bool", False, "Drop chips by no-data ratio threshold."),
    _flags.Flag("drop_chips_strategy", "enum", "any",
                "'any': drop if any band exceeds; 'all': all bands.", choices=("any", "all")),
    _flags.Flag("no_data_threshold", "float", 0.5,
                "No-data pixel ratio above which a chip is dropped."),
    _flags.Flag("clean_seg_maps", "bool", False, "Clean segmentation maps."),
    _flags.Flag("cleaning_method", "enum", "buffer",
                "buffer: dilate observation px; limit: keep only obs px.",
                choices=("buffer", "limit")),
    _flags.Flag("observation_points_csv", "string", None,
                "Points CSV (x, y, date[, mgrs_tile_id]) for 'limit'."),
    _flags.Flag("seg_map_output_dir", "string", None,
                "Directory for cleaned seg maps (default: in place)."),
    _flags.Flag("no_data_value", "integer", -9999, "No-data value in chips."),
    _flags.Flag("ignore_index", "integer", -1,
                "Ignore value written for non-observation pixels."),
    _flags.Flag("window_size", "integer", 1, "Half-size of the dilation window for 'buffer'."),
)


def should_drop_chip(chip_fname: str, no_data_threshold: float, no_data_value: float,
                     drop_chips_strategy: str) -> bool:
    """True if the chip's no-data share exceeds the threshold."""
    with GeoTiffReader(chip_fname) as r:
        chip = r.read()
    if drop_chips_strategy == "any":
        no_data_mask = np.any(chip == no_data_value, axis=0)
    elif drop_chips_strategy == "all":
        no_data_mask = np.all(chip == no_data_value, axis=0)
    else:
        raise ValueError(f"Invalid strategy {drop_chips_strategy!r}")
    return float(np.mean(no_data_mask)) > no_data_threshold


def _write_like(path_in: str, seg_map: np.ndarray, out_dir: Optional[str]) -> str:
    with GeoTiffReader(path_in) as src:
        transform, crs, nodata = src.transform, src.crs, src.nodata
    out_dir = out_dir or os.path.dirname(path_in)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(path_in))
    write_geotiff(out_path, seg_map, transform=transform, crs=crs, nodata=nodata)
    return out_path


def buffer_observation_pixels(seg_map_fname: str, chip_fname: str, window_size: int,
                              no_data_value: float, ignore_index: int,
                              seg_map_output_dir: Optional[str]) -> str:
    """Write each labelled pixel's value over its (2w+1)² window (the later
    pixel wins where windows overlap), then reset the chip's no-data pixels
    to ``ignore_index``."""
    with GeoTiffReader(chip_fname) as r:
        chip = r.read()
    with GeoTiffReader(seg_map_fname) as r:
        seg_map = r.read()
    rows, cols = np.where(seg_map[0] != ignore_index)
    offsets = np.arange(-window_size, window_size + 1)
    orow, ocol = np.meshgrid(offsets, offsets)
    wr = np.clip(rows[:, None, None] + orow, 0, seg_map.shape[1] - 1)
    wc = np.clip(cols[:, None, None] + ocol, 0, seg_map.shape[2] - 1)
    values = seg_map[0, rows, cols]
    seg_map[0, wr.ravel(), wc.ravel()] = np.repeat(values, (2 * window_size + 1) ** 2)
    mask = np.all(chip == no_data_value, axis=0)
    seg_map[0, mask] = ignore_index
    return _write_like(seg_map_fname, seg_map, seg_map_output_dir)


def limit_seg_map_to_observation_pixels(seg_map_fname: str, observation_points: List[Record],
                                        ignore_index: int,
                                        seg_map_output_dir: Optional[str]) -> Optional[str]:
    """Keep only the pixels at the observation points of the seg map's MGRS
    tile and date; None where it has none.

    The file name is ``seg_map_{date}_{tile_id}_{x}_{y}.tif``, whose tile id
    holds the MGRS code at a place that depends on the sensor, so the code
    is found by its pattern (``_T`` + 2 digits + 3 letters + ``_``)."""
    base = os.path.basename(seg_map_fname)
    parts = base.split("_")
    chip_date = parts[2] if len(parts) >= 4 else ""
    m = re.search(r"_T(\d{2}[A-Z]{3})_", base)
    mgrs_tile = m.group(1) if m else (parts[4][1:] if len(parts) >= 5 else "")

    with GeoTiffReader(seg_map_fname) as src:
        seg_map = src.read()
        crs = src.crs
        transform = src.transform

    relevant = [p for p in observation_points
                if p["mgrs_tile_id"] == mgrs_tile
                and str(p["date"]).replace("-", "") == chip_date]
    if not relevant:
        return None
    mask = np.zeros(seg_map[0].shape, dtype=bool)
    t = Transformer.from_crs(4326, crs, always_xy=True)
    xs, ys = t.transform(np.array([p["x"] for p in relevant]),
                         np.array([p["y"] for p in relevant]))
    for x, y in zip(np.atleast_1d(xs), np.atleast_1d(ys)):
        row, col = transform.rowcol(float(x), float(y))
        if 0 <= row < seg_map.shape[1] and 0 <= col < seg_map.shape[2]:
            mask[row, col] = True
    seg_map = np.where(mask, seg_map, ignore_index).astype(seg_map.dtype)
    return _write_like(seg_map_fname, seg_map, seg_map_output_dir)


def clean_data(
    chips_dataset_csv: str,
    output_chips_dataset_csv: str,
    drop_chips: bool = False,
    drop_chips_strategy: str = "any",
    no_data_threshold: float = 0.5,
    no_data_value: float = -9999,
    clean_seg_maps: bool = False,
    observation_points_csv: Optional[str] = None,
    cleaning_method: str = "buffer",
    ignore_index: int = -1,
    window_size: int = 1,
    seg_map_output_dir: Optional[str] = None,
) -> List[Record]:
    """Drop and clean, then write the new CSV; returns its rows."""
    rows, columns = read_csv(chips_dataset_csv)
    num_rows = len(rows)
    if not all(c in columns for c in ("Input", "Label")):
        raise ValueError("CSV must contain 'Input' and 'Label' columns")

    if drop_chips:
        rows = [r for r in rows if not should_drop_chip(
            r["Input"], no_data_threshold, no_data_value, drop_chips_strategy)]

    if clean_seg_maps:
        if cleaning_method == "buffer":
            rows = [{**r, "Label": buffer_observation_pixels(
                r["Label"], r["Input"], window_size, no_data_value, ignore_index,
                seg_map_output_dir)} for r in rows]
        elif cleaning_method == "limit":
            if not observation_points_csv:
                raise ValueError("Observation points CSV is required for 'limit'")
            points, point_columns = read_csv(observation_points_csv)
            if not all(c in point_columns for c in ("x", "y", "date")):
                raise ValueError("Observation points CSV must contain x, y, date")
            if "mgrs_tile_id" not in point_columns:
                for p in points:
                    p["mgrs_tile_id"] = to_mgrs(p["y"], p["x"], 0)
            rows = [{**r, "Label": limit_seg_map_to_observation_pixels(
                r["Label"], points, ignore_index, seg_map_output_dir)} for r in rows]
            rows = [r for r in rows if r["Label"] is not None]
        else:
            raise ValueError(f"Invalid cleaning method: {cleaning_method}")

    write_csv(output_chips_dataset_csv, rows, columns)
    logging.info("Cleaned data saved to %s. Dropped %d rows.",
                 output_chips_dataset_csv, num_rows - len(rows))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point; ``argv`` without the program name (``sys.argv[1:]`` by
    default)."""
    flags = _flags.parse_flags(sys.argv[1:] if argv is None else argv, CLEANER_FLAGS,
                               prog="instageo_tpu_torch.data.data_cleaner")
    clean_data(
        chips_dataset_csv=flags.chips_dataset_csv,
        output_chips_dataset_csv=flags.output_chips_dataset_csv,
        drop_chips=flags.drop_chips,
        drop_chips_strategy=flags.drop_chips_strategy,
        no_data_threshold=flags.no_data_threshold,
        no_data_value=flags.no_data_value,
        clean_seg_maps=flags.clean_seg_maps,
        observation_points_csv=flags.observation_points_csv,
        cleaning_method=flags.cleaning_method,
        ignore_index=flags.ignore_index,
        window_size=flags.window_size,
        seg_map_output_dir=flags.seg_map_output_dir,
    )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
