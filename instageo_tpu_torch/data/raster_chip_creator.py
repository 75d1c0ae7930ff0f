"""Raster Chip Creator CLI: label rasters or bbox JSON -> chips.

    python -m instageo_tpu_torch.data.raster_chip_creator --records_file=labels.csv \\
        --raster_path=labels/ --output_directory=out [--device=cpu] ...
    python -m instageo_tpu_torch.data.raster_chip_creator --is_bbox_feature=true \\
        --bbox_feature_path=bboxes.json --date=2024-06-01 --output_directory=out

The port's own copy of ``instageo_tpu/data/raster_chip_creator.py``, with the
same flags and output files (``{src}_dataset.json``, the chips and seg maps,
``{src}_raster_dataset.csv`` with its unnamed index column): ``--records_file``
names a CSV of label rasters, or with ``--is_bbox_feature`` a JSON of
bounding boxes (the web-backend path); chips are cut on a fixed grid aligned
to the label rasters / bboxes and QA-masked on ``--device`` (``cuda`` by
default). S1 is not supported. The filtered records are cached as JSON
(``filtered_raster_records.json``) where the JAX CLI writes Parquet.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import List, Optional, Sequence

from instageo_tpu_torch.data import flags as _flags
from instageo_tpu_torch.data.crs import Transformer
from instageo_tpu_torch.data.geo_utils import create_grid_polygons, get_polygon_tile_ids
from instageo_tpu_torch.data.geotiff import GeoTiffReader
from instageo_tpu_torch.data.sources import hls, s2
from instageo_tpu_torch.data.stac import create_records_with_items
from instageo_tpu_torch.data.table import (
    Record,
    explode,
    load_records,
    read_csv,
    save_records,
    to_datetime,
)
from instageo_tpu_torch.device import resolve_device

RECORDS_CACHE = "filtered_raster_records.json"

RASTER_SOURCE_CONFIG = {
    "HLS": {
        "add_stac_items_func": hls.add_hls_raster_stac_items,
        "pipeline_class": hls.HLSRasterPipeline,
        "granules_field": "hls_granules",
        "items_field": "hls_items",
        "client_func": hls.get_client,
    },
    "S2": {
        "add_stac_items_func": s2.add_s2_stac_items,
        "pipeline_class": s2.S2RasterPipeline,
        "granules_field": "s2_granules",
        "items_field": "s2_items",
        "client_func": s2.get_client,
    },
}


def _reproject_bbox(bbox, src, dst):
    """Axis-aligned hull of the bbox's corners in the target CRS."""
    if src == dst:
        return bbox
    t = Transformer.from_crs(src, dst, always_xy=True)
    xs, ys = t.transform(
        [bbox[0], bbox[2], bbox[0], bbox[2]],
        [bbox[1], bbox[1], bbox[3], bbox[3]])
    return (float(min(xs)), float(min(ys)),
            float(max(xs)), float(max(ys)))


def _load_grid_records(flags) -> List[Record]:
    """The chip-grid records, from bboxes or from a label-raster CSV."""
    if flags.is_bbox_feature:
        with open(flags.bbox_feature_path) as f:
            payload = json.load(f)
        bboxes = payload["bboxes"] if isinstance(payload, dict) else payload
        return create_grid_polygons(
            bboxes, flags.date, flags.chip_size, flags.spatial_resolution,
            flags.src_crs)
    records, _ = read_csv(flags.records_file)
    rows = []
    for rec in records:
        path = os.path.join(flags.raster_path, rec["label_filename"])
        with GeoTiffReader(path) as r:
            t = r.transform
            raster_crs = r.crs or 4326
            x0, y0 = t * (0, 0)
            x1, y1 = t * (r.width, r.height)
        native = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        # The pipeline slices chips with ``bbox`` in src_crs; the MGRS and
        # STAC dispatch needs true EPSG:4326.
        rows.append({"label_filename": rec["label_filename"],
                     "date": rec["date"],
                     "bbox": _reproject_bbox(native, raster_crs, flags.src_crs),
                     "bbox_4326": _reproject_bbox(native, raster_crs, 4326)})
    for r in rows:
        r["mgrs_tile_id"] = sorted(get_polygon_tile_ids(r["bbox_4326"]))
    return explode(rows, "mgrs_tile_id")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point; ``argv`` without the program name (``sys.argv[1:]`` by
    default)."""
    flags = _flags.parse_flags(sys.argv[1:] if argv is None else argv,
                               _flags.COMMON_FLAGS + _flags.RASTER_FLAGS,
                               prog="instageo_tpu_torch.data.raster_chip_creator")
    resolve_device(flags.device)  # no card and no --device=cpu: raise before any work
    if flags.data_source == "S1":
        raise NotImplementedError("S1 raster chip creation is not supported.")

    grid = _load_grid_records(flags)
    for r in grid:
        r["date"] = to_datetime(r["date"])
        r["input_features_date"] = r["date"]

    config = RASTER_SOURCE_CONFIG[flags.data_source]
    out_dir = flags.output_directory
    os.makedirs(out_dir, exist_ok=True)
    dataset_file = os.path.join(out_dir, f"{flags.data_source.lower()}_dataset.json")
    records_file = os.path.join(out_dir, RECORDS_CACHE)

    if not (os.path.exists(dataset_file) and os.path.exists(records_file)):
        client = config["client_func"]()
        with_items = config["add_stac_items_func"](
            client, grid,
            num_steps=flags.num_steps,
            temporal_step=flags.temporal_step,
            temporal_tolerance=flags.temporal_tolerance,
            temporal_tolerance_minutes=flags.temporal_tolerance_minutes,
            cloud_coverage=flags.cloud_coverage,
            daytime_only=flags.daytime_only,
        )
        filtered, dataset = create_records_with_items(
            with_items, config["granules_field"], config["items_field"])
        with open(dataset_file, "w") as f:
            json.dump(dataset, f, indent=4)
        save_records(records_file, [{k: v for k, v in r.items() if k != "tile_queries"}
                                    for r in filtered])
    else:
        with open(dataset_file) as f:
            dataset = json.load(f)
        filtered = load_records(records_file)

    pipeline = config["pipeline_class"](
        output_directory=out_dir,
        chip_size=flags.chip_size,
        mask_types=list(flags.mask_types),
        masking_strategy=flags.masking_strategy,
        src_crs=flags.src_crs,
        spatial_resolution=flags.spatial_resolution,
        window_size=_flags.chip_window_size(flags),
        task_type=flags.task_type,
        raster_path=flags.raster_path,
        qa_check=flags.qa_check,
        is_bbox_feature=flags.is_bbox_feature,
        device=flags.device,
    )
    pipeline.run(dataset, filtered)
    logging.info("Raster chip creation complete: %s", out_dir)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
