"""Data-pipeline core: tile grouping, temporal queries, chip orchestration.

The port's own copy of ``instageo_tpu/data/pipeline.py``: observations are
grouped into MGRS tiles, each tile gets its temporal search window, and the
points and raster pipeline base classes drive tile load -> chip math on the
pipeline's device (``instageo_tpu_torch.ops.chip_ops``) -> GeoTIFF writes,
on a thread pool. Observations and grid chips are records (lists of dicts,
``data/table.py``) where the JAX package has DataFrames; dates are
``datetime`` values.
"""

from __future__ import annotations

import json
import logging
import os
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor, as_completed
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from instageo_tpu_torch.data.crs import Transformer, to_mgrs
from instageo_tpu_torch.data.geo_utils import slice_raster_window
from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
from instageo_tpu_torch.data.settings import DATA_PIPELINE_SETTINGS, NO_DATA_VALUES
from instageo_tpu_torch.data.table import (
    Record,
    columns_of,
    drop_duplicates,
    read_csv,
    to_datetime,
    write_csv,
)
from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.ops.chip_ops import (
    apply_mask,
    mask_segmentation_map,
    process_tile_chips,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Observation grouping
# ---------------------------------------------------------------------------


def reproject_coordinates(data: Sequence[Record], source_epsg: int = 4326) -> List[Record]:
    """Copies of the records with x/y reprojected to EPSG:4326."""
    t = Transformer.from_crs(source_epsg, 4326, always_xy=True)
    x, y = t.transform(np.asarray([r["x"] for r in data]), np.asarray([r["y"] for r in data]))
    return [{**r, "x": float(xi), "y": float(yi)} for r, xi, yi in zip(data, x, y)]


def get_tiles(data: Sequence[Record], src_crs: int = 4326,
              min_count: int = 100) -> List[Record]:
    """Assign MGRS tiles (``mgrs_tile_id``, with its observation count in
    ``counts``) and keep tiles with >= min_count observations, in order."""
    if src_crs != 4326:
        data = reproject_coordinates(data, source_epsg=src_crs)
    if not (data and "mgrs_tile_id" in data[0]):
        data = [{**r, "mgrs_tile_id": to_mgrs(r["y"], r["x"], 0)} for r in data]
    counts: Dict[str, int] = {}
    for r in data:
        counts[r["mgrs_tile_id"]] = counts.get(r["mgrs_tile_id"], 0) + 1
    sub = [{**r, "counts": counts[r["mgrs_tile_id"]]} for r in data
           if counts[r["mgrs_tile_id"]] >= min_count]
    if not sub:
        raise ValueError("No observation records left")
    return sub


def with_input_features_date(data: Sequence[Record]) -> List[Record]:
    """The records with ``date`` as ``input_features_date`` where they have
    none (``DataFrame.rename``)."""
    if data and "input_features_date" not in data[0]:
        return [{("input_features_date" if k == "date" else k): v for k, v in r.items()}
                for r in data]
    return list(data)


def _tile_info(
    data: Sequence[Record],
    extent,
    num_steps: int,
    temporal_step: int,
    temporal_tolerance: int,
    temporal_tolerance_minutes: int,
) -> Tuple[List[Record], List[Tuple[str, List[str]]]]:
    """Per-tile search windows from ``extent(record)`` = (date, lon_min,
    lat_min, lon_max, lat_max), and each record's temporal queries."""
    tile_queries: List[Tuple[str, List[str]]] = []
    tiles: Dict[str, Record] = {}
    for r in data:
        tile_id = r["mgrs_tile_id"]
        date, lon0, lat0, lon1, lat1 = extent(r)
        history = []
        for i in range(num_steps):
            curr = date - timedelta(days=temporal_step * i)
            history.append(curr.strftime("%Y-%m-%dT%H:%M:%S"))
            t = tiles.setdefault(tile_id, {"tile_id": tile_id, "min_date": curr,
                                           "max_date": curr, "lon_min": lon0, "lon_max": lon1,
                                           "lat_min": lat0, "lat_max": lat1})
            t["min_date"], t["max_date"] = min(t["min_date"], curr), max(t["max_date"], curr)
            t["lon_min"], t["lon_max"] = min(t["lon_min"], lon0), max(t["lon_max"], lon1)
            t["lat_min"], t["lat_max"] = min(t["lat_min"], lat0), max(t["lat_max"], lat1)
        tile_queries.append((tile_id, history))
    # Widen each tile's dates by the tolerance; the max date goes to the
    # end of its day when the records have no time of day.
    tol = timedelta(days=temporal_tolerance + temporal_tolerance_minutes / (24 * 60))
    fmt = "%Y-%m-%dT%H:%M:%S" if data and "time" in data[0] else "%Y-%m-%dT23:59:59"
    tile_info = [tiles[k] for k in sorted(tiles)]
    for t in tile_info:
        t["min_date"] = (t["min_date"] - tol).strftime("%Y-%m-%dT%H:%M:%S")
        t["max_date"] = (t["max_date"] + tol).strftime(fmt)
    return tile_info, tile_queries


def get_tile_info(
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 5,
    temporal_tolerance_minutes: int = 0,
) -> Tuple[List[Record], List[Tuple[str, List[str]]]]:
    """Per-tile date windows + per-observation temporal queries.

    Each observation expands to ``num_steps`` dates going back
    ``temporal_step`` days; per-tile min/max dates are widened by the
    tolerance; the max date is pushed to the end of its day when the
    records have no ``time``. Tiles come in sorted order.
    """
    return _tile_info(
        data, lambda r: (r["input_features_date"], r["x"], r["y"], r["x"], r["y"]),
        num_steps, temporal_step, temporal_tolerance, temporal_tolerance_minutes)


def get_raster_tile_info(
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 5,
    temporal_tolerance_minutes: int = 0,
) -> Tuple[List[Record], List[Tuple[str, List[str]]]]:
    """Raster-grid variant of :func:`get_tile_info` over ``bbox_4326``
    records: the per-tile union bbox instead of point extents."""
    return _tile_info(
        data, lambda r: (to_datetime(r["input_features_date"]), *r["bbox_4326"]),
        num_steps, temporal_step, temporal_tolerance, temporal_tolerance_minutes)


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


# ---------------------------------------------------------------------------
# Chip creation (device math + file IO)
# ---------------------------------------------------------------------------


def create_and_save_chips_with_seg_maps(
    tile_array: np.ndarray,
    mask_array: Optional[np.ndarray],
    transform: Affine,
    crs: int,
    tile_id: str,
    df: Sequence[Record],
    chip_size: int,
    output_directory: str,
    no_data_value: float,
    src_crs: int,
    data_source: str,
    mask_types: Sequence[str],
    masking_strategy: str,
    window_size: int,
    task_type: str = "seg",
    chip_dtype: Optional[np.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[List[str], List[Optional[str]]]:
    """Slice a loaded tile into chips + seg maps and write both.

    One ``process_tile_chips`` call on ``device`` for the whole tile. Chip
    ids are ``chip_{date}_{tile}_{x}_{y}.tif``; empty chips and label-less
    seg maps are skipped; existing files are skipped (idempotent resume).
    """
    xs = np.asarray([r["x"] for r in df], np.float64)
    ys = np.asarray([r["y"] for r in df], np.float64)
    if src_crs != crs:
        t = Transformer.from_crs(src_crs, crs, always_xy=True)
        x, y = t.transform(xs, ys)
        xs, ys = np.asarray(x), np.asarray(y)
    h, w = tile_array.shape[-2:]
    x_min, y_max = transform * (0, 0)
    x_max, y_min = transform * (w, h)
    lo_x, hi_x = sorted((x_min, x_max))
    lo_y, hi_y = sorted((y_min, y_max))
    inside = (xs >= lo_x) & (xs <= hi_x) & (ys >= lo_y) & (ys <= hi_y)
    if not inside.any():
        return [], []
    rows = [r for r, keep in zip(df, inside) if keep]
    xs, ys = xs[inside], ys[inside]

    os.makedirs(os.path.join(output_directory, "chips"), exist_ok=True)
    os.makedirs(os.path.join(output_directory, "seg_maps"), exist_ok=True)
    date_id = to_datetime(rows[0]["date"]).strftime("%Y%m%d")

    n_chips_x = w // chip_size
    n_chips_y = h // chip_size
    coords = get_chip_coords(xs, ys, transform, chip_size)
    keep = [(x, y) for x, y in coords if x < n_chips_x and y < n_chips_y]

    todo = []
    for x, y in keep:
        chip_name = f"chip_{date_id}_{tile_id}_{x}_{y}.tif"
        seg_name = f"seg_map_{date_id}_{tile_id}_{x}_{y}.tif"
        chip_path = os.path.join(output_directory, "chips", chip_name)
        seg_path = os.path.join(output_directory, "seg_maps", seg_name)
        if os.path.exists(chip_path) or os.path.exists(seg_path):
            continue
        todo.append((x, y, chip_name, seg_name, chip_path, seg_path))
    if not todo:
        return [], []

    chip_coords = np.asarray([(t_[0], t_[1]) for t_ in todo], np.int32)
    rc = point_rowcol(xs, ys, transform)
    # Owning chip per point.
    owner = np.full(len(rows), -1, np.int64)
    coord_index = {tuple(c): i for i, c in enumerate(chip_coords.tolist())}
    pc = np.stack([rc[:, 1] // chip_size, rc[:, 0] // chip_size], axis=-1)
    for i, c in enumerate(pc.tolist()):
        owner[i] = coord_index.get(tuple(c), -1)

    labels = (np.asarray([r["label"] for r in rows]).astype(np.float32)
              if "label" in rows[0] else np.zeros(len(rows), np.float32))

    chips_arr, seg_arr, chip_valid, seg_valid = process_tile_chips(
        tile_array, mask_array, chip_coords, rc, labels, owner,
        chip_size=chip_size, no_data_value=no_data_value,
        data_source=data_source, mask_types=mask_types,
        masking_strategy=masking_strategy, window_size=window_size,
        is_reg=(task_type == "reg"), device=device,
    )

    chips: List[str] = []
    seg_maps: List[Optional[str]] = []
    dtype = chip_dtype or tile_array.dtype
    for i, (x, y, chip_name, seg_name, chip_path, seg_path) in enumerate(todo):
        if not chip_valid[i] or not seg_valid[i]:
            continue
        x0, y0 = transform * (x * chip_size, y * chip_size)
        chip_tr = Affine(transform.a, transform.b, x0, transform.d, transform.e, y0)
        seg_dtype = np.float32 if task_type == "reg" else np.int16
        write_geotiff(seg_path, seg_arr[i].astype(seg_dtype)[None],
                      transform=chip_tr, crs=crs, nodata=NO_DATA_VALUES.SEG_MAP)
        seg_maps.append(seg_name)
        write_geotiff(chip_path, chips_arr[i].astype(dtype),
                      transform=chip_tr, crs=crs, nodata=no_data_value)
        chips.append(chip_name)
    return chips, seg_maps


# ---------------------------------------------------------------------------
# Pipeline base classes
# ---------------------------------------------------------------------------


class BaseDataPipeline(ABC):
    """Shared orchestration: resume filter, worker pool, CSV output. The
    chip math runs on ``device`` (``cuda`` unless the caller asks for the
    CPU; no card raises here, before any work)."""

    def __init__(self, output_directory: str, chip_size: int = 256,
                 src_crs: int = 4326, mask_types: Sequence[str] = (),
                 masking_strategy: str = "each", window_size: int = 0,
                 task_type: str = "seg", num_workers: int = 4,
                 spatial_resolution: float = 0.0002694945852358564,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.output_directory = output_directory
        self.chip_size = chip_size
        self.src_crs = src_crs
        self.mask_types = list(mask_types)
        self.masking_strategy = masking_strategy
        self.window_size = window_size
        self.task_type = task_type
        self.num_workers = num_workers
        self.spatial_resolution = spatial_resolution
        self.device = resolve_device(device)

    @property
    @abstractmethod
    def data_source(self) -> str:
        ...

    @abstractmethod
    def load_tile(self, key: str, granules: Any) -> Optional[Tuple]:
        """Fetch/decode one tile -> (tile_array, mask_array, transform, crs,
        tile_id) or None on failure."""

    def _load_state(self, state_path: str) -> list:
        if not os.path.exists(state_path):
            return []
        try:
            with open(state_path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            # A corrupt resume file must not wedge the pipeline into
            # failing every tile forever: start over (chip writes are
            # idempotent) and say so.
            log.warning("Corrupt resume state %s (%s): reprocessing all "
                        "tiles", state_path, e)
            return []

    def _is_processed(self, key: str, state_path: str) -> bool:
        return key in self._load_state(state_path)

    def _mark_processed(self, key: str, state_path: str) -> None:
        state = self._load_state(state_path)
        if key not in state:
            state.append(key)
        # Atomic replace: a crash mid-write must never leave truncated JSON.
        tmp = state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, state_path)

    def run(self, dataset: Dict[str, Any], obsv_records: Dict[str, List[Record]]
            ) -> List[Record]:
        """Process all tiles; returns the Input/Label manifest records.

        ``obsv_records`` maps a tile key (serialized granule set) to the
        observation records it serves.
        """
        os.makedirs(self.output_directory, exist_ok=True)
        state_path = os.path.join(self.output_directory, "processed_tiles.json")
        manifest_rows: List[Record] = []

        def process(key: str) -> Optional[List[Record]]:
            if self._is_processed(key, state_path):
                return []
            loaded = self.load_tile(key, dataset)
            if loaded is None:
                # Load/decode failed (e.g. a transient network error): the
                # key stays unmarked, so a re-run retries it.
                return None
            tile_array, mask_array, transform, crs, tile_id = loaded
            df = obsv_records[key]
            chips, seg_maps = create_and_save_chips_with_seg_maps(
                tile_array, mask_array, transform, crs, tile_id, df,
                chip_size=self.chip_size,
                output_directory=self.output_directory,
                no_data_value=self.no_data_value,
                src_crs=self.src_crs,
                data_source=self.data_source,
                mask_types=self.mask_types,
                masking_strategy=self.masking_strategy,
                window_size=self.window_size,
                task_type=self.task_type,
                device=self.device,
            )
            return [
                {"Input": f"chips/{c}", "Label": f"seg_maps/{s}"}
                for c, s in zip(chips, seg_maps)
            ]

        with ThreadPoolExecutor(self.num_workers) as pool:
            futs = {pool.submit(process, k): k for k in obsv_records}
            for fut in as_completed(futs):
                key = futs[fut]
                try:
                    rows = fut.result()
                    if rows is None:
                        log.warning("Tile %s failed to load; left unmarked "
                                    "for retry on resume", key)
                        continue
                    manifest_rows.extend(rows)
                    self._mark_processed(key, state_path)
                except Exception as e:
                    log.error("Tile %s failed: %s", key, e)

        manifest = manifest_rows
        columns = columns_of(manifest)
        out_csv = os.path.join(
            self.output_directory,
            f"{self.data_source.lower()}_dataset.csv")
        if os.path.exists(out_csv):
            # Resume: tiles already in processed_tiles.json return no rows
            # this run, so merge with the previous manifest, or it would
            # keep only the new tiles' chips.
            prev, prev_columns = read_csv(out_csv)
            manifest = prev + manifest
            columns = list(dict.fromkeys(prev_columns + columns))
            if "Input" in columns:
                manifest = drop_duplicates(manifest, "Input", keep="last")
        write_csv(out_csv, manifest, columns)
        return manifest

    @property
    def no_data_value(self) -> float:
        return getattr(NO_DATA_VALUES, self.data_source, 0)


class BaseRasterPipeline(BaseDataPipeline):
    """Raster/bbox-grid pipeline: fixed chip grid, labels from rasters.

    Each record carries a chip bbox (``bbox``) and a ``label_filename``;
    chips are sliced to exactly ``chip_size`` from the loaded tile,
    QA-masked on the pipeline's device, and written uint16; with
    ``is_bbox_feature`` (the web-backend path) no labels are produced.
    """

    def __init__(self, *args, raster_path: str = "", qa_check: bool = True,
                 is_bbox_feature: bool = False, **kw) -> None:
        super().__init__(*args, **kw)
        self.raster_path = raster_path
        self.qa_check = qa_check
        self.is_bbox_feature = is_bbox_feature

    def process_row(self, row: Record, tile_loaded: Tuple) -> Optional[
            Tuple[str, Optional[str]]]:
        """One grid chip: slice -> mask -> (optional) label -> write."""
        tile_array, mask_array, transform, crs, _tile_id = tile_loaded
        dev = self.device
        label_filename = (
            f"{os.path.splitext(row['label_filename'])[0]}_{row['mgrs_tile_id']}")
        chip_filename = label_filename.replace("mask", "merged").replace(
            "label", "chip")
        chip_path = os.path.join(self.output_directory, "chips",
                                 f"{chip_filename}.tif")
        label_path = os.path.join(self.output_directory, "seg_maps",
                                  f"{label_filename}.tif")
        if os.path.exists(chip_path) and (self.is_bbox_feature
                                          or os.path.exists(label_path)):
            return chip_path, (None if self.is_bbox_feature else label_path)

        sliced = slice_raster_window(
            tile_array, transform, row["bbox"], bbox_crs=self.src_crs,
            raster_crs=crs, chip_size=self.chip_size)
        if sliced is None:
            return None
        chip, chip_tr = sliced
        if chip.shape[-1] < self.chip_size or chip.shape[-2] < self.chip_size:
            return None

        if mask_array is not None and self.mask_types:
            msliced = slice_raster_window(
                mask_array, transform, row["bbox"], bbox_crs=self.src_crs,
                raster_crs=crs, chip_size=self.chip_size)
            if msliced is not None:
                # QA values are small codes; torch has few uint16 ops.
                qa = msliced[0]
                qa = qa.astype(np.int32) if qa.dtype == np.uint16 else np.ascontiguousarray(qa)
                chip = apply_mask(
                    torch.from_numpy(chip.astype(np.float32)).to(dev)[None],
                    torch.from_numpy(qa).to(dev)[None],
                    self.no_data_value, self.data_source,
                    self.mask_types, self.masking_strategy)[0].cpu().numpy()

        chip = np.clip(chip, 0, 10000)

        seg_map = None
        if not self.is_bbox_feature:
            with GeoTiffReader(os.path.join(self.raster_path,
                                            row["label_filename"])) as r:
                seg_map = r.read(1)
            if seg_map.shape != chip.shape[-2:]:
                log.warning("Skipping %s due to invalid shapes", label_filename)
                return None
            if self.qa_check:
                if not (chip != self.no_data_value).any():
                    return None
                seg_map = mask_segmentation_map(
                    torch.from_numpy(chip.astype(np.float32)).to(dev),
                    torch.from_numpy(seg_map.astype(np.float32)).to(dev),
                    self.no_data_value, self.masking_strategy).cpu().numpy()
                if not (seg_map != NO_DATA_VALUES.SEG_MAP).any():
                    return None

        chip_u16 = np.where(np.isnan(chip), self.no_data_value, chip).astype(np.uint16)
        write_geotiff(chip_path, chip_u16, transform=chip_tr, crs=crs,
                      nodata=self.no_data_value)
        if seg_map is not None:
            seg_dtype = np.int8 if self.task_type == "seg" else np.float32
            seg_out = np.where(np.isnan(seg_map), NO_DATA_VALUES.SEG_MAP,
                               seg_map).astype(seg_dtype)
            write_geotiff(label_path, seg_out[None], transform=chip_tr, crs=crs,
                          nodata=NO_DATA_VALUES.SEG_MAP)
            return chip_path, label_path
        return chip_path, None

    def run(self, dataset: Dict[str, Any], obsv_records: Sequence[Record]
            ) -> List[Record]:
        """Grid-record driven run; returns the Input(/Label) manifest
        records and writes them with an unnamed index column."""
        os.makedirs(os.path.join(self.output_directory, "chips"), exist_ok=True)
        os.makedirs(os.path.join(self.output_directory, "seg_maps"), exist_ok=True)

        tile_cache: Dict[str, Optional[Tuple]] = {}

        def get_tile(key: str) -> Optional[Tuple]:
            if key not in tile_cache:
                tile_cache[key] = self.load_tile(key, dataset)
            return tile_cache[key]

        chip_paths: List[str] = []
        label_paths: List[Optional[str]] = []
        batch = DATA_PIPELINE_SETTINGS.BATCH_SIZE

        def one(row: Record) -> Optional[Tuple[str, Optional[str]]]:
            # One bad row must not kill the batch.
            try:
                loaded = get_tile(row["stac_items_str"])
                if loaded is None:
                    return None
                return self.process_row(dict(row), loaded)
            except Exception as e:
                log.error("Row %s failed: %s", row.get("label_filename"), e)
                return None

        with ThreadPoolExecutor(self.num_workers) as pool:
            for i in range(0, len(obsv_records), batch):
                for res in pool.map(one, obsv_records[i : i + batch]):
                    if res is not None:
                        chip_paths.append(res[0])
                        label_paths.append(res[1])

        if self.is_bbox_feature:
            columns = ["Input"]
            manifest = [{"Input": c} for c in chip_paths]
        else:
            columns = ["Input", "Label"]
            manifest = [{"Input": c, "Label": lab} for c, lab in zip(chip_paths, label_paths)]
        out = os.path.join(self.output_directory,
                           f"{self.data_source.lower()}_raster_dataset.csv")
        write_csv(out, manifest, columns, index=True)
        return manifest
