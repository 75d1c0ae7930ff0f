"""Chip Creator CLI: geo-located point observations -> training chips.

    python -m instageo_tpu_torch.data.chip_creator --dataframe_path=obs.csv \\
        --output_directory=out --data_source=HLS [--device=cpu] ...

The port's own copy of ``instageo_tpu/data/chip_creator.py``, with the same
flags (``data/flags.py``, absl's spellings accepted) and output files: read
the observations (CSV, or Parquet through pyarrow where it is installed),
combine date and time, assign MGRS tiles (density filter), search STAC per
source, cache the granule dataset (``{src}_dataset.json``) and the filtered
records for resume, then run the chip pipeline, whose chip math runs on
``--device`` (``cuda`` by default; without a card the CLI raises unless
``--device=cpu`` is given).

One deliberate difference: the JAX CLI caches its filtered records as
Parquet (``filtered_obsv_records.parquet``); this one writes JSON
(``filtered_obsv_records.json``), so it needs neither pandas nor pyarrow.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence

from instageo_tpu_torch.data import flags as _flags
from instageo_tpu_torch.data.pipeline import get_tiles
from instageo_tpu_torch.data.sources import hls, s1, s2
from instageo_tpu_torch.data.stac import create_records_with_items
from instageo_tpu_torch.data.table import (
    Record,
    group_by,
    load_records,
    read_csv,
    save_records,
    to_datetime,
    to_timedelta,
)
from instageo_tpu_torch.device import resolve_device

RECORDS_CACHE = "filtered_obsv_records.json"

DATA_SOURCE_CONFIG: Dict[str, Dict[str, Any]] = {
    "HLS": {
        "add_stac_items_func": hls.add_hls_stac_items,
        "pipeline_class": hls.HLSPointsPipeline,
        "granules_field": "hls_granules",
        "items_field": "hls_items",
        "client_func": hls.get_client,
        "extra_params": ["temporal_tolerance_minutes", "cloud_coverage",
                         "daytime_only"],
    },
    "S2": {
        "add_stac_items_func": s2.add_s2_stac_items,
        "pipeline_class": s2.S2PointsPipeline,
        "granules_field": "s2_granules",
        "items_field": "s2_items",
        "client_func": s2.get_client,
        "extra_params": ["temporal_tolerance_minutes", "cloud_coverage",
                         "daytime_only"],
    },
    "S1": {
        "add_stac_items_func": s1.add_s1_stac_items,
        "pipeline_class": s1.S1PointsPipeline,
        "granules_field": "s1_granules",
        "items_field": "s1_items",
        "client_func": s1.get_client,
        "extra_params": ["temporal_tolerance_minutes"],
    },
}


def parse_filters(raw: list) -> list:
    """col:op:value triplets -> pyarrow filter tuples."""
    filters = []
    for spec in raw:
        col, op, value = spec.split(":", 2)
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        filters.append((col, op, value))
    return filters


def read_observations(path: str, data_format: str, filters: Sequence[str]) -> List[Record]:
    """The observation records of a CSV file, or of a Parquet file through
    pyarrow (imported here; where it is missing, Parquet input is refused)."""
    if data_format != "parquet":
        return read_csv(path)[0]
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("--data_format=parquet reads through pyarrow, which is not "
                          "installed; convert the observations to CSV") from e
    return pq.read_table(path, filters=parse_filters(filters) if filters else None).to_pylist()


def localize_granules(dataset: Dict[str, Any], out_dir: str,
                      data_source: str) -> Dict[str, Any]:
    """Fetch granule assets to ``{out_dir}/granules`` and re-point hrefs.

    ``processing_method='download'`` / ``'download-only'``: whole granule
    assets are fetched locally before chipping, instead of streaming range
    reads from the remote COGs. Already-downloaded valid files are skipped,
    so the step is resumable. Returns the dataset with every fetched asset
    href rewritten to its local file.
    """
    from instageo_tpu_torch.data.downloads import parallel_download

    sign = None
    if data_source in ("S2", "S1"):
        from instageo_tpu_torch.data.sources.s2 import MPCSigner

        sign = MPCSigner("sentinel-1-rtc" if data_source == "S1"
                         else "sentinel-2-l2a")

    granules_dir = os.path.join(out_dir, "granules")
    urls: Dict[str, str] = {}
    slots: Dict[str, list] = {}  # filename -> [(granule_dict, asset_name)]
    for entry in dataset.values():
        for granule in entry.get("granules", []):
            for name, asset in granule.get("assets", {}).items():
                href = asset.get("href", "")
                if not href.startswith(("http://", "https://")):
                    continue  # already local
                ext = os.path.splitext(href.split("?", 1)[0])[1] or ".tif"
                fname = f"{granule['id']}_{name}{ext}"
                urls[fname] = sign(href) if sign else href
                slots.setdefault(fname, []).append((granule, name))

    if not urls:
        return dataset
    logging.info("Downloading %d granule assets to %s", len(urls),
                 granules_dir)
    done = parallel_download(urls, granules_dir,
                             headers={} if sign else None)
    for path in done:
        fname = os.path.basename(path)
        for granule, name in slots.get(fname, []):
            granule["assets"][name]["href"] = path
    missing = len(urls) - len(done)
    if missing:
        logging.warning("%d granule assets failed to download; their "
                        "tiles fall back to remote reads.", missing)
    return dataset


def process_data_source(
    data_source: str,
    sub_data: List[Record],
    add_stac_items_func: Callable,
    pipeline_class: type,
    granules_field: str,
    items_field: str,
    client_func: Callable,
    flags: argparse.Namespace,
    **kwargs: Any,
) -> None:
    """Search/cache/run for one data source."""
    out_dir = flags.output_directory
    dataset_file = os.path.join(out_dir, f"{data_source.lower()}_dataset.json")
    records_file = os.path.join(out_dir, RECORDS_CACHE)

    if not (os.path.exists(dataset_file) and os.path.exists(records_file)):
        logging.info("Creating %s dataset JSON.", data_source)
        os.makedirs(out_dir, exist_ok=True)
        client = client_func()
        with_items = add_stac_items_func(client, sub_data, **kwargs)
        filtered_records, dataset = create_records_with_items(
            with_items, granules_field, items_field)
        with open(dataset_file, "w") as f:
            json.dump(dataset, f, indent=4)
        save_records(records_file, [{k: v for k, v in r.items() if k != "tile_queries"}
                                    for r in filtered_records])
    else:
        logging.info("%s dataset JSON already created", data_source)
        with open(dataset_file) as f:
            dataset = json.load(f)
        filtered_records = load_records(records_file)

    if flags.processing_method in ("download", "download-only"):
        dataset = localize_granules(dataset, out_dir, data_source)
        if flags.processing_method == "download-only":
            logging.info("processing_method=download-only: granules saved "
                         "under %s, skipping chip creation.",
                         os.path.join(out_dir, "granules"))
            return

    logging.info("Creating Chips and Segmentation Maps")
    pipeline = pipeline_class(
        output_directory=out_dir,
        chip_size=flags.chip_size,
        mask_types=list(flags.mask_types),
        masking_strategy=flags.masking_strategy,
        src_crs=flags.src_crs,
        spatial_resolution=flags.spatial_resolution,
        window_size=_flags.chip_window_size(flags),
        task_type=flags.task_type,
        device=flags.device,
    )
    pipeline.run(dataset, group_by(filtered_records, "stac_items_str"))


def month_begin_before(d):
    """``d - pd.offsets.MonthBegin(1)``: the 1st of ``d``'s month, or of the
    month before where ``d`` is already a 1st; the time of day is kept."""
    if d.day == 1:
        d = d - timedelta(days=1)
    return d.replace(day=1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CSV/Parquet Chip Creator entry point; ``argv`` without the program
    name (``sys.argv[1:]`` by default)."""
    flags = _flags.parse_flags(sys.argv[1:] if argv is None else argv,
                               prog="instageo_tpu_torch.data.chip_creator")
    resolve_device(flags.device)  # no card and no --device=cpu: raise before any work
    data = read_observations(flags.dataframe_path, flags.data_format, flags.filters)
    for r in data:
        r["date"] = to_datetime(r["date"])
        if "time" in r:
            r["date"] = r["date"] + to_timedelta(r["time"])
        if flags.shift_to_month_start:
            r["date"] = month_begin_before(r["date"])
        r["input_features_date"] = (r["date"] - timedelta(days=flags.temporal_step)
                                    if flags.is_time_series_task else r["date"])
    num_steps = flags.num_steps if flags.is_time_series_task else 1

    sub_data = get_tiles(data, src_crs=flags.src_crs, min_count=flags.min_count)

    config = DATA_SOURCE_CONFIG[flags.data_source]
    extra = {p: getattr(flags, p) for p in config["extra_params"]}
    process_data_source(
        data_source=flags.data_source,
        sub_data=sub_data,
        add_stac_items_func=config["add_stac_items_func"],
        pipeline_class=config["pipeline_class"],
        granules_field=config["granules_field"],
        items_field=config["items_field"],
        client_func=config["client_func"],
        flags=flags,
        num_steps=num_steps,
        temporal_step=flags.temporal_step,
        temporal_tolerance=flags.temporal_tolerance,
        **extra,
    )


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
