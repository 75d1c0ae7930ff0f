"""Data Cleaner walkthrough (reference notebooks/data_cleaner_demo.ipynb).

Post-hoc quality control of created chips. Fully offline:

    python -m instageo_tpu_torch.examples.data_cleaner_demo /tmp/clean_demo [--device cpu]

Covers the notebook's three use cases:
1. Quality filtering   — drop chips whose no-data ratio is too high.
2. Spatial context     — buffer (dilate) sparse observation labels.
3. Precise cleaning    — limit seg maps to exact observation pixels.

The port's counterpart of ``examples/data_cleaner_demo.py``: the chips are
made by the port's chip creator on ``--device`` (``cuda`` by default); the
cleaner (``data/data_cleaner.py:main``) runs on the host.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

import numpy as np

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def run_cleaner(argv: List[str]) -> None:
    from instageo_tpu_torch.data import data_cleaner

    data_cleaner.main(argv)


def labeled_px(path: str) -> int:
    from instageo_tpu_torch.data.geotiff import GeoTiffReader

    with GeoTiffReader(path) as r:
        seg = r.read(1)
    return int((seg != -1).sum())


def main(argv: Optional[Sequence[str]] = None) -> None:
    from instageo_tpu_torch.data import chip_creator
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
    from instageo_tpu_torch.data.table import read_csv, write_csv
    from instageo_tpu_torch.examples._scene import (
        build_granule,
        demo_args,
        install_offline_catalog,
        write_observations,
    )

    args = demo_args(argv, "/tmp/clean_demo")
    root = args.root
    os.makedirs(root, exist_ok=True)

    print("== Setup: create chips with the chip creator (offline) ==")
    scene = build_granule(root)
    obs_csv = os.path.join(root, "observations.csv")
    write_observations(scene, obs_csv)
    out = os.path.join(root, "chips_out")
    with install_offline_catalog(scene):
        chip_creator.main([
            f"--dataframe_path={obs_csv}", f"--output_directory={out}",
            "--data_source=HLS", "--chip_size=32", "--min_count=1",
            "--shift_to_month_start=false", "--is_time_series_task=false",
            "--temporal_tolerance=5", f"--device={args.device}"])

    manifest, columns = read_csv(os.path.join(out, "hls_dataset.csv"))
    for row in manifest:
        row["Input"] = os.path.join(out, row["Input"])
        row["Label"] = os.path.join(out, row["Label"])

    # Append a junk chip that is 75% no-data (simulates a mostly-masked
    # cloud scene) so the quality filter has something to drop.
    junk = np.zeros((6, 32, 32), np.int16)
    junk[:, :8, :] = 1200
    junk_path = os.path.join(out, "chips", "chip_20220525_junk_0_9.tif")
    tr = Affine.from_origin(0, 960, 30, 30)
    write_geotiff(junk_path, junk, transform=tr, crs=32633, nodata=0)
    junk_seg = np.full((1, 32, 32), -1, np.int16)
    junk_seg_path = os.path.join(out, "seg_maps", "seg_map_20220525_junk_0_9.tif")
    write_geotiff(junk_seg_path, junk_seg, transform=tr, crs=32633, nodata=-1)
    manifest.append({"Input": junk_path, "Label": junk_seg_path})
    csv = os.path.join(root, "dataset.csv")
    write_csv(csv, manifest, columns)
    print(f"dataset: {len(manifest)} chips (one is 75% no-data)\n")

    print("== Use case 1: quality filtering (drop no-data chips) ==")
    out_csv1 = os.path.join(root, "dataset_filtered.csv")
    run_cleaner([f"--chips_dataset_csv={csv}",
                 f"--output_chips_dataset_csv={out_csv1}",
                 "--drop_chips=true", "--drop_chips_strategy=any",
                 "--no_data_threshold=0.5", "--no_data_value=0"])
    kept = read_csv(out_csv1)[0]
    print(f"  kept {len(kept)}/{len(manifest)} chips "
          f"(dropped the mostly-empty one)\n")

    print("== Use case 2: spatial context (buffer labels by 2px) ==")
    before = labeled_px(manifest[0]["Label"])
    out_csv2 = os.path.join(root, "dataset_buffered.csv")
    run_cleaner([f"--chips_dataset_csv={out_csv1}",
                 f"--output_chips_dataset_csv={out_csv2}",
                 "--clean_seg_maps=true", "--cleaning_method=buffer",
                 "--window_size=2", "--no_data_value=0",
                 f"--seg_map_output_dir={os.path.join(root, 'seg_buffered')}"])
    buffered = read_csv(out_csv2)[0]
    after = labeled_px(buffered[0]["Label"])
    print(f"  labeled pixels in first seg map: {before} -> {after}\n")

    print("== Use case 3: precise cleaning (limit to observation pixels) ==")
    out_csv3 = os.path.join(root, "dataset_limited.csv")
    run_cleaner([f"--chips_dataset_csv={out_csv2}",
                 f"--output_chips_dataset_csv={out_csv3}",
                 "--clean_seg_maps=true", "--cleaning_method=limit",
                 f"--observation_points_csv={obs_csv}",
                 f"--seg_map_output_dir={os.path.join(root, 'seg_limited')}"])
    limited = read_csv(out_csv3)[0]
    counts = [labeled_px(r["Label"]) for r in limited]
    print(f"  labeled pixels per seg map after limiting: {counts} "
          "(back to the exact observation points)")


if __name__ == "__main__":
    main()
