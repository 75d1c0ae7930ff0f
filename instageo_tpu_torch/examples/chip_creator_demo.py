"""Chip Creator walkthrough (reference notebooks/chip_creator_demo.ipynb).

Turns geo-located point observations into ML-ready chips + segmentation
maps. Runs fully offline against a synthetic local granule:

    python -m instageo_tpu_torch.examples.chip_creator_demo /tmp/chip_demo [--device cpu]

Covers the notebook's examples: basic HLS usage, cloud masking, buffered
observation points (window_size), and a regression task. Each section
prints the equivalent ONLINE command (real NASA CMR search; needs
EARTHDATA_* credentials). The chip math runs on ``--device`` (``cuda`` by
default).

The port's counterpart of ``examples/chip_creator_demo.py``: the same runs
and files, through the port's CLI (``data/chip_creator.py:main``, whose
flags parse per call).
"""

from __future__ import annotations

import glob
import os
import sys
from typing import List, Optional, Sequence

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def run_cli(argv: List[str], device: str = "cuda") -> None:
    from instageo_tpu_torch.data import chip_creator

    chip_creator.main(argv + [f"--device={device}"])


def summarize(out_dir: str) -> None:
    from instageo_tpu_torch.data.table import read_csv

    chips = sorted(glob.glob(os.path.join(out_dir, "chips", "*.tif")))
    segs = sorted(glob.glob(os.path.join(out_dir, "seg_maps", "*.tif")))
    manifest = os.path.join(out_dir, "hls_dataset.csv")
    print(f"  -> {len(chips)} chips, {len(segs)} seg maps in {out_dir}")
    if os.path.exists(manifest):
        rows, columns = read_csv(manifest)
        print("  " + "  ".join(columns))
        for r in rows:
            print("  " + "  ".join(str(r[c])[:48] for c in columns))


def main(argv: Optional[Sequence[str]] = None) -> None:
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.examples._scene import (
        build_granule,
        demo_args,
        install_offline_catalog,
        write_observations,
    )

    args = demo_args(argv, "/tmp/chip_demo")
    root, device = args.root, args.device
    os.makedirs(root, exist_ok=True)

    print("== Setup: synthetic granule + observations (offline catalog) ==")
    scene = build_granule(root)
    csv = os.path.join(root, "observations.csv")
    write_observations(scene, csv)
    with install_offline_catalog(scene):
        print(f"granule bands: {sorted(scene['assets'])}\nobservations: {csv}\n")

        print("== Example 1: basic HLS chips (32px, single timestep) ==")
        print("online equivalent: python -m instageo_tpu_torch.data.chip_creator \\")
        print("  --dataframe_path=obs.csv --output_directory=out --data_source=HLS")
        out1 = os.path.join(root, "out_basic")
        run_cli([f"--dataframe_path={csv}", f"--output_directory={out1}",
                 "--data_source=HLS", "--chip_size=32", "--min_count=1",
                 "--shift_to_month_start=false", "--is_time_series_task=false",
                 "--temporal_tolerance=5"], device)
        summarize(out1)

        print("\n== Example 2: cloud masking (mask_types=cloud, strategy=any) ==")
        out2 = os.path.join(root, "out_masked")
        run_cli([f"--dataframe_path={csv}", f"--output_directory={out2}",
                 "--data_source=HLS", "--chip_size=32", "--min_count=1",
                 "--shift_to_month_start=false", "--is_time_series_task=false",
                 "--mask_types=cloud", "--masking_strategy=any", "--temporal_tolerance=5"],
                device)
        summarize(out2)
        first = sorted(glob.glob(os.path.join(out2, "chips", "*_0_0.tif")))[0]
        with GeoTiffReader(first) as r:
            arr = r.read()
        print(f"  cloud-masked corner is no-data: {(arr[:, :4, :4] == 0).all()}")

        print("\n== Example 3: buffered observation points (window_size=2) ==")
        out3 = os.path.join(root, "out_buffered")
        run_cli([f"--dataframe_path={csv}", f"--output_directory={out3}",
                 "--data_source=HLS", "--chip_size=32", "--min_count=1",
                 "--shift_to_month_start=false", "--is_time_series_task=false",
                 "--window_size=2", "--temporal_tolerance=5"], device)
        with GeoTiffReader(sorted(
                glob.glob(os.path.join(out3, "seg_maps", "*_0_0.tif")))[0]) as r:
            seg = r.read(1)
        print(f"  labeled pixels per point grew to a 5x5 block: "
              f"{(seg == 1).sum()} labeled px")

        print("\n== Example 4: regression task (continuous labels) ==")
        csv_reg = os.path.join(root, "observations_reg.csv")
        write_observations(scene, csv_reg, value_col=True)
        out4 = os.path.join(root, "out_regression")
        run_cli([f"--dataframe_path={csv_reg}", f"--output_directory={out4}",
                 "--data_source=HLS", "--chip_size=32", "--min_count=1",
                 "--shift_to_month_start=false", "--is_time_series_task=false",
                 "--task_type=reg", "--temporal_tolerance=5"], device)
        with GeoTiffReader(sorted(
                glob.glob(os.path.join(out4, "seg_maps", "*.tif")))[0]) as r:
            seg = r.read(1)
        print(f"  float32 target map, labeled values: "
              f"{sorted(set(seg[seg != -1].tolist()))}")

    print("\nNext steps: data_cleaner_demo.py, data_splitter_demo.py, "
          "then train with instageo_tpu_torch.train.run (see quickstart.py).")


if __name__ == "__main__":
    main()
