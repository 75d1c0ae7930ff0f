"""Raster Chip Creator walkthrough
(reference notebooks/raster_chip_creator_demo.ipynb).

Creates chips from *label rasters* (dense segmentation ground truth) or
from raw *bounding boxes* (the web backend's inference path — chips only,
no labels). Fully offline:

    python -m instageo_tpu_torch.examples.raster_chip_creator_demo /tmp/raster_demo [--device cpu]

The port's counterpart of ``examples/raster_chip_creator_demo.py``: the
same runs and files, through the port's CLI
(``data/raster_chip_creator.py:main``); the chips are cut and QA-masked on
``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def run_cli(argv: List[str], device: str = "cuda") -> None:
    from instageo_tpu_torch.data import raster_chip_creator

    raster_chip_creator.main(argv + [f"--device={device}"])


def main(argv: Optional[Sequence[str]] = None) -> None:
    from instageo_tpu_torch.data.crs import utm_to_latlon
    from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
    from instageo_tpu_torch.data.table import write_csv
    from instageo_tpu_torch.examples._scene import (
        CHIP,
        DATE,
        RES,
        build_granule,
        demo_args,
        install_offline_catalog,
    )

    args = demo_args(argv, "/tmp/raster_demo")
    root, device = args.root, args.device
    os.makedirs(root, exist_ok=True)

    print("== Setup: synthetic granule + offline catalog ==")
    scene = build_granule(root)
    with install_offline_catalog(scene):
        print("\n== Use case 1: standard raster processing "
              "(dense label rasters -> chips + seg maps) ==")
        # Like Sen1Floods11's hand-labeled tiles, each label raster is exactly
        # chip-sized; the chip is cut from the granule at the raster's extent.
        origin_x, origin_y = scene["origin"]
        raster_dir = os.path.join(root, "label_rasters")
        os.makedirs(raster_dir, exist_ok=True)
        records = []
        for k in range(2):
            lab = np.zeros((CHIP, CHIP), np.int16)
            yy, xx = np.mgrid[0:CHIP, 0:CHIP]
            lab[np.abs(yy - xx) < 4 + 2 * k] = 1
            tr = Affine.from_origin(origin_x + k * CHIP * RES,
                                    origin_y - k * CHIP * RES, RES, RES)
            name = f"flood_label_{k}.tif"
            write_geotiff(os.path.join(raster_dir, name), lab[None],
                          transform=tr, crs=32633, nodata=-1)
            records.append({"label_filename": name, "date": DATE})
        records_csv = os.path.join(root, "records.csv")
        write_csv(records_csv, records, ["label_filename", "date"])

        out1 = os.path.join(root, "out_raster")
        run_cli([f"--records_file={records_csv}", f"--raster_path={raster_dir}",
                 f"--output_directory={out1}", "--data_source=HLS",
                 f"--chip_size={CHIP}", "--temporal_tolerance=5",
                 "--num_steps=1", "--qa_check=true"], device)
        chips = sorted(glob.glob(os.path.join(out1, "chips", "*.tif")))
        segs = sorted(glob.glob(os.path.join(out1, "seg_maps", "*.tif")))
        print(f"  -> {len(chips)} chips + {len(segs)} seg maps")
        with GeoTiffReader(segs[0]) as r:
            seg = r.read(1)
        print(f"  seg map classes: {sorted(np.unique(seg).tolist())} "
              "(dense labels from the raster)")

        print("\n== Use case 2: bounding-box features "
              "(web-backend path; chips only, no labels) ==")
        lat_s, lon_w = utm_to_latlon(origin_x, origin_y - 64 * RES,
                                     scene["zone"], scene["south"])
        lat_n, lon_e = utm_to_latlon(origin_x + 64 * RES, origin_y,
                                     scene["zone"], scene["south"])
        bbox_json = os.path.join(root, "bounding_boxes.json")
        with open(bbox_json, "w") as f:
            json.dump({"bboxes": [[float(lon_w), float(lat_s),
                                   float(lon_e), float(lat_n)]]}, f)

        out2 = os.path.join(root, "out_bbox")
        run_cli([f"--output_directory={out2}", "--data_source=HLS",
                 f"--chip_size={CHIP}", "--num_steps=1", "--is_bbox_feature=true",
                 f"--bbox_feature_path={bbox_json}", f"--date={DATE}",
                 "--temporal_tolerance=5"], device)
        chips2 = sorted(glob.glob(os.path.join(out2, "chips", "*.tif")))
        segs2 = sorted(glob.glob(os.path.join(out2, "seg_maps", "*.tif")))
        print(f"  -> {len(chips2)} chips, {len(segs2)} seg maps "
              "(bbox mode produces no labels)")

    print("\nS1 note: like the reference, raster chip creation for "
          "Sentinel-1 raises NotImplementedError.")


if __name__ == "__main__":
    main()
