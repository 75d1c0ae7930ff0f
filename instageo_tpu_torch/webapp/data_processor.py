"""Data processor: in-process proxy to the raster chip creator.

The port's own copy of ``instageo_tpu/webapp/data_processor.py`` (reference
``instageo/new_apps/backend/app/data_processor.py``): writes
``bounding_boxes.json``, assembles the CLI argv, and invokes the port's
raster chip creator's ``main`` in process, on ``settings.DEVICE``; exposes
chip counts and the manifest CSV path for the prediction stage. The
creator's ``argparse`` parser is built anew on every call, so one task's
optional flags cannot leak into the next.
"""

from __future__ import annotations

import glob
import json
import logging
import os
from typing import Any, Dict, List

from instageo_tpu_torch.webapp.settings import settings

log = logging.getLogger(__name__)


class DataProcessor:
    """Reference DataProcessor surface (:32-172)."""

    def __init__(self, data_dir: str, parameters: Dict[str, Any]) -> None:
        self.data_dir = data_dir
        self.parameters = parameters or {}
        os.makedirs(self.data_dir, exist_ok=True)

    @property
    def data_path(self) -> str:
        return self.data_dir

    @property
    def dataset_csv(self) -> str:
        src = str(self.parameters.get("data_source", "HLS")).lower()
        return os.path.join(self.data_dir, f"{src}_raster_dataset.csv")

    def extract_data_from_bboxes(self, bboxes: List[List[float]]) -> Dict[str, Any]:
        """Write bboxes JSON, run the raster chip creator, count chips.

        Reference :113-172 (flags assembled from the model's registry
        metadata carried in ``parameters``).
        """
        bbox_path = os.path.join(self.data_dir, "bounding_boxes.json")
        with open(bbox_path, "w") as f:
            json.dump({"bboxes": bboxes}, f)

        p = self.parameters
        argv = [
            f"--output_directory={self.data_dir}",
            "--is_bbox_feature=true",
            f"--bbox_feature_path={bbox_path}",
            f"--date={p.get('date', '2024-06-01')}",
            f"--data_source={p.get('data_source', 'HLS')}",
            f"--chip_size={p.get('chip_size', 224)}",
            f"--num_steps={p.get('num_steps', 1)}",
            f"--temporal_step={p.get('temporal_step', 30)}",
            f"--temporal_tolerance={p.get('temporal_tolerance', 5)}",
            f"--cloud_coverage={p.get('cloud_coverage', 10)}",
            f"--spatial_resolution={p.get('spatial_resolution', 0.0002694945852358564)}",
        ]
        if p.get("mask_types"):
            argv.append(f"--mask_types={','.join(p['mask_types'])}")
        argv.append(f"--device={settings.DEVICE}")

        from instageo_tpu_torch.data import raster_chip_creator

        raster_chip_creator.main(argv)

        chips = glob.glob(os.path.join(self.data_dir, "chips", "*.tif"))
        # The raster pipeline writes absolute Input paths and an index
        # column; rewrite the manifest as pandas' read_csv(index_col=0) /
        # to_csv(index=False) would, with Input relative to data_path.
        csv = self.dataset_csv
        if os.path.exists(csv):
            from instageo_tpu_torch.data.table import read_csv, write_csv

            rows, columns = read_csv(csv)
            columns = columns[1:]
            for r in rows:
                if "Input" in columns:
                    r["Input"] = os.path.relpath(str(r["Input"]), self.data_dir)
            write_csv(csv, rows, columns)
        return {"chip_count": len(chips), "data_path": self.data_dir,
                "dataset_csv": csv}
