"""Data Splitter walkthrough (reference notebooks/data_splitter_demo.ipynb).

Splits a chip manifest into train/val/test with spatial leakage control.
Fully offline (the splitter only reads chip *filenames*):

    python -m instageo_tpu_torch.examples.data_splitter_demo /tmp/split_demo

Covers: basic KMeans geo-cluster splitting, connected-MGRS-tile grouping,
train/test-only splits, custom ratios, and disabling visualizations.

The port's counterpart of ``examples/data_splitter_demo.py``, through the
port's CLI (``data/data_splitter.py:main``: KMeans, scaler and split in
numpy, on the host).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def make_manifest(path: str) -> List[Dict[str, str]]:
    """Chip filenames spread over 3 spatial clusters x 2 years.

    The splitter derives location from the MGRS tile id and the year from
    the date embedded in ``chip_{YYYYMMDD}_{sensor}_T{tile}_{x}_{y}.tif``.
    """
    from instageo_tpu_torch.data.table import write_csv

    clusters = {
        "europe": ["33TUN", "33TUM", "33TVN"],
        "west_africa": ["28PCA", "28PDA", "28PCB"],
        "east_africa": ["37MBN", "37MCN", "37MBM"],
    }
    rows = []
    i = 0
    for tiles in clusters.values():
        for tile in tiles:
            for year in (2022, 2023):
                for k in range(6):
                    name = (f"chips/chip_{year}0615_S30_T{tile}_"
                            f"{i % 7}_{k}.tif")
                    rows.append({"Input": name,
                                 "Label": name.replace("chip", "seg_map")})
                    i += 1
    write_csv(path, rows, ["Input", "Label"])
    return rows


def run_cli(argv: List[str]) -> None:
    from instageo_tpu_torch.data import data_splitter

    data_splitter.main(argv)


def show(out_dir: str) -> None:
    from instageo_tpu_torch.data.table import read_csv

    for split in ("train", "val", "test"):
        p = os.path.join(out_dir, f"{split}.csv")
        if os.path.exists(p):
            rows = read_csv(p)[0]
            tiles = sorted({r["Input"].split("_T")[1].split("_")[0] for r in rows})
            print(f"  {split}: {len(rows)} chips over tiles {tiles}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    from instageo_tpu_torch.examples._scene import demo_args

    root = demo_args(argv, "/tmp/split_demo", device=False).root
    os.makedirs(root, exist_ok=True)
    manifest = os.path.join(root, "manifest.csv")
    rows = make_manifest(manifest)
    print(f"manifest: {len(rows)} chips over 9 MGRS tiles, 2 years\n")

    print("== Example 1: basic KMeans geo-cluster split (default) ==")
    out1 = os.path.join(root, "kmeans")
    run_cli([f"--input_file={manifest}", f"--output_dir={out1}",
             "--n_clusters=6", "--visualize=false"])
    show(out1)

    print("\n== Example 2: connected-MGRS-tile grouping "
          "(use_kmeans=false; tiles closer than distance_threshold km "
          "stay in the same split — no spatial leakage) ==")
    out2 = os.path.join(root, "mgrs")
    run_cli([f"--input_file={manifest}", f"--output_dir={out2}",
             "--use_kmeans=false", "--distance_threshold=400",
             "--visualize=false"])
    show(out2)

    print("\n== Example 3: train/test only (no validation split) ==")
    out3 = os.path.join(root, "train_test")
    run_cli([f"--input_file={manifest}", f"--output_dir={out3}",
             "--use_kmeans=false", "--include_val=false",
             "--visualize=false"])
    show(out3)

    print("\n== Example 4: custom ratios (10% val, 30% test) ==")
    out4 = os.path.join(root, "ratios")
    run_cli([f"--input_file={manifest}", f"--output_dir={out4}",
             "--val_ratio=0.1", "--test_ratio=0.3", "--n_clusters=6",
             "--visualize=false"])
    show(out4)

    print("\n== Example 5: with split visualizations (matplotlib maps) ==")
    out5 = os.path.join(root, "viz")
    run_cli([f"--input_file={manifest}", f"--output_dir={out5}",
             "--n_clusters=6", "--visualize=true"])
    pngs = [f for f in os.listdir(out5) if f.endswith(".png")]
    print(f"  wrote {sorted(pngs)}")


if __name__ == "__main__":
    main()
