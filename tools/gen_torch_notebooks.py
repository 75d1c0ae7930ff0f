"""Generate the port's notebook-form walkthroughs under ``instageo_tpu_torch/notebooks/``.

The counterpart of ``tools/gen_notebooks.py``: the same five notebooks
(``InstaGeo_Demo``, ``chip_creator_demo``, ``data_cleaner_demo``,
``data_splitter_demo``, ``raster_chip_creator_demo``), cell by cell, in the
port's code. The runnable script form of the same walkthroughs is
``instageo_tpu_torch/examples/``. Each notebook imports ``torch`` and the
port, never JAX, the JAX package or pandas: tables go through
``instageo_tpu_torch/data/table.py``, the export artifact is ``torch.export``'s
``predict.pt2``, and the data CLIs take their flags per call.

The work goes on ``INSTAGEO_DEVICE`` (``cuda`` by default, as everywhere in
the port): the setup cell reads it, and every cell that places work passes
it on (``device=`` to the run CLI, ``--device`` to the chip creators). Set
``INSTAGEO_DEVICE=cpu`` to run them without a card; nothing falls back to
the CPU on its own.

Notebooks are generated, not hand-edited: edit the cells here and re-run

    python tools/gen_torch_notebooks.py

``tests/test_torch_notebooks.py`` holds the checked-in notebooks to this
generator and runs every one in a fresh interpreter.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

Cell = Tuple[str, str]  # ("md" | "code", source)

# ---------------------------------------------------------------------------
# Shared cells
# ---------------------------------------------------------------------------

SETUP = '''\
# Locate the repository root so the notebook runs from a clone without
# installing the package, pick a scratch directory for outputs, and the
# device the work goes on: INSTAGEO_DEVICE, cuda by default (a card is then
# required; set INSTAGEO_DEVICE=cpu to run without one).
import os
import sys
import tempfile

ROOT = os.path.abspath(os.getcwd())
while not os.path.isdir(os.path.join(ROOT, "instageo_tpu_torch")):
    parent = os.path.dirname(ROOT)
    assert parent != ROOT, "run this notebook from inside the repository"
    ROOT = parent
sys.path.insert(0, ROOT)

WORK = os.environ.get("DEMO_DIR") or tempfile.mkdtemp(prefix="instageo_torch_nb_")
os.makedirs(WORK, exist_ok=True)
DEVICE = os.environ.get("INSTAGEO_DEVICE", "cuda")
print("repo root:", ROOT)
print("working directory:", WORK)
print("device:", DEVICE)'''

SCENE = '''\
# Build the shared synthetic satellite scene: a small local "granule"
# (6 HLS-style band GeoTIFFs + an Fmask) plus an offline STAC catalog,
# so the walkthrough needs no credentials or network. The real CLIs
# query NASA CMR / Microsoft Planetary Computer instead. The catalog stays
# installed for the rest of the notebook; `catalog.close()` puts the real
# search back.
import contextlib

from instageo_tpu_torch.examples import _scene as demo_scene

scene = demo_scene.build_granule(WORK)
catalog = contextlib.ExitStack()
catalog.enter_context(demo_scene.install_offline_catalog(scene))
print("granule bands:", sorted(scene["assets"]))'''


def _nb(cells: List[Cell]) -> dict:
    out = []
    for i, (kind, src) in enumerate(cells):
        lines = src.split("\n")
        source = [ln + "\n" for ln in lines[:-1]] + [lines[-1]]
        if kind == "md":
            out.append({"cell_type": "markdown", "id": f"cell-{i}",
                        "metadata": {}, "source": source})
        else:
            out.append({"cell_type": "code", "id": f"cell-{i}",
                        "metadata": {}, "execution_count": None,
                        "outputs": [], "source": source})
    return {
        "cells": out,
        "metadata": {
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python", "version": "3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


# ---------------------------------------------------------------------------
# InstaGeo_Demo: end-to-end train -> eval -> inference -> map -> export
# ---------------------------------------------------------------------------

INSTAGEO_DEMO: List[Cell] = [
    ("md", """\
# InstaGeo end-to-end demo on PyTorch

Train a Prithvi segmentation model on synthetic chips, evaluate it, run
chip inference, render the predictions on an interactive map, and export
a deployable `torch.export` serving artifact — entirely offline, on an
NVIDIA GPU (or the CPU with `INSTAGEO_DEVICE=cpu`), in a couple of minutes.

This is the notebook form of `instageo_tpu_torch/examples/quickstart.py`
and the port's twin of `notebooks/InstaGeo_Demo.ipynb`: the PyTorch model
with its hand-written Hopper attention and dropout kernels, the port's own
GeoTIFF codec, and its run CLI."""),
    ("code", SETUP),
    ("md", """\
## 1. Create a synthetic chip dataset

Sixteen 6-band chips with a learnable signal in band 0 (its value
follows the label), each paired with a segmentation map, written with
the port's own GeoTIFF codec — no GDAL/rasterio needed — and listed in a
CSV by `data/table.py` (no pandas)."""),
    ("code", '''\
import numpy as np

from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.data.table import write_csv

rng = np.random.default_rng(0)
rows = []
for i in range(16):
    arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
    sign = rng.choice([0, 1], size=(2, 2))
    lab = np.repeat(np.repeat(sign, 16, 0), 16, 1).astype(np.int16)
    arr[0] = np.where(lab > 0, 8000, 1000)  # learnable signal in band 0
    tr = Affine.from_origin(499980 + i * 960, 4100040, 30, 30)
    write_geotiff(os.path.join(WORK, f"chip_{i}.tif"), arr, transform=tr,
                  crs=32633, nodata=0)
    write_geotiff(os.path.join(WORK, f"seg_map_{i}.tif"), lab[None],
                  transform=tr, crs=32633, nodata=-1)
    rows.append({"Input": f"chip_{i}.tif", "Label": f"seg_map_{i}.tif"})
write_csv(os.path.join(WORK, "train.csv"), rows, ["Input", "Label"])
print("wrote 16 chips + seg maps to", WORK)'''),
    ("md", """\
## 2. Train

`instageo_tpu_torch.train.run` is the single entrypoint for every mode
(train / eval / chip_inference / sliding_inference / stats / export /
replica); it takes Hydra-style dotted overrides, and `device=` places the
run. Here: a tiny Prithvi variant for 3 epochs. On a real task you would
start from pretrained weights (`model.load_pretrained_weights=True`) and
one of the shipped task configs (`--config-name=sen1floods11`)."""),
    ("code", '''\
from instageo_tpu_torch.train.run import main as run_main

common = [
    f"root_dir={WORK}", f"train_filepath={WORK}/train.csv",
    f"valid_filepath={WORK}/train.csv", f"test_filepath={WORK}/train.csv",
    f"run_dir={WORK}/run", f"device={DEVICE}",
    "model.model_name=prithvi_eo_tiny", "model.load_pretrained_weights=False",
    "dataloader.img_size=32", "dataloader.bands=[0,1,2,3,4,5]",
    "dataloader.mean=[5000,5000,5000,5000,5000,5000]",
    "dataloader.std=[3000,3000,3000,3000,3000,3000]",
    "dataloader.no_data_value=0", "train.ignore_index=-1",
    "train.batch_size=8", "train.num_epochs=3", "train.learning_rate=0.002",
    "test.img_size=32", "test.crop_size=32", "test.stride=32",
]
run_main(["mode=train"] + common)
ckpt = f"{WORK}/run/instageo_best_checkpoint"
print("best checkpoint:", ckpt)'''),
    ("md", """\
## 3. Evaluate and run chip inference

`mode=eval` reports streaming per-class metrics (accuracy, IoU, F1,
AUC); `mode=chip_inference` writes one georeferenced prediction GeoTIFF
per input chip."""),
    ("code", '''\
metrics = run_main(["mode=eval", f"checkpoint_path={ckpt}"] + common)
print(f"test accuracy: {metrics['test_Acc']:.3f}, "
      f"IoU: {metrics['test_IoU']:.3f}")
run_main(["mode=chip_inference", f"checkpoint_path={ckpt}"] + common)'''),
    ("md", """\
## 4. Render the prediction map

`apps.viz` warps the prediction rasters to WGS84 and writes a
self-contained Leaflet HTML map (no server needed)."""),
    ("code", '''\
import glob

from instageo_tpu_torch.apps.viz import create_map_with_geotiff_tiles

preds = sorted(glob.glob(f"{WORK}/predictions/prediction_*.tif"))
out = create_map_with_geotiff_tiles(preds, f"{WORK}/map.html",
                                    threshold=(0.5, 1.0))
print("open", out, "in a browser")'''),
    ("md", """\
## 5. Export a deployable serving artifact

`mode=export` writes a `torch.export` program, `predict.pt2`: the weights
are an argument of each call, the batch size is symbolic, and the
attention is the custom op `instageo_tpu_torch::flash_attn_fwd`, so a
loader that imports none of the port's models serves it
(`serve/export.py:load_predict`)."""),
    ("code", '''\
artifact = run_main(["mode=export", f"checkpoint_path={ckpt}",
                     f"export.path={WORK}/predict.pt2"] + common)
print(f"artifact: {artifact} ({os.path.getsize(artifact)} bytes)")'''),
    ("md", """\
## Next steps

- `chip_creator_demo.ipynb` — build chips from point observations.
- `raster_chip_creator_demo.ipynb` — build chips from label rasters or
  bounding boxes.
- `data_cleaner_demo.ipynb` / `data_splitter_demo.ipynb` — dataset QC
  and leakage-safe splits.
- `instageo_tpu_torch/examples/multichip_training.py` — DP/TP/FSDP
  placements under `torchrun`, one process per card.
- `mode=replica` — the one-command Sen1Floods11 replication runbook."""),
]

# ---------------------------------------------------------------------------
# chip_creator_demo
# ---------------------------------------------------------------------------

RUN_CHIP_CLI = '''\
from instageo_tpu_torch.data import chip_creator
from instageo_tpu_torch.data.table import read_csv


def run_chip_creator(argv):
    # The port's CLIs parse their flags per call; the chip math runs on
    # --device.
    chip_creator.main(argv + [f"--device={DEVICE}"])


def summarize(out_dir):
    import glob
    chips = sorted(glob.glob(os.path.join(out_dir, "chips", "*.tif")))
    segs = sorted(glob.glob(os.path.join(out_dir, "seg_maps", "*.tif")))
    print(f"-> {len(chips)} chips, {len(segs)} seg maps in {out_dir}")
    manifest = os.path.join(out_dir, "hls_dataset.csv")
    if os.path.exists(manifest):
        rows, columns = read_csv(manifest)
        print("  ".join(columns))
        for r in rows:
            print("  ".join(str(r[c])[:48] for c in columns))'''

CHIP_CREATOR: List[Cell] = [
    ("md", """\
# Chip creator

Turn geo-located point observations (a CSV of `x`/`y`/`date`/`label`)
into ML-ready chips and segmentation maps. The CLI searches a STAC
catalog (NASA CMR for HLS, Microsoft Planetary Computer for Sentinel-2)
for granules covering each observation, cuts fixed-size chips around
the points, applies quality masks on `--device`, and writes a dataset
manifest.

This notebook runs fully offline against a synthetic local granule; each
section notes the equivalent online command. Script form:
`instageo_tpu_torch/examples/chip_creator_demo.py`."""),
    ("code", SETUP),
    ("code", SCENE),
    ("code", '''\
from instageo_tpu_torch.data.table import read_csv

obs_csv = os.path.join(WORK, "observations.csv")
demo_scene.write_observations(scene, obs_csv)
for row in read_csv(obs_csv)[0]:
    print(row)'''),
    ("code", RUN_CHIP_CLI),
    ("md", """\
## Example 1: basic HLS chips

32-pixel chips, single timestep. Online equivalent:

```bash
python -m instageo_tpu_torch.data.chip_creator \\
  --dataframe_path=obs.csv --output_directory=out --data_source=HLS
```"""),
    ("code", '''\
out1 = os.path.join(WORK, "out_basic")
run_chip_creator([f"--dataframe_path={obs_csv}",
                  f"--output_directory={out1}",
                  "--data_source=HLS", "--chip_size=32", "--min_count=1",
                  "--shift_to_month_start=false",
                  "--is_time_series_task=false", "--temporal_tolerance=5"])
summarize(out1)'''),
    ("md", """\
## Example 2: cloud masking

`--mask_types=cloud --masking_strategy=any` decodes the granule's Fmask
band and sets cloudy pixels to no-data in every chip. The synthetic
scene has a cloudy 4x4 corner — verify it comes out masked."""),
    ("code", '''\
out2 = os.path.join(WORK, "out_masked")
run_chip_creator([f"--dataframe_path={obs_csv}",
                  f"--output_directory={out2}",
                  "--data_source=HLS", "--chip_size=32", "--min_count=1",
                  "--shift_to_month_start=false",
                  "--is_time_series_task=false", "--mask_types=cloud",
                  "--masking_strategy=any", "--temporal_tolerance=5"])

import glob
from instageo_tpu_torch.data.geotiff import GeoTiffReader

first = sorted(glob.glob(os.path.join(out2, "chips", "*_0_0.tif")))[0]
with GeoTiffReader(first) as r:
    arr = r.read()
print("cloud-masked corner is no-data:", bool((arr[:, :4, :4] == 0).all()))'''),
    ("md", """\
## Example 3: buffered observation points

`--window_size=2` dilates each point label into a (2·2+1)² block in the
segmentation map — useful when a point observation is known to cover an
area rather than a single 30 m pixel."""),
    ("code", '''\
out3 = os.path.join(WORK, "out_buffered")
run_chip_creator([f"--dataframe_path={obs_csv}",
                  f"--output_directory={out3}",
                  "--data_source=HLS", "--chip_size=32", "--min_count=1",
                  "--shift_to_month_start=false",
                  "--is_time_series_task=false", "--window_size=2",
                  "--temporal_tolerance=5"])
with GeoTiffReader(sorted(
        glob.glob(os.path.join(out3, "seg_maps", "*_0_0.tif")))[0]) as r:
    seg = r.read(1)
print("labeled px per point grew to a 5x5 block:", int((seg == 1).sum()))'''),
    ("md", """\
## Example 4: regression task

`--task_type=reg` keeps continuous label values and writes float32
target maps instead of integer class maps."""),
    ("code", '''\
csv_reg = os.path.join(WORK, "observations_reg.csv")
demo_scene.write_observations(scene, csv_reg, value_col=True)
out4 = os.path.join(WORK, "out_regression")
run_chip_creator([f"--dataframe_path={csv_reg}",
                  f"--output_directory={out4}",
                  "--data_source=HLS", "--chip_size=32", "--min_count=1",
                  "--shift_to_month_start=false",
                  "--is_time_series_task=false", "--task_type=reg",
                  "--temporal_tolerance=5"])
with GeoTiffReader(sorted(
        glob.glob(os.path.join(out4, "seg_maps", "*.tif")))[0]) as r:
    seg = r.read(1)
print("float32 target values:", sorted(set(seg[seg != -1].tolist())))'''),
    ("md", """\
## Next steps

Clean the resulting dataset (`data_cleaner_demo.ipynb`), split it
without spatial leakage (`data_splitter_demo.ipynb`), then train with
`instageo_tpu_torch.train.run` (`InstaGeo_Demo.ipynb`)."""),
]

# ---------------------------------------------------------------------------
# data_cleaner_demo
# ---------------------------------------------------------------------------

DATA_CLEANER: List[Cell] = [
    ("md", """\
# Data cleaner

Post-hoc quality control of created chips, three use cases:

1. **Quality filtering** — drop chips whose no-data ratio is too high.
2. **Spatial context** — buffer (dilate) sparse observation labels.
3. **Precise cleaning** — limit seg maps to exact observation pixels.

Fully offline. Script form:
`instageo_tpu_torch/examples/data_cleaner_demo.py`."""),
    ("code", SETUP),
    ("code", SCENE),
    ("md", """\
## Setup: create chips, then poison the dataset

Run the chip creator on the synthetic scene (its chip math on `DEVICE`),
then append a junk chip that is 75% no-data (simulating a mostly-masked
cloudy scene) so the quality filter has something to drop."""),
    ("code", '''\
import numpy as np

from instageo_tpu_torch.data import chip_creator
from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
from instageo_tpu_torch.data.table import read_csv, write_csv

obs_csv = os.path.join(WORK, "observations.csv")
demo_scene.write_observations(scene, obs_csv)
out = os.path.join(WORK, "chips_out")
chip_creator.main([
    f"--dataframe_path={obs_csv}",
    f"--output_directory={out}", "--data_source=HLS", "--chip_size=32",
    "--min_count=1", "--shift_to_month_start=false",
    "--is_time_series_task=false", "--temporal_tolerance=5",
    f"--device={DEVICE}"])

manifest, columns = read_csv(os.path.join(out, "hls_dataset.csv"))
for row in manifest:
    row["Input"] = os.path.join(out, row["Input"])
    row["Label"] = os.path.join(out, row["Label"])

junk = np.zeros((6, 32, 32), np.int16)
junk[:, :8, :] = 1200
junk_path = os.path.join(out, "chips", "chip_20220525_junk_0_9.tif")
tr = Affine.from_origin(0, 960, 30, 30)
write_geotiff(junk_path, junk, transform=tr, crs=32633, nodata=0)
junk_seg = np.full((1, 32, 32), -1, np.int16)
junk_seg_path = os.path.join(out, "seg_maps",
                             "seg_map_20220525_junk_0_9.tif")
write_geotiff(junk_seg_path, junk_seg, transform=tr, crs=32633, nodata=-1)
manifest.append({"Input": junk_path, "Label": junk_seg_path})
csv = os.path.join(WORK, "dataset.csv")
write_csv(csv, manifest, columns)
print(f"dataset: {len(manifest)} chips (one is 75% no-data)")'''),
    ("code", '''\
from instageo_tpu_torch.data import data_cleaner


def run_cleaner(argv):
    data_cleaner.main(argv)


def labeled_px(path):
    with GeoTiffReader(path) as r:
        seg = r.read(1)
    return int((seg != -1).sum())'''),
    ("md", """\
## Use case 1: quality filtering

Drop any chip whose no-data fraction exceeds `no_data_threshold` in any
band (`drop_chips_strategy=any`)."""),
    ("code", '''\
out_csv1 = os.path.join(WORK, "dataset_filtered.csv")
run_cleaner([f"--chips_dataset_csv={csv}",
             f"--output_chips_dataset_csv={out_csv1}",
             "--drop_chips=true", "--drop_chips_strategy=any",
             "--no_data_threshold=0.5", "--no_data_value=0"])
kept = read_csv(out_csv1)[0]
print(f"kept {len(kept)}/{len(manifest)} chips "
      "(dropped the mostly-empty one)")'''),
    ("md", """\
## Use case 2: spatial context

`cleaning_method=buffer` dilates each labeled pixel by `window_size`,
growing point labels into blocks."""),
    ("code", '''\
before = labeled_px(manifest[0]["Label"])
out_csv2 = os.path.join(WORK, "dataset_buffered.csv")
run_cleaner([f"--chips_dataset_csv={out_csv1}",
             f"--output_chips_dataset_csv={out_csv2}",
             "--clean_seg_maps=true", "--cleaning_method=buffer",
             "--window_size=2", "--no_data_value=0",
             f"--seg_map_output_dir={os.path.join(WORK, 'seg_buffered')}"])
after = labeled_px(read_csv(out_csv2)[0][0]["Label"])
print(f"labeled pixels in first seg map: {before} -> {after}")'''),
    ("md", """\
## Use case 3: precise cleaning

`cleaning_method=limit` keeps only the pixels that contain an actual
observation point — the inverse of buffering."""),
    ("code", '''\
out_csv3 = os.path.join(WORK, "dataset_limited.csv")
run_cleaner([f"--chips_dataset_csv={out_csv2}",
             f"--output_chips_dataset_csv={out_csv3}",
             "--clean_seg_maps=true", "--cleaning_method=limit",
             f"--observation_points_csv={obs_csv}",
             f"--seg_map_output_dir={os.path.join(WORK, 'seg_limited')}"])
limited = read_csv(out_csv3)[0]
print("labeled pixels per seg map after limiting:",
      [labeled_px(r["Label"]) for r in limited])'''),
]

# ---------------------------------------------------------------------------
# data_splitter_demo
# ---------------------------------------------------------------------------

DATA_SPLITTER: List[Cell] = [
    ("md", """\
# Data splitter

Split a chip manifest into train/val/test with spatial leakage control:
chips from nearby MGRS tiles land in the same split, so the test set is
spatially disjoint from training. The splitter only reads chip
*filenames* (`chip_{YYYYMMDD}_{sensor}_T{tile}_{x}_{y}.tif`) and runs on
the host (KMeans, scaler and split in numpy), so this runs fully offline
and places nothing on `DEVICE`. Script form:
`instageo_tpu_torch/examples/data_splitter_demo.py`."""),
    ("code", SETUP),
    ("md", """\
## Setup: a manifest over 3 spatial clusters x 2 years"""),
    ("code", '''\
from instageo_tpu_torch.data.table import read_csv, write_csv

clusters = {
    "europe": ["33TUN", "33TUM", "33TVN"],
    "west_africa": ["28PCA", "28PDA", "28PCB"],
    "east_africa": ["37MBN", "37MCN", "37MBM"],
}
rows, i = [], 0
for tiles in clusters.values():
    for tile in tiles:
        for year in (2022, 2023):
            for k in range(6):
                name = f"chips/chip_{year}0615_S30_T{tile}_{i % 7}_{k}.tif"
                rows.append({"Input": name,
                             "Label": name.replace("chip", "seg_map")})
                i += 1
manifest = os.path.join(WORK, "manifest.csv")
write_csv(manifest, rows, ["Input", "Label"])
print(f"manifest: {len(rows)} chips over 9 MGRS tiles, 2 years")'''),
    ("code", '''\
from instageo_tpu_torch.data import data_splitter


def run_splitter(argv):
    # The port's CLIs parse their flags per call.
    data_splitter.main(argv)


def show(out_dir):
    for split in ("train", "val", "test"):
        p = os.path.join(out_dir, f"{split}.csv")
        if os.path.exists(p):
            split_rows = read_csv(p)[0]
            tiles = sorted({r["Input"].split("_T")[1].split("_")[0]
                            for r in split_rows})
            print(f"{split}: {len(split_rows)} chips over tiles {tiles}")'''),
    ("md", """\
## Example 1: KMeans geo-cluster split (default)

Tile centroids are clustered with KMeans; whole clusters are assigned to
splits."""),
    ("code", '''\
out1 = os.path.join(WORK, "kmeans")
run_splitter([f"--input_file={manifest}", f"--output_dir={out1}",
              "--n_clusters=6", "--visualize=false"])
show(out1)'''),
    ("md", """\
## Example 2: connected-MGRS-tile grouping

`--use_kmeans=false`: tiles closer than `distance_threshold` km form
connected groups that stay in the same split — hard spatial-leakage
guarantee."""),
    ("code", '''\
out2 = os.path.join(WORK, "mgrs")
run_splitter([f"--input_file={manifest}", f"--output_dir={out2}",
              "--use_kmeans=false", "--distance_threshold=400",
              "--visualize=false"])
show(out2)'''),
    ("md", """\
## Example 3: train/test only"""),
    ("code", '''\
out3 = os.path.join(WORK, "train_test")
run_splitter([f"--input_file={manifest}", f"--output_dir={out3}",
              "--use_kmeans=false", "--include_val=false",
              "--visualize=false"])
show(out3)'''),
    ("md", """\
## Example 4: custom ratios (10% val, 30% test)"""),
    ("code", '''\
out4 = os.path.join(WORK, "ratios")
run_splitter([f"--input_file={manifest}", f"--output_dir={out4}",
              "--val_ratio=0.1", "--test_ratio=0.3", "--n_clusters=6",
              "--visualize=false"])
show(out4)'''),
    ("md", """\
## Example 5: with split visualizations

`--visualize=true` writes matplotlib maps of split locations and date
histograms next to the CSVs (matplotlib is needed for this example only)."""),
    ("code", '''\
out5 = os.path.join(WORK, "viz")
run_splitter([f"--input_file={manifest}", f"--output_dir={out5}",
              "--n_clusters=6", "--visualize=true"])
print("wrote", sorted(f for f in os.listdir(out5) if f.endswith(".png")))'''),
]

# ---------------------------------------------------------------------------
# raster_chip_creator_demo
# ---------------------------------------------------------------------------

RASTER_CHIP: List[Cell] = [
    ("md", """\
# Raster chip creator

Create chips from *label rasters* (dense segmentation ground truth, like
Sen1Floods11's hand-labeled tiles) or from raw *bounding boxes* (the web
backend's inference path — chips only, no labels), with the chip masking
on `DEVICE`. Fully offline. Script form:
`instageo_tpu_torch/examples/raster_chip_creator_demo.py`."""),
    ("code", SETUP),
    ("code", SCENE),
    ("code", '''\
from instageo_tpu_torch.data import raster_chip_creator


def run_raster_cli(argv):
    # The port's CLIs parse their flags per call; the chip math runs on
    # --device.
    raster_chip_creator.main(argv + [f"--device={DEVICE}"])'''),
    ("md", """\
## Use case 1: dense label rasters -> chips + seg maps

Each label raster is chip-sized; the imagery chip is cut from the
granule at the raster's georeferenced extent."""),
    ("code", '''\
import glob

import numpy as np

from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
from instageo_tpu_torch.data.table import write_csv

CHIP, RES, DATE = demo_scene.CHIP, demo_scene.RES, demo_scene.DATE
origin_x, origin_y = scene["origin"]
raster_dir = os.path.join(WORK, "label_rasters")
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
records_csv = os.path.join(WORK, "records.csv")
write_csv(records_csv, records, ["label_filename", "date"])

out1 = os.path.join(WORK, "out_raster")
run_raster_cli([f"--records_file={records_csv}",
                f"--raster_path={raster_dir}",
                f"--output_directory={out1}", "--data_source=HLS",
                f"--chip_size={CHIP}", "--temporal_tolerance=5",
                "--num_steps=1", "--qa_check=true"])
chips = sorted(glob.glob(os.path.join(out1, "chips", "*.tif")))
segs = sorted(glob.glob(os.path.join(out1, "seg_maps", "*.tif")))
print(f"-> {len(chips)} chips + {len(segs)} seg maps")
with GeoTiffReader(segs[0]) as r:
    seg = r.read(1)
print("seg map classes:", sorted(np.unique(seg).tolist()))'''),
    ("md", """\
## Use case 2: bounding-box features

`--is_bbox_feature=true` takes a JSON of WGS84 bboxes and produces
imagery chips only (no labels) — this is how the web backend prepares
inference inputs for a user-drawn region."""),
    ("code", '''\
import json

from instageo_tpu_torch.data.crs import utm_to_latlon

lat_s, lon_w = utm_to_latlon(origin_x, origin_y - 64 * RES,
                             scene["zone"], scene["south"])
lat_n, lon_e = utm_to_latlon(origin_x + 64 * RES, origin_y,
                             scene["zone"], scene["south"])
bbox_json = os.path.join(WORK, "bounding_boxes.json")
with open(bbox_json, "w") as f:
    json.dump({"bboxes": [[float(lon_w), float(lat_s),
                           float(lon_e), float(lat_n)]]}, f)

out2 = os.path.join(WORK, "out_bbox")
run_raster_cli([f"--output_directory={out2}", "--data_source=HLS",
                f"--chip_size={CHIP}", "--num_steps=1",
                "--is_bbox_feature=true",
                f"--bbox_feature_path={bbox_json}", f"--date={DATE}",
                "--temporal_tolerance=5"])
chips2 = sorted(glob.glob(os.path.join(out2, "chips", "*.tif")))
segs2 = sorted(glob.glob(os.path.join(out2, "seg_maps", "*.tif")))
print(f"-> {len(chips2)} chips, {len(segs2)} seg maps "
      "(bbox mode produces no labels)")'''),
    ("md", """\
Note: like the reference, raster chip creation for Sentinel-1 raises
`NotImplementedError`."""),
]

NOTEBOOKS = {
    "InstaGeo_Demo.ipynb": INSTAGEO_DEMO,
    "chip_creator_demo.ipynb": CHIP_CREATOR,
    "data_cleaner_demo.ipynb": DATA_CLEANER,
    "data_splitter_demo.ipynb": DATA_SPLITTER,
    "raster_chip_creator_demo.ipynb": RASTER_CHIP,
}


def render(name: str) -> str:
    return json.dumps(_nb(NOTEBOOKS[name]), indent=1, ensure_ascii=False) + "\n"


def main(out_dir: str | None = None) -> None:
    out_dir = out_dir or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "instageo_tpu_torch", "notebooks")
    os.makedirs(out_dir, exist_ok=True)
    for name in NOTEBOOKS:
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(render(name))
        print("wrote", path)


if __name__ == "__main__":
    main()
