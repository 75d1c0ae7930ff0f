"""Shared pieces of the port's web-platform tests (no JAX here: the card's
tests import this module too, and the queue's spawned job processes import
it for the job functions below).

* ``_ok_job``, ``_boom``, ``_hang``: queue jobs by import path;
* ``granule_world``: the JAX webapp tests' world (one HLS granule of a 96 px
  tile at 30 m in UTM 33N, six uint16 bands of 100..4999 and a clear
  Fmask, its STAC item as a dict) and a bbox 0.001° inside it;
* ``write_model``: a registry file and ``{models}/toy_model/base`` with the
  given config and checkpoint, as ``serve/registry.py`` reads them.
"""

import json
import os
import shutil
import time

import numpy as np

TILE = 96
CHIP = 32
RES = 30.0
MEAN, STD = [3000.0] * 6, [2000.0] * 6


def _ok_job(**kwargs):
    return {"value": kwargs.get("value", 1)}


def _boom():
    raise RuntimeError("boom")


def _hang():
    time.sleep(600)


def granule_world(root):
    """(STAC item dict, bbox [w, s, e, n]) of a 96 px HLS granule written
    under ``root``."""
    from instageo_tpu_torch.data.crs import latlon_to_utm, utm_to_latlon
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    e0, n0, zone, south = latlon_to_utm(43.0, 15.0)
    ox, oy = float(e0) - (TILE / 2) * RES, float(n0) + (TILE / 2) * RES
    transform = Affine.from_origin(ox, oy, RES, RES)
    rng = np.random.default_rng(0)
    assets = {}
    for b in ["B02", "B03", "B04", "B8A", "B11", "B12"]:
        p = os.path.join(root, f"granule_{b}.tif")
        write_geotiff(p, rng.integers(100, 5000, size=(1, TILE, TILE)).astype(np.uint16),
                      transform=transform, crs=32633, nodata=0)
        assets[b] = {"href": p}
    p = os.path.join(root, "granule_Fmask.tif")
    write_geotiff(p, np.zeros((1, TILE, TILE), np.uint16), transform=transform, crs=32633)
    assets["Fmask"] = {"href": p}
    lat_a, lon_a = utm_to_latlon(ox, oy - TILE * RES, zone, south)
    lat_b, lon_b = utm_to_latlon(ox + TILE * RES, oy, zone, south)
    item = {"id": "HLS.S30.T33TUN.2024151T100000.v2.0", "collection": "HLSS30_2.0",
            "bbox": [float(lon_a), float(lat_a), float(lon_b), float(lat_b)],
            "properties": {"datetime": "2024-05-30T10:00:00Z", "eo:cloud_cover": 2},
            "assets": assets}
    bbox = [float(lon_a) + 0.001, float(lat_a) + 0.001,
            float(lon_b) - 0.001, float(lat_b) - 0.001]
    return item, bbox


def model_overrides():
    """The toy model's config: the tiny encoder at depth 2, 2 classes, 32 px
    chips of 6 bands, float32."""
    return {
        "model.model_name": "prithvi_eo_tiny", "model.depth": 2, "model.num_classes": 2,
        "model.load_pretrained_weights": False, "dataloader.img_size": CHIP,
        "dataloader.bands": [0, 1, 2, 3, 4, 5], "dataloader.mean": MEAN,
        "dataloader.std": STD, "dataloader.no_data_value": 0, "dataloader.num_workers": 0,
        "train.ignore_index": -1, "train.batch_size": 4, "test.img_size": CHIP,
        "test.crop_size": CHIP, "test.stride": CHIP, "tpu.precision": "f32", "tpu.mesh": 1}


def write_model(root, config_yaml: str, checkpoint: str):
    """(registry file, models path) holding ``toy_model`` (size ``base``):
    ``config_yaml`` as its ``.hydra/config.yaml`` and ``checkpoint`` (a
    ``.ckpt`` file or a checkpoint directory) as its best checkpoint."""
    models = os.path.join(root, "models")
    run_dir = os.path.join(models, "toy_model", "base")
    os.makedirs(os.path.join(run_dir, ".hydra"), exist_ok=True)
    with open(os.path.join(run_dir, ".hydra", "config.yaml"), "w") as f:
        f.write(config_yaml)
    if os.path.isdir(checkpoint):
        shutil.copytree(checkpoint, os.path.join(run_dir, "instageo_best_checkpoint"))
    else:
        shutil.copy(checkpoint, os.path.join(run_dir, "instageo_best_checkpoint.ckpt"))
    registry = os.path.join(root, "models_registry.yaml")
    with open(registry, "w") as f:
        f.write("models:\n  toy_model:\n    name: Toy\n    description: tiny test model\n"
                f"    data_source: HLS\n    chip_size: {CHIP}\n    num_steps: 1\n"
                "    default_size: base\n    sizes:\n      base: {}\n")
    return registry, models


def copy_item(item):
    return json.loads(json.dumps(item))
