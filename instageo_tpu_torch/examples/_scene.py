"""Shared synthetic satellite scene for the offline demos.

Builds a small local "granule" (6 HLS-style band GeoTIFFs + Fmask) around
a known lat/lon and an observation CSV over it, and installs an offline
catalog: while ``install_offline_catalog``'s block runs, ``StacClient.search``
answers from the local scene instead of the network, so every demo runs
end to end with zero credentials; the block's end puts the real search
back. The real CLIs hit NASA CMR / Microsoft Planetary Computer instead:
each demo prints the equivalent online command.

The port's copy of ``examples/_scene.py``: the same files, byte for byte,
written with the port's GeoTIFF writer and ``data/table.py`` (no pandas).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from datetime import datetime, timezone
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.crs import latlon_to_utm, to_mgrs, utm_to_latlon
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.data.stac import StacClient, StacItem
from instageo_tpu_torch.data.table import write_csv

TILE_SIZE = 96
CHIP = 32
RES = 30.0
# Comfortably inside MGRS square 33TWH (15.0 sits on the 33TVH boundary).
LAT0, LON0 = 43.0, 15.5
EPSG = 32633
DATE = "2022-05-25"


def build_granule(root: str, cloud_corner: bool = True) -> Dict:
    """Write band + Fmask GeoTIFFs; return geometry info and asset paths."""
    e0, n0, zone, south = latlon_to_utm(LAT0, LON0)
    origin_x = float(e0) - (TILE_SIZE / 2) * RES
    origin_y = float(n0) + (TILE_SIZE / 2) * RES
    transform = Affine.from_origin(origin_x, origin_y, RES, RES)

    rng = np.random.default_rng(0)
    assets = {}
    for i, band in enumerate(["B02", "B03", "B04", "B8A", "B11", "B12"]):
        arr = rng.integers(100 + i * 10, 5000,
                           size=(TILE_SIZE, TILE_SIZE)).astype(np.uint16)
        path = os.path.join(root, f"granule_{band}.tif")
        write_geotiff(path, arr[None], transform=transform, crs=EPSG, nodata=0)
        assets[band] = path
    fmask = np.zeros((TILE_SIZE, TILE_SIZE), np.uint16)
    if cloud_corner:
        fmask[:4, :4] = 2  # cloud bit (MASK_DECODING_POS cloud=1 -> value 2)
    pmask = os.path.join(root, "granule_Fmask.tif")
    write_geotiff(pmask, fmask[None], transform=transform, crs=EPSG)
    assets["Fmask"] = pmask

    lat_a, lon_a = utm_to_latlon(origin_x, origin_y - TILE_SIZE * RES,
                                 zone, south)
    lat_b, lon_b = utm_to_latlon(origin_x + TILE_SIZE * RES, origin_y,
                                 zone, south)
    return {
        "assets": assets,
        "origin": (origin_x, origin_y),
        "zone": zone,
        "south": south,
        "bbox_4326": (float(lon_a), float(lat_a), float(lon_b), float(lat_b)),
    }


@contextlib.contextmanager
def install_offline_catalog(scene: Dict) -> Iterator[StacItem]:
    """Answer STAC searches from the local scene (offline demo mode) while
    the block runs; the block's end restores ``StacClient.search``."""
    tile = to_mgrs(LAT0, LON0, 0)  # the true MGRS tile of the scene
    item = StacItem(
        id=f"HLS.S30.T{tile}.2022145T100000.v2.0",
        collection="HLSS30_2.0",
        bbox=scene["bbox_4326"],
        datetime=datetime.fromisoformat(f"{DATE}T10:00:00").replace(tzinfo=timezone.utc),
        properties={"eo:cloud_cover": 5},
        assets=scene["assets"],
    )
    search = StacClient.search
    StacClient.search = lambda self, **kw: [item]  # type: ignore[assignment]
    try:
        yield item
    finally:
        StacClient.search = search  # type: ignore[assignment]


def write_observations(scene: Dict, csv_path: str,
                       labels: Tuple[int, ...] = (1, 0, 1),
                       value_col: bool = False) -> List[Dict]:
    """Point observations inside chips (0,0) and (1,1) of the granule."""
    origin_x, origin_y = scene["origin"]
    pts_utm = [
        (origin_x + 5 * RES, origin_y - 5 * RES),
        (origin_x + (CHIP + 5) * RES, origin_y - (CHIP + 7) * RES),
        (origin_x + 6 * RES, origin_y - 8 * RES),
    ]
    rows = []
    for (x, y), label in zip(pts_utm, labels):
        lat, lon = utm_to_latlon(x, y, scene["zone"], scene["south"])
        row = {"x": float(lon), "y": float(lat), "date": DATE}
        if value_col:
            row["label"] = float(label) * 12.5  # continuous target
        else:
            row["label"] = int(label)
        rows.append(row)
    write_csv(csv_path, rows, ["x", "y", "date", "label"])
    return rows


def demo_args(argv: Optional[Sequence[str]], default_root: str,
              device: bool = True) -> argparse.Namespace:
    """A demo's command line: ``[root]``, and ``[--device DEVICE]`` where it
    has chip math."""
    parser = argparse.ArgumentParser()
    parser.add_argument("root", nargs="?", default=default_root)
    if device:
        parser.add_argument("--device", default="cuda",
                            help="Device of the chip math: 'cuda' (a card is required) or "
                                 "'cpu'.")
    return parser.parse_args(argv)
