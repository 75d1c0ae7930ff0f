"""HLS (Harmonized Landsat-Sentinel) granules: Fmask decode, auth, the opener.

The port's own copy of the opening half of ``instageo_tpu/data/sources/hls.py``
(the points/raster pipelines wait for ROADMAP item 13): uint16 reflectance
clipped to [0, 10000]; EarthData auth is a bearer token (``EARTHDATA_TOKEN``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from instageo_tpu_torch.data.settings import BANDS_SETTINGS, GDAL_OPTIONS
from instageo_tpu_torch.data.stac import open_stac_items


def decode_fmask_value(value: np.ndarray, position: int) -> np.ndarray:
    """Decode one HLS v2.0 Fmask bit."""
    quotient = value // (2 ** position)
    return quotient - (quotient // 2) * 2


def _auth_headers() -> Optional[Dict[str, str]]:
    token = GDAL_OPTIONS.get_access_token()
    return {"Authorization": f"Bearer {token}"} if token else None


def open_hls_stac_items(tile_dict: Dict[str, Any], load_masks: bool = True
                        ) -> Tuple[np.ndarray, Optional[np.ndarray], Any, int]:
    """Load HLS granule COGs: uint16, clipped 0..10000.

    The band asset names are chosen per granule: a temporal series mixes
    L30 and S30 granules, and L30's NIR/SWIR1/SWIR2 (B05/B06/B07) are S30's
    B8A/B11/B12 (on S30, B05-B07 are red-edge bands).
    """
    granules = tile_dict["granules"]
    band_stacks, mask_stacks = [], []
    transform = crs = None
    for g in granules:
        gid = g.get("id") if isinstance(g, dict) else g.id
        assets = (BANDS_SETTINGS.HLS_L30_ASSETS if ".L30." in gid
                  else BANDS_SETTINGS.HLS_ASSETS)
        b, m, transform, crs = open_stac_items(
            {"granules": [g]},
            bands_asset=assets,
            mask_band=BANDS_SETTINGS.HLS_MASK_ASSET,
            load_masks=load_masks,
            fill_value=0,
            dtype="int32",
            headers=_auth_headers(),
        )
        band_stacks.append(b)
        if m is not None:
            mask_stacks.append(m)
    if len({b.shape[1:] for b in band_stacks}) > 1:
        # Granules of one MGRS grid share a shape; crop to the common
        # extent rather than fail the tile.
        min_h = min(b.shape[1] for b in band_stacks)
        min_w = min(b.shape[2] for b in band_stacks)
        band_stacks = [b[:, :min_h, :min_w] for b in band_stacks]
        mask_stacks = [m[:, :min_h, :min_w] for m in mask_stacks]
    bands = np.concatenate(band_stacks)
    masks = np.concatenate(mask_stacks) if mask_stacks else None
    bands = np.clip(bands, 0, 10000).astype(np.uint16)
    return bands, masks, transform, crs
