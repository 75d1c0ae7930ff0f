"""HLS (Harmonized Landsat-Sentinel) source: NASA CMR LPCLOUD STAC.

The port's own copy of ``instageo_tpu/data/sources/hls.py``: the CMR STAC
search and granule selection, the opener (uint16 reflectance clipped to
[0, 10000], Fmask QA), and the points and raster pipelines. EarthData auth
is a bearer token (``EARTHDATA_TOKEN``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.pipeline import (
    BaseDataPipeline,
    BaseRasterPipeline,
    get_raster_tile_info,
    get_tile_info,
    with_input_features_date,
)
from instageo_tpu_torch.data.settings import BANDS_SETTINGS, GDAL_OPTIONS, HLS_API
from instageo_tpu_torch.data.stac import (
    StacClient,
    find_best_items,
    open_stac_items,
    retrieve_stac_metadata,
)
from instageo_tpu_torch.data.table import Record

log = logging.getLogger(__name__)


def decode_fmask_value(value: np.ndarray, position: int) -> np.ndarray:
    """Decode one HLS v2.0 Fmask bit."""
    quotient = value // (2 ** position)
    return quotient - (quotient // 2) * 2


def get_client() -> StacClient:
    return StacClient.open(HLS_API.URL)


def _auth_headers() -> Optional[Dict[str, str]]:
    token = GDAL_OPTIONS.get_access_token()
    return {"Authorization": f"Bearer {token}"} if token else None


def add_hls_stac_items(
    client: StacClient,
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 12,
    temporal_tolerance_minutes: int = 0,
    cloud_coverage: int = 10,
    daytime_only: bool = False,
) -> Dict[str, List[Record]]:
    """Search + select the best HLS granules per observation."""
    data = with_input_features_date(data)
    tiles_info, tile_queries = get_tile_info(
        data, num_steps=num_steps, temporal_step=temporal_step,
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )
    data = [{**r, "tile_queries": q} for r, q in zip(data, tile_queries)]
    tiles_database = retrieve_stac_metadata(
        client, tiles_info,
        collections=HLS_API.COLLECTIONS,
        bands_nameplate=BANDS_SETTINGS.NAMEPLATES,
        cloud_coverage=cloud_coverage,
        daytime_only=daytime_only,
    )
    return find_best_items(
        data, tiles_database,
        item_id_field="hls_item_id",
        candidate_items_field="hls_candidate_items",
        items_field="hls_items",
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )


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


class HLSPointsPipeline(BaseDataPipeline):
    """Points -> HLS chips + seg maps."""

    @property
    def data_source(self) -> str:
        return "HLS"

    def load_tile(self, key: str, dataset: Any) -> Optional[Tuple]:
        tile_dict = dataset[key]
        try:
            bands, masks, transform, crs = open_hls_stac_items(
                tile_dict, load_masks=bool(self.mask_types))
        except Exception as e:
            log.error("Failed to load HLS tile %s: %s", key, e)
            return None
        granules = tile_dict["granules"]
        first_id = (granules[0].get("id") if isinstance(granules[0], dict)
                    else granules[0].id)
        # The chip id takes the {collection}_{tile}_{date} segments of the
        # granule id ('HLS.L30.T38PMB.2022145T072619.v2.0').
        splits = first_id.split(".")
        tile_id = "_".join(splits[1:4]) if len(splits) >= 4 else first_id
        return bands, masks, transform, crs, tile_id


class HLSRasterPipeline(BaseRasterPipeline):
    """Raster/bbox-grid variant."""

    @property
    def data_source(self) -> str:
        return "HLS"

    def load_tile(self, key: str, dataset: Any) -> Optional[Tuple]:
        return HLSPointsPipeline.load_tile(self, key, dataset)


def add_hls_raster_stac_items(
    client: StacClient,
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 12,
    temporal_tolerance_minutes: int = 0,
    cloud_coverage: int = 10,
    daytime_only: bool = False,
) -> Dict[str, List[Record]]:
    """Raster-grid search path: dispatch by each chip bbox's centre."""
    data = with_input_features_date(data)
    tiles_info, tile_queries = get_raster_tile_info(
        data, num_steps=num_steps, temporal_step=temporal_step,
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )
    data = [{**r, "tile_queries": q,
             "x": (r["bbox_4326"][0] + r["bbox_4326"][2]) / 2,
             "y": (r["bbox_4326"][1] + r["bbox_4326"][3]) / 2}
            for r, q in zip(data, tile_queries)]
    tiles_database = retrieve_stac_metadata(
        client, tiles_info,
        collections=HLS_API.COLLECTIONS,
        bands_nameplate=BANDS_SETTINGS.NAMEPLATES,
        cloud_coverage=cloud_coverage,
        daytime_only=daytime_only,
    )
    return find_best_items(
        data, tiles_database,
        item_id_field="hls_item_id",
        candidate_items_field="hls_candidate_items",
        items_field="hls_items",
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )
