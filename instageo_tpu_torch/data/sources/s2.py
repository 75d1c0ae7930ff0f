"""Sentinel-2 L2A source: Microsoft Planetary Computer STAC + SAS signing.

The port's own copy of ``instageo_tpu/data/sources/s2.py``: the STAC search
and granule selection, the opener, and the points and raster pipelines.
SCL scene classes {cloud: [8, 9], water: [6]} drive masking.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.pipeline import (
    BaseDataPipeline,
    BaseRasterPipeline,
    get_tile_info,
    with_input_features_date,
)
from instageo_tpu_torch.data.remote_io import UrllibSession
from instageo_tpu_torch.data.settings import BANDS_SETTINGS, S2_API
from instageo_tpu_torch.data.stac import (
    StacClient,
    find_best_items,
    open_stac_items,
    parse_datetime,
    retrieve_stac_metadata,
)
from instageo_tpu_torch.data.table import Record

log = logging.getLogger(__name__)

_SAS_URL = "https://planetarycomputer.microsoft.com/api/sas/v1/token"


class MPCSigner:
    """Planetary Computer SAS token signer (``planetary_computer.sign``).
    Only ``blob.core.windows.net`` hrefs are signed; others pass untouched."""

    def __init__(self, collection: str = "sentinel-2-l2a", session: Any = None) -> None:
        self.collection = collection
        self.session = session or UrllibSession()
        self._token: Optional[str] = None
        self._expiry = 0.0

    def token(self) -> str:
        if self._token is None or time.time() > self._expiry - 60:
            r = self.session.get(f"{_SAS_URL}/{self.collection}", timeout=30)
            r.raise_for_status()
            payload = r.json()
            self._token = payload["token"]
            expiry = parse_datetime(payload.get("msft:expiry"))
            self._expiry = expiry.timestamp() if expiry is not None else (
                time.time() + 1800)
        return self._token

    def __call__(self, href: str) -> str:
        if "blob.core.windows.net" not in href:
            return href
        sep = "&" if "?" in href else "?"
        return f"{href}{sep}{self.token()}"


def create_mask_from_scl(scl: np.ndarray, classes) -> np.ndarray:
    """SCL class-membership mask."""
    out = np.zeros_like(scl, dtype=np.int32)
    for c in classes:
        out |= (scl == c).astype(np.int32)
    return out


def get_client() -> StacClient:
    return StacClient.open(S2_API.URL)


def add_s2_stac_items(
    client: StacClient,
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 12,
    temporal_tolerance_minutes: int = 0,
    cloud_coverage: int = 10,
    daytime_only: bool = False,
) -> Dict[str, List[Record]]:
    """Search + select the best S2 granules per observation."""
    data = with_input_features_date(data)
    tiles_info, tile_queries = get_tile_info(
        data, num_steps=num_steps, temporal_step=temporal_step,
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )
    data = [{**r, "tile_queries": q} for r, q in zip(data, tile_queries)]
    tiles_database = retrieve_stac_metadata(
        client, tiles_info,
        collections=S2_API.COLLECTIONS,
        bands_nameplate=BANDS_SETTINGS.NAMEPLATES,
        cloud_coverage=cloud_coverage,
        daytime_only=daytime_only,
    )
    return find_best_items(
        data, tiles_database,
        item_id_field="s2_item_id",
        candidate_items_field="s2_candidate_items",
        items_field="s2_items",
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )


def open_s2_stac_items(tile_dict: Dict[str, Any], load_masks: bool = True,
                       signer: Optional[MPCSigner] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray], Any, int]:
    """Load S2 COGs: uint16 bands and the SCL mask."""
    signer = signer or MPCSigner()
    bands, masks, transform, crs = open_stac_items(
        tile_dict,
        bands_asset=BANDS_SETTINGS.S2_ASSETS,
        mask_band=BANDS_SETTINGS.S2_MASK_ASSET,
        load_masks=load_masks,
        fill_value=0,
        dtype="uint16",
        sign_func=signer,
    )
    return bands, masks, transform, crs


class S2PointsPipeline(BaseDataPipeline):
    """Points -> S2 chips + seg maps."""

    @property
    def data_source(self) -> str:
        return "S2"

    def load_tile(self, key: str, dataset: Any) -> Optional[Tuple]:
        tile_dict = dataset[key]
        try:
            bands, masks, transform, crs = open_s2_stac_items(
                tile_dict, load_masks=bool(self.mask_types))
        except Exception as e:
            log.error("Failed to load S2 tile %s: %s", key, e)
            return None
        granules = tile_dict["granules"]
        first_id = (granules[0].get("id") if isinstance(granules[0], dict)
                    else granules[0].id)
        # e.g. S2B_MSIL2A_20220101T..._T33TUN_... -> S2B_MSIL2A_T33TUN_date
        splits = first_id.split("_")
        tile_id = ("_".join([splits[0], splits[1], splits[5], splits[2]])
                   if len(splits) >= 6 else first_id)
        return bands, masks, transform, crs, tile_id


class S2RasterPipeline(BaseRasterPipeline):
    """Raster/bbox-grid S2 variant."""

    @property
    def data_source(self) -> str:
        return "S2"

    def load_tile(self, key: str, dataset: Any) -> Optional[Tuple]:
        return S2PointsPipeline.load_tile(self, key, dataset)
