"""Sentinel-1 RTC source: MPC STAC, vv/vh backscatter, no cloud mask.

The port's own copy of ``instageo_tpu/data/sources/s1.py``: the STAC search
(no cloud-cover query: SAR sees through clouds) and granule selection, the
opener (float32 bands with NaN filled by −1), and the points pipeline.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.pipeline import (
    BaseDataPipeline,
    get_tile_info,
    with_input_features_date,
)
from instageo_tpu_torch.data.settings import BANDS_SETTINGS, S1_API
from instageo_tpu_torch.data.sources.s2 import MPCSigner
from instageo_tpu_torch.data.stac import (
    StacClient,
    find_best_items,
    open_stac_items,
    retrieve_stac_metadata,
)
from instageo_tpu_torch.data.table import Record

log = logging.getLogger(__name__)


def get_client() -> StacClient:
    return StacClient.open(S1_API.URL)


def add_s1_stac_items(
    client: StacClient,
    data: Sequence[Record],
    num_steps: int = 3,
    temporal_step: int = 10,
    temporal_tolerance: int = 12,
    temporal_tolerance_minutes: int = 0,
    **_: Any,
) -> Dict[str, List[Record]]:
    """Search + select the best S1 granules per observation; no cloud-cover
    and no daytime filter."""
    data = with_input_features_date(data)
    tiles_info, tile_queries = get_tile_info(
        data, num_steps=num_steps, temporal_step=temporal_step,
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )
    data = [{**r, "tile_queries": q} for r, q in zip(data, tile_queries)]
    tiles_database = retrieve_stac_metadata(
        client, tiles_info,
        collections=S1_API.COLLECTIONS,
        bands_nameplate=BANDS_SETTINGS.NAMEPLATES,
        cloud_coverage=None,
        daytime_only=False,
    )
    return find_best_items(
        data, tiles_database,
        item_id_field="s1_item_id",
        candidate_items_field="s1_candidate_items",
        items_field="s1_items",
        temporal_tolerance=temporal_tolerance,
        temporal_tolerance_minutes=temporal_tolerance_minutes,
    )


def open_s1_stac_items(tile_dict: Dict[str, Any], load_masks: bool = False,
                       signer: Optional[MPCSigner] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray], Any, int]:
    """Load S1 RTC COGs: float32, fill −1."""
    signer = signer or MPCSigner("sentinel-1-rtc")
    bands, _, transform, crs = open_stac_items(
        tile_dict,
        bands_asset=BANDS_SETTINGS.S1_ASSETS,
        mask_band="",
        load_masks=False,
        fill_value=-1,
        dtype="float32",
        sign_func=signer,
    )
    bands = np.where(np.isnan(bands), -1.0, bands).astype(np.float32)
    return bands, None, transform, crs


class S1PointsPipeline(BaseDataPipeline):
    """Points -> S1 chips + seg maps."""

    @property
    def data_source(self) -> str:
        return "S1"

    def load_tile(self, key: str, dataset: Any) -> Optional[Tuple]:
        tile_dict = dataset[key]
        try:
            bands, masks, transform, crs = open_s1_stac_items(tile_dict)
        except Exception as e:
            log.error("Failed to load S1 tile %s: %s", key, e)
            return None
        granules = tile_dict["granules"]
        first_id = (granules[0].get("id") if isinstance(granules[0], dict)
                    else granules[0].id)
        splits = first_id.split("_")
        tile_id = ("_".join(splits[0:2] + [splits[4]] + splits[6:9])
                   if len(splits) >= 9 else first_id)
        return bands, masks, transform, crs, tile_id
