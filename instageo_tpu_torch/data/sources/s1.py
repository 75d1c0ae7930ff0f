"""Sentinel-1 RTC granules: vv/vh backscatter, no cloud mask.

The port's own copy of ``open_s1_stac_items`` from
``instageo_tpu/data/sources/s1.py``: float32 bands with NaN filled by −1.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from instageo_tpu_torch.data.settings import BANDS_SETTINGS
from instageo_tpu_torch.data.sources.s2 import MPCSigner
from instageo_tpu_torch.data.stac import open_stac_items


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
