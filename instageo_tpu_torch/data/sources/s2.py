"""Sentinel-2 L2A granules: Planetary Computer signing, the SCL mask, the opener.

The port's own copy of the opening half of ``instageo_tpu/data/sources/s2.py``
(the points/raster pipelines wait for ROADMAP item 13). SCL scene classes
{cloud: [8, 9], water: [6]} drive masking.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from instageo_tpu_torch.data.remote_io import UrllibSession
from instageo_tpu_torch.data.settings import BANDS_SETTINGS
from instageo_tpu_torch.data.stac import parse_datetime, open_stac_items

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
