"""STAC items and granule opening: what whole-granule inference needs.

The port's own copy of the loading half of ``instageo_tpu/data/stac.py``:
:class:`StacItem` (timestamps by ``datetime.fromisoformat``, not pandas),
``is_valid_dataset_entry``, the rate-limited and retried asset load, and
``open_stac_items``, which stacks a tile's granule COGs into the
(T·C, H, W) band layout (``{band}_{t}`` order) that the chip ops and the
granule path consume. The search and selection functions wait for the
data CLIs (ROADMAP item 13).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.remote_io import NETWORK_ERRORS, open_remote_geotiff
from instageo_tpu_torch.data.settings import DATA_PIPELINE_SETTINGS
from instageo_tpu_torch.utils.ratelimit import rate_limited, retry_backoff

log = logging.getLogger(__name__)


def parse_datetime(value: Optional[str]) -> Optional[datetime]:
    """An ISO-8601 timestamp in UTC (a naive one is taken as UTC), or None."""
    if not value:
        return None
    dt = datetime.fromisoformat(str(value).replace("Z", "+00:00"))
    if dt.tzinfo is None:
        return dt.replace(tzinfo=timezone.utc)
    return dt.astimezone(timezone.utc)


@dataclass
class StacItem:
    """Minimal STAC item: what the loading path needs."""

    id: str
    collection: str
    bbox: Tuple[float, float, float, float]
    datetime: Optional[datetime]
    properties: Dict[str, Any] = field(default_factory=dict)
    assets: Dict[str, str] = field(default_factory=dict)  # name -> href

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "StacItem":
        dt = parse_datetime(d.get("properties", {}).get("datetime"))
        assets = {k: v.get("href", "") for k, v in d.get("assets", {}).items()}
        return cls(
            id=d["id"],
            collection=d.get("collection", ""),
            bbox=tuple(d.get("bbox", (0, 0, 0, 0))),
            datetime=dt,
            properties=d.get("properties", {}),
            assets=assets,
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "collection": self.collection,
            "bbox": list(self.bbox),
            "properties": {**self.properties,
                           "datetime": self.datetime.isoformat() if self.datetime else None},
            "assets": {k: {"href": v} for k, v in self.assets.items()},
        }


def is_valid_dataset_entry(granules: Sequence[Optional[str]]) -> bool:
    """All timesteps found and unique."""
    if any(g is None for g in granules):
        return False
    return len(granules) == len(set(granules))


@rate_limited(DATA_PIPELINE_SETTINGS.COG_DOWNLOAD_RATELIMIT, 60)
@retry_backoff(NETWORK_ERRORS + (ValueError,), max_tries=5, max_time=300)
def _load_asset(href: str, headers: Optional[Dict[str, str]] = None) -> Tuple:
    if href.startswith(("http://", "https://")):
        reader = open_remote_geotiff(href, headers=headers)
    else:
        from instageo_tpu_torch.data.geotiff import GeoTiffReader

        reader = GeoTiffReader(href)
    with reader as r:
        return r.read(1), r.transform, r.crs


def open_stac_items(
    tile_dict: Dict[str, Any],
    bands_asset: List[str],
    mask_band: str,
    load_masks: bool = False,
    fill_value: float = 0,
    dtype: str = "uint16",
    sign_func: Optional[Callable[[str], str]] = None,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], Any, int]:
    """Load granule COGs into the (T·C, H, W) band-stacked layout.

    Band order is ``b0_t0, b1_t0, …, b0_t1, …``. Returns (bands, masks |
    None, transform, epsg). Assets of one tile come at mixed resolutions on
    nesting grids (S2: 10980² at 10 m, 5490² at 20 m); coarser planes are
    upsampled to the finest by integer repetition (nearest neighbour) and
    the finest plane's transform is returned. Shapes that do not nest are
    cropped to their common extent, with a warning.
    """
    granules = [StacItem.from_dict(g) if isinstance(g, dict) else g
                for g in tile_dict["granules"]]
    band_planes: List[Tuple[np.ndarray, Any, int]] = []
    mask_planes: List[Tuple[np.ndarray, Any, int]] = []
    for granule in granules:
        for asset in bands_asset:
            href = granule.assets[asset]
            if sign_func:
                href = sign_func(href)
            band_planes.append(_load_asset(href, headers))
        if load_masks:
            href = granule.assets[mask_band]
            if sign_func:
                href = sign_func(href)
            mask_planes.append(_load_asset(href, headers))

    all_planes = band_planes + mask_planes
    max_h = max(p.shape[0] for p, _, _ in all_planes)
    max_w = max(p.shape[1] for p, _, _ in all_planes)
    nesting = all(max_h % p.shape[0] == 0 and max_w % p.shape[1] == 0
                  for p, _, _ in all_planes)

    def _to_finest(p: np.ndarray) -> np.ndarray:
        fh, fw = max_h // p.shape[0], max_w // p.shape[1]
        if fh == 1 and fw == 1:
            return p
        return np.repeat(np.repeat(p, fh, axis=0), fw, axis=1)

    if nesting:
        transform, crs = next((t, c) for p, t, c in all_planes
                              if p.shape == (max_h, max_w))
        bands = np.stack([_to_finest(p) for p, _, _ in band_planes]
                         ).astype(dtype)
        masks = (np.stack([_to_finest(p) for p, _, _ in mask_planes])
                 if mask_planes else None)
        return bands, masks, transform, crs

    log.warning("open_stac_items: non-nesting plane shapes %s — cropping "
                "to the smallest common extent",
                sorted({p.shape for p, _, _ in all_planes}))
    min_h = min(p.shape[0] for p, _, _ in all_planes)
    min_w = min(p.shape[1] for p, _, _ in all_planes)
    transform, crs = next(
        (t, c) for p, t, c in all_planes if p.shape[0] == min_h)
    bands = np.stack([p[:min_h, :min_w] for p, _, _ in band_planes]
                     ).astype(dtype)
    masks = (np.stack([p[:min_h, :min_w] for p, _, _ in mask_planes])
             if mask_planes else None)
    return bands, masks, transform, crs
