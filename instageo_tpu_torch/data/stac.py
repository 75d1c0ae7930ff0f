"""STAC client, item selection and granule opening.

The port's own copy of ``instageo_tpu/data/stac.py``, without pandas or
requests:

* :class:`StacItem` (timestamps by ``datetime.fromisoformat``) and
  :class:`StacClient`: POST ``/search`` over ``urllib`` with pagination
  through ``links[rel=next]``; ``retrieve_stac_metadata`` searches per tile,
  rate limited (10 searches a minute) and retried with backoff;
* the daytime filter (a NOAA sunrise/sunset computation on ``datetime``);
* candidate dispatch (point in item footprint), per-timestep closest-item
  selection by least cloud cover within a temporal tolerance, and the
  validity rule (every timestep found, all distinct), over records (lists
  of dicts, ``data/table.py``) where the JAX package has DataFrames;
* ``open_stac_items``, which stacks a tile's granule COGs into the
  (T·C, H, W) band layout (``{band}_{t}`` order) that the chip ops and the
  granule path consume.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.geo_utils import make_valid_bbox, point_within
from instageo_tpu_torch.data.remote_io import (
    NETWORK_ERRORS,
    UrllibSession,
    open_remote_geotiff,
)
from instageo_tpu_torch.data.settings import DATA_PIPELINE_SETTINGS
from instageo_tpu_torch.data.table import Record, drop_duplicates
from instageo_tpu_torch.utils.ratelimit import rate_limited, retry_backoff

log = logging.getLogger(__name__)


class StacAPIError(RuntimeError):
    pass


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


class StacClient:
    """Minimal pystac-client replacement: POST search with pagination.
    ``session``: any object with ``post(url, json=, headers=, timeout=)``
    (``remote_io.UrllibSession`` by default)."""

    def __init__(self, url: str, session: Any = None,
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.url = url.rstrip("/")
        self.session = session or UrllibSession()
        self.headers = headers or {}

    @classmethod
    def open(cls, url: str, **kw) -> "StacClient":
        return cls(url, **kw)

    def search(
        self,
        collections: Sequence[str],
        datetime: Optional[str] = None,
        bbox: Optional[Sequence[float]] = None,
        query: Optional[Dict] = None,
        sortby: Optional[List[Dict]] = None,
        limit: int = 100,
        max_items: int = 1000,
    ) -> List[StacItem]:
        body: Dict[str, Any] = {"collections": list(collections), "limit": limit}
        if datetime:
            body["datetime"] = datetime
        if bbox:
            body["bbox"] = list(bbox)
        if query:
            body["query"] = query
        if sortby:
            body["sortby"] = sortby
        items: List[StacItem] = []
        url = f"{self.url}/search"
        next_body = body
        while url and len(items) < max_items:
            r = self.session.post(url, json=next_body, headers=self.headers,
                                  timeout=60)
            if r.status_code >= 400:
                raise StacAPIError(f"{r.status_code}: {r.text[:200]}")
            page = r.json()
            items.extend(StacItem.from_dict(f) for f in page.get("features", []))
            url = None
            for link in page.get("links", []):
                if link.get("rel") == "next":
                    url = link.get("href")
                    next_body = link.get("body", body)
                    break
        return items


# ---------------------------------------------------------------------------
# Solar daytime check (astral replacement)
# ---------------------------------------------------------------------------


def _sunrise_sunset_utc(lat: float, lon: float, date: datetime
                        ) -> Optional[Tuple[datetime, datetime]]:
    """NOAA solar calculation; returns (sunrise, sunset) UTC or None (polar)."""
    day_of_year = date.timetuple().tm_yday
    gamma = 2 * math.pi / 365 * (day_of_year - 1 + (12 - 12) / 24)
    eqtime = 229.18 * (0.000075 + 0.001868 * math.cos(gamma)
                       - 0.032077 * math.sin(gamma)
                       - 0.014615 * math.cos(2 * gamma)
                       - 0.040849 * math.sin(2 * gamma))
    decl = (0.006918 - 0.399912 * math.cos(gamma) + 0.070257 * math.sin(gamma)
            - 0.006758 * math.cos(2 * gamma) + 0.000907 * math.sin(2 * gamma)
            - 0.002697 * math.cos(3 * gamma) + 0.00148 * math.sin(3 * gamma))
    lat_r = math.radians(lat)
    zenith = math.radians(90.833)
    cos_ha = (math.cos(zenith) / (math.cos(lat_r) * math.cos(decl))
              - math.tan(lat_r) * math.tan(decl))
    if cos_ha > 1 or cos_ha < -1:
        return None  # polar day/night
    ha = math.degrees(math.acos(cos_ha))
    base = datetime(date.year, date.month, date.day, tzinfo=timezone.utc)
    sunrise_min = 720 - 4 * (lon + ha) - eqtime
    sunset_min = 720 - 4 * (lon - ha) - eqtime
    return (base + timedelta(minutes=sunrise_min),
            base + timedelta(minutes=sunset_min))


def is_daytime(item: StacItem) -> bool:
    """True if the item's timestamp is between sunrise and sunset at its
    bbox centroid."""
    if item.datetime is None:
        return False
    lon = (item.bbox[0] + item.bbox[2]) / 2
    lat = (item.bbox[1] + item.bbox[3]) / 2
    ss = _sunrise_sunset_utc(lat, lon, item.datetime)
    if ss is None:
        return False
    sunrise, sunset = ss
    return sunrise <= item.datetime <= sunset


# ---------------------------------------------------------------------------
# Selection logic
# ---------------------------------------------------------------------------


def rename_stac_items(items: List[StacItem],
                      nameplate: Dict[str, Dict[str, str]]) -> List[StacItem]:
    """Normalize asset names per collection."""
    for item in items:
        mapping = nameplate.get(item.collection)
        if mapping:
            for orig, new in mapping.items():
                if orig in item.assets:
                    item.assets[new] = item.assets.pop(orig)
    return items


def is_valid_dataset_entry(granules: Sequence[Optional[str]]) -> bool:
    """All timesteps found and unique."""
    if any(g is None for g in granules):
        return False
    return len(granules) == len(set(granules))


def dispatch_candidate_items(
    tile_observations: Sequence[Record],
    tile_candidate_items: List[StacItem],
    candidate_items_field: str,
) -> Optional[List[Record]]:
    """Copies of the observations, each with the items whose footprint
    contains it (x/y in EPSG:4326); None when no observation has one."""
    cand = [[it for it in tile_candidate_items if point_within(it.bbox, row["x"], row["y"])]
            for row in tile_observations]
    if not any(cand):
        return None
    return [{**row, candidate_items_field: c} for row, c in zip(tile_observations, cand)]


def find_closest_items(
    obsv: Record,
    candidate_items_field: str,
    temporal_tolerance: int = 3,
    temporal_tolerance_minutes: int = 0,
) -> List[Optional[StacItem]]:
    """Per timestep, the least cloudy candidate within ±tolerance."""
    dates = obsv["tile_queries"][1]
    items = obsv.get(candidate_items_field, [])
    if not items:
        return [None] * len(dates)
    out: List[Optional[StacItem]] = []
    tol_minutes = temporal_tolerance * 24 * 60 + temporal_tolerance_minutes
    for date in dates:
        query_date = parse_datetime(date)
        cands = [
            it for it in items
            if abs((it.datetime - query_date).total_seconds() / 60) <= tol_minutes
        ]
        if not cands:
            out.append(None)
        else:
            out.append(min(cands,
                           key=lambda it: it.properties.get("eo:cloud_cover", 100)))
    return out


# Decorated at whole-function granularity (one call per pipeline run), as
# the JAX package does: the limiter then never throttles and a retry
# re-issues every earlier tile's search; the pacing is the per-tile
# sleep(1) below.
@rate_limited(DATA_PIPELINE_SETTINGS.METADATA_SEARCH_RATELIMIT, 60)
@retry_backoff((StacAPIError, RuntimeError) + NETWORK_ERRORS,
               max_tries=5, max_time=300)
def retrieve_stac_metadata(
    client: StacClient,
    tile_info: Sequence[Record],
    collections: List[str],
    bands_nameplate: Dict[str, Dict[str, str]],
    cloud_coverage: Optional[int] = 10,
    daytime_only: bool = False,
) -> Dict[str, List[StacItem]]:
    """Per-tile windowed search: ``{tile_id: items}``."""
    items_dict: Dict[str, List[StacItem]] = {}
    for row in tile_info:
        try:
            candidates = client.search(
                collections=collections,
                datetime=f"{row['min_date']}/{row['max_date']}",
                bbox=make_valid_bbox(row["lon_min"], row["lat_min"],
                                     row["lon_max"], row["lat_max"]),
                sortby=[{"field": "datetime", "direction": "asc"}],
                query=None if cloud_coverage is None
                else {"eo:cloud_cover": {"lte": cloud_coverage}},
            )
        except StacAPIError as e:
            log.warning("API error for tile %s: %s", row["tile_id"], e)
            time.sleep(60)
            continue
        if daytime_only:
            candidates = [it for it in candidates if is_daytime(it)]
        if not candidates:
            log.warning("No items found for %s", row["tile_id"])
            continue
        items_dict[row["tile_id"]] = rename_stac_items(candidates, bands_nameplate)
        time.sleep(1)
    return items_dict


def find_best_items(
    data: Sequence[Record],
    tiles_database: Dict[str, List[StacItem]],
    item_id_field: str,
    candidate_items_field: str,
    items_field: str,
    temporal_tolerance: int = 12,
    temporal_tolerance_minutes: int = 0,
) -> Dict[str, List[Record]]:
    """Dispatch + closest-item selection per tile: ``{tile_id: records}``,
    each record with its items per timestep under ``items_field``."""
    best: Dict[str, List[Record]] = {}
    for tile_id, items in tiles_database.items():
        tile_obsvs = [r for r in data if r["mgrs_tile_id"] == tile_id]
        if not tile_obsvs:
            continue
        with_cands = dispatch_candidate_items(tile_obsvs, items,
                                              candidate_items_field)
        if with_cands is None:
            continue
        for o in with_cands:
            o[items_field] = find_closest_items(
                o, candidate_items_field,
                temporal_tolerance=temporal_tolerance,
                temporal_tolerance_minutes=temporal_tolerance_minutes)
            del o[candidate_items_field]
        best[tile_id] = with_cands
    return best


def create_records_with_items(
    best_items: Dict[str, List[Record]],
    granules_field: str,
    items_field: str,
) -> Tuple[List[Record], Dict[str, Any]]:
    """The observations whose every timestep found a distinct granule, each
    keyed by its granule set (``stac_items_str``), and the dataset map
    ``{stac_items_str: {"granules": [item dicts]}}``."""
    records: List[Record] = []
    dataset: Dict[str, Any] = {}
    for tile_id, obsvs in best_items.items():
        valid = []
        for o in obsvs:
            ids = [it.id if isinstance(it, StacItem) else None for it in o[items_field]]
            if is_valid_dataset_entry(ids):
                valid.append({**o, granules_field: ids, "stac_items_str": "_".join(ids)})
        if not valid:
            continue
        for obsv in drop_duplicates(valid, "stac_items_str"):
            dataset[obsv["stac_items_str"]] = {
                "granules": [it.to_dict() for it in obsv[items_field]]
            }
        records.extend({k: v for k, v in o.items() if k not in (items_field, granules_field)}
                       for o in valid)
    return records, dataset


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
