"""Data-layer settings, read from the environment once at import.

The port's own copy of the part of ``instageo_tpu/data/settings.py`` that
the STAC search, the granule openers and the chip pipelines read: the same
values and environment variable names, in plain dataclasses (no pydantic).
``INSTAGEO_COG_RATELIMIT`` (or ``DATAPIPELINESETTINGS_COG_DOWNLOAD_RATELIMIT``)
caps asset loads per minute and process, local files included;
``INSTAGEO_SEARCH_RATELIMIT`` caps STAC searches likewise;
``INSTAGEO_BATCH_SIZE`` is the raster pipeline's rows per batch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def _env(name: str, default, cast=None):
    v = os.environ.get(name)
    if v is None:
        return default
    return cast(v) if cast else v


class GDALOptions:
    """COG access settings."""

    @staticmethod
    def get_access_token() -> Optional[str]:
        """NASA EarthData bearer token (``EARTHDATA_TOKEN``); None when
        ``TESTING=true``."""
        if os.environ.get("TESTING", "").lower() == "true":
            return None
        return os.environ.get("EARTHDATA_TOKEN")


@dataclass
class NoDataValues:
    HLS: int = 0
    S2: int = 0
    S1: float = -1.0
    SEG_MAP: int = -1


@dataclass
class BandsSettings:
    """Asset names per source."""

    HLS_ASSETS: List[str] = field(
        default_factory=lambda: ["B02", "B03", "B04", "B8A", "B11", "B12"])
    HLS_L30_ASSETS: List[str] = field(
        default_factory=lambda: ["B02", "B03", "B04", "B05", "B06", "B07"])
    HLS_MASK_ASSET: str = "Fmask"
    S2_ASSETS: List[str] = field(
        default_factory=lambda: ["B02", "B03", "B04", "B8A", "B11", "B12"])
    S2_MASK_ASSET: str = "SCL"
    S1_ASSETS: List[str] = field(default_factory=lambda: ["vv", "vh"])
    # Asset names normalised per collection by the STAC search.
    NAMEPLATES: Dict[str, Dict[str, str]] = field(default_factory=lambda: {
        "sentinel-2-l2a": {
            "blue": "B02", "green": "B03", "red": "B04",
            "nir08": "B8A", "swir16": "B11", "swir22": "B12", "scl": "SCL",
        },
    })


@dataclass
class APISettings:
    URL: str
    COLLECTIONS: List[str]


@dataclass
class DataPipelineSettings:
    # The class-prefixed spelling first (the reference's experiment
    # scripts export it), then the INSTAGEO_* one.
    BATCH_SIZE: int = int(_env("DATAPIPELINESETTINGS_BATCH_SIZE",
                               _env("INSTAGEO_BATCH_SIZE", 16, int), int))
    METADATA_SEARCH_RATELIMIT: int = int(
        _env("DATAPIPELINESETTINGS_METADATA_SEARCH_RATELIMIT",
             _env("INSTAGEO_SEARCH_RATELIMIT", 10, int), int))
    COG_DOWNLOAD_RATELIMIT: int = int(
        _env("DATAPIPELINESETTINGS_COG_DOWNLOAD_RATELIMIT",
             _env("INSTAGEO_COG_RATELIMIT", 30, int), int))


GDAL_OPTIONS = GDALOptions()
NO_DATA_VALUES = NoDataValues()
BANDS_SETTINGS = BandsSettings()
HLS_API = APISettings("https://cmr.earthdata.nasa.gov/stac/LPCLOUD",
                      ["HLSL30_2.0", "HLSS30_2.0"])
S2_API = APISettings("https://planetarycomputer.microsoft.com/api/stac/v1",
                     ["sentinel-2-l2a"])
S1_API = APISettings("https://planetarycomputer.microsoft.com/api/stac/v1",
                     ["sentinel-1-rtc"])
DATA_PIPELINE_SETTINGS = DataPipelineSettings()
