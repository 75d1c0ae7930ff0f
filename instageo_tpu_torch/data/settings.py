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
    """COG access settings (the reference passes them to GDAL; the port's
    readers use its own HTTP range reads)."""

    GDAL_HTTP_MULTIRANGE: str = "YES"
    GDAL_HTTP_MERGE_CONSECUTIVE_RANGES: str = "YES"
    GDAL_HTTP_MAX_RETRY: int = 5
    GDAL_HTTP_RETRY_DELAY: int = 2
    CPL_VSIL_CURL_CACHE_SIZE: int = 32 * 1024 * 1024

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
class BlockSizes:
    HLS: int = 256
    S2: int = 1024
    S1: int = 1024


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
class HLSAPISettings(APISettings):
    URL: str = "https://cmr.earthdata.nasa.gov/stac/LPCLOUD"
    COLLECTIONS: List[str] = field(default_factory=lambda: ["HLSL30_2.0", "HLSS30_2.0"])


@dataclass
class S2APISettings(APISettings):
    URL: str = "https://planetarycomputer.microsoft.com/api/stac/v1"
    COLLECTIONS: List[str] = field(default_factory=lambda: ["sentinel-2-l2a"])


@dataclass
class S1APISettings(APISettings):
    URL: str = "https://planetarycomputer.microsoft.com/api/stac/v1"
    COLLECTIONS: List[str] = field(default_factory=lambda: ["sentinel-1-rtc"])


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
BLOCK_SIZES = BlockSizes()
BANDS_SETTINGS = BandsSettings()
HLS_API = HLSAPISettings()
S2_API = S2APISettings()
S1_API = S1APISettings()
DATA_PIPELINE_SETTINGS = DataPipelineSettings()

# Microsoft Planetary Computer's STAC API
MPC_STAC_API_URL = S2_API.URL
