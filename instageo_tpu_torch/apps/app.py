"""Prediction map viewer CLI (legacy Streamlit app replacement).

The port's own copy of ``instageo_tpu/apps/app.py`` (reference
``instageo/apps/app.py``): browse prediction GeoTIFFs by country / year /
month and render them into a self-contained HTML map:

    python -m instageo_tpu_torch.apps.app --directory=preds --country_code=KE \
        --year=2023 --month=6 --output=map.html

Predictions are matched by the reference's naming convention
(``{directory}/{year}/{month}/*{tile}*.tif``) against the country→MGRS
lookup in ``utils/country_code_to_mgrs_tiles.json``. The flags are the JAX
CLI's, parsed by ``argparse`` with absl's spellings (``data/flags.py``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import sys
from typing import List, Optional, Sequence

from instageo_tpu_torch.apps.viz import create_map_with_geotiff_tiles
from instageo_tpu_torch.data.flags import Flag, parse_flags

APP_FLAGS = (
    Flag("directory", "string", None, "Directory containing predictions."),
    Flag("country_code", "string", None, "ISO country code to filter tiles (optional)."),
    Flag("year", "integer", None, "Prediction year."),
    Flag("month", "integer", None, "Prediction month (1-12)."),
    Flag("output", "string", "map.html", "Output HTML file."),
    Flag("threshold_low", "float", 0.8, "Lower display threshold."),
    Flag("threshold_high", "float", 1.0, "Upper display threshold."),
)

_COUNTRY_MAP_PATH = os.path.join(os.path.dirname(__file__), "utils",
                                 "country_code_to_mgrs_tiles.json")


def load_country_tiles(country_code: str) -> List[str]:
    """Country -> MGRS tile list (reference apps/utils data file)."""
    if not os.path.exists(_COUNTRY_MAP_PATH):
        return []
    with open(_COUNTRY_MAP_PATH) as f:
        mapping = json.load(f)
    return mapping.get(country_code.upper(), [])


def find_prediction_tiles(directory: str, year: int = None, month: int = None,
                          country_code: str = None) -> List[str]:
    """Locate prediction GeoTIFFs (reference app.py:71-106 browse logic)."""
    patterns = []
    if year and month:
        patterns.append(os.path.join(directory, str(year), f"{month:02d}",
                                     "*.tif"))
        patterns.append(os.path.join(directory, str(year), str(month), "*.tif"))
    elif year:
        patterns.append(os.path.join(directory, str(year), "*", "*.tif"))
    if not patterns:
        # Only undated browsing falls back to the flat layout: silently
        # returning every date's predictions for a dated query would show
        # the wrong data labeled as the requested month.
        patterns.append(os.path.join(directory, "*.tif"))
    paths: List[str] = []
    for pat in patterns:
        paths.extend(glob.glob(pat))
        if paths:
            break
    if not paths and (year or month):
        logging.warning(
            "No tiles under the dated layout %s for year=%s month=%s "
            "(flat *.tif files are only browsed without a date filter).",
            directory, year, month)
    if country_code:
        tiles = load_country_tiles(country_code)
        if tiles:
            paths = [p for p in paths
                     if any(t in os.path.basename(p) for t in tiles)]
    return sorted(set(paths))


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Entry point; ``argv`` without the program name (``sys.argv[1:]`` by
    default)."""
    flags = parse_flags(sys.argv[1:] if argv is None else argv, APP_FLAGS,
                        prog="instageo_tpu_torch.apps.app")
    if not flags.directory:
        raise ValueError("--directory is required")
    paths = find_prediction_tiles(flags.directory, flags.year, flags.month,
                                  flags.country_code)
    if not paths:
        logging.warning("No prediction tiles found.")
    out = create_map_with_geotiff_tiles(
        paths, flags.output,
        threshold=(flags.threshold_low, flags.threshold_high))
    print(f"Map written to {out} ({len(paths)} tiles found; "
          "skipped tiles are logged as warnings)")


if __name__ == "__main__":
    main()
