"""Golden vectors for the SPA's in-browser selftest.

The port's own copy of ``instageo_tpu/webapp/selftest_goldens.py``.
``static/selftest.html``, opened in any browser, executes the SPA's own
modules (mercator math, bounds area, colormap generation) against vectors
generated HERE by the Python tiler/CRS stack and renders an all-green/red
report. ``generate()`` is the single source of those vectors; the committed
``static/selftest_goldens.json`` must equal its output.

Regenerate with:
    python -m instageo_tpu_torch.webapp.selftest_goldens
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

from instageo_tpu_torch.data.crs import haversine_km
from instageo_tpu_torch.webapp.tiler import (
    latlon_to_mercator,
    mercator_to_latlon,
    tile_bounds_mercator,
)

TILE = 256
_WEB_MERCATOR_MAX = 20037508.342789244


def _pixel_from_latlon(lat: float, lon: float, z: int):
    """World-pixel coords through the TILER's mercator transform (the JS
    lngToX/latToY must agree with the tile server or layers misalign)."""
    mx, my = latlon_to_mercator(lat, lon)
    world = TILE * (2 ** z)
    px = (mx + _WEB_MERCATOR_MAX) / (2 * _WEB_MERCATOR_MAX) * world
    py = (_WEB_MERCATOR_MAX - my) / (2 * _WEB_MERCATOR_MAX) * world
    return px, py


def generate() -> Dict:
    out: Dict = {"tile_size": TILE}

    # lat/lng/zoom -> world pixel (JS lngToX / latToY).
    samples = [
        (0.0, 0.0, 0), (48.8566, 2.3522, 7), (-33.9249, 18.4241, 11),
        (9.0820, 8.6753, 5), (61.0, -150.0, 3), (-54.8, -68.3, 13),
    ]
    out["latlng_to_pixel"] = [
        {"lat": lat, "lng": lng, "z": z,
         "px": _pixel_from_latlon(lat, lng, z)[0],
         "py": _pixel_from_latlon(lat, lng, z)[1]}
        for lat, lng, z in samples
    ]

    # XYZ tile corners -> lat/lng (JS xToLng / yToLat at tile boundaries):
    # computed through the tiler's tile_bounds_mercator + mercator_to_latlon,
    # the exact path render_tile uses to place pixels.
    tiles = [(0, 0, 0), (3, 4, 2), (7, 63, 42), (11, 1024, 800)]
    corners = []
    for z, x, y in tiles:
        min_x, min_y, max_x, max_y = tile_bounds_mercator(z, x, y)
        lat_nw, lon_nw = mercator_to_latlon(min_x, max_y)
        lat_se, lon_se = mercator_to_latlon(max_x, min_y)
        corners.append({"z": z, "x": x, "y": y,
                        "nw": [float(lat_nw), float(lon_nw)],
                        "se": [float(lat_se), float(lon_se)]})
    out["tile_corners"] = corners

    # Haversine distances in meters (JS haversineMeters; Python uses the
    # IUGG mean radius 6371.0088 km vs the SPA's 6371 km — agreement is
    # checked to 2e-3 relative in the page).
    pairs = [
        (0.0, 0.0, 0.0, 1.0), (48.85, 2.35, 51.51, -0.13),
        (-33.9, 18.4, -26.2, 28.0), (9.05, 7.49, 6.52, 3.37),
    ]
    out["haversine_m"] = [
        {"a": [a, b], "b": [c, d],
         "meters": float(haversine_km(a, b, c, d)) * 1000.0}
        for a, b, c, d in pairs
    ]

    # Bounds area (JS boundsAreaKm2: width x height haversine product).
    boxes = [
        (6.0, 3.0, 7.0, 4.0), (48.0, 2.0, 48.5, 2.8), (-1.0, -1.0, 1.0, 1.0),
    ]
    out["bounds_area_km2"] = [
        {"sw": [s, w], "ne": [n, e],
         "km2": float(haversine_km(s, w, s, e) * haversine_km(s, w, n, w))}
        for s, w, n, e in boxes
    ]

    # Colormap vectors (JS generateTiTilerColormap): hex -> [r, g, b] for
    # the backend-accepted query shape (webapp/main.py _render_params).
    out["colormap"] = {
        "classes": [0, 1, 2, 3],
        "hex": ["#aec7e8", "#ffbb78", "#98df8a", "#ff9896"],
        "rgb": [[174, 199, 232], [255, 187, 120], [152, 223, 138],
                [255, 152, 150]],
    }
    return out


def write(path: str | None = None) -> str:
    path = path or os.path.join(os.path.dirname(__file__), "static",
                                "selftest_goldens.json")
    with open(path, "w") as fh:
        json.dump(generate(), fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


if __name__ == "__main__":
    print(write())
