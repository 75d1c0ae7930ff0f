"""Prediction-map visualization: GeoTIFF -> thresholded overlay on a map.

The port's own copy of ``instageo_tpu/apps/viz.py``, which re-implements
``instageo/apps/viz.py`` without plotly/datashader/streamlit: rasters are
warped to the WGS84 grid a Leaflet overlay spans, values thresholded to the
(0.8, 1] band and shaded with the Reds colormap (reference viz.py:46-116),
and the result is emitted as a self-contained Leaflet HTML page (base64 PNG
overlays from ``webapp/png.py``; map tiles from the standard OSM CDN in the
viewer's browser).
"""

from __future__ import annotations

import base64
import json
import logging
import os
from typing import Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.crs import Transformer
from instageo_tpu_torch.data.geotiff import GeoTiffReader
from instageo_tpu_torch.webapp.png import encode_png

log = logging.getLogger(__name__)

_REDS = [
    (255, 245, 240), (254, 224, 210), (252, 187, 161), (252, 146, 114),
    (251, 106, 74), (239, 59, 44), (203, 24, 29), (165, 15, 21), (103, 0, 13),
]


def _reds_colormap(values: np.ndarray, lo: float = 0.0, hi: float = 1.0,
                   alpha: int = 200) -> np.ndarray:
    """Map values in (lo, hi] to the full Reds ramp; NaN -> transparent.

    Normalizing over the DISPLAYED band (not a fixed [0, 1]) spans the
    whole ramp like the reference's plotly/datashader auto-ranging — a
    fixed scale would use only the 3 darkest reds for the default
    (0.8, 1] threshold and only near-white for a (0, 0.2] one.
    """
    span = max(hi - lo, 1e-9)
    norm = (values - lo) / span
    idx = np.clip(norm * (len(_REDS) - 1), 0, len(_REDS) - 1)
    idx = np.where(np.isnan(values), 0, idx).astype(int)
    ramp = np.asarray(_REDS, np.uint8)
    rgba = np.zeros(values.shape + (4,), np.uint8)
    rgba[..., :3] = ramp[idx]
    rgba[..., 3] = np.where(np.isnan(values), 0, alpha)
    return rgba


def read_geotiff_to_overlay(
    path: str,
    threshold: Tuple[float, float] = (0.8, 1.0),
    max_size: int = 1024,
) -> Tuple[np.ndarray, Tuple[float, float, float, float]]:
    """Raster -> (RGBA overlay, WGS84 bounds), thresholded like the reference.

    Values outside (threshold_lo, threshold_hi] become transparent
    (reference viz.py:46-116 maps (0.8, 1] through Reds).
    """
    with GeoTiffReader(path) as r:
        data = r.read(1).astype(np.float64)
        nodata = r.nodata
        t = r.transform
        crs = r.crs or 4326
        w, h = r.width, r.height
    if nodata is not None:
        data = np.where(data == nodata, np.nan, data)

    # WGS84 bounds from the four corners (handles rotation-free affine
    # transforms in any supported CRS, and south-up rasters).
    xs = [t.c, t.c + w * t.a]
    ys = [t.f, t.f + h * t.e]
    if crs != 4326:
        tr = Transformer.from_crs(crs, 4326, always_xy=True)
        lons, lats = [], []
        for x in xs:
            for y in ys:
                lon, lat = tr.transform(x, y)
                lons.append(float(lon))
                lats.append(float(lat))
        bounds = (min(lats), min(lons), max(lats), max(lons))
    else:
        bounds = (min(ys), min(xs), max(ys), max(xs))

    # TRUE warp to the axis-aligned WGS84 grid Leaflet stretches the
    # image over: sample the source raster at each target lat/lon via the
    # inverse transform (nearest neighbor). Merely stretching the raw
    # UTM grid into the lat/lon bbox shifts pixels by kilometers near
    # zone edges (UTM grid convergence) and flips south-up rasters.
    aspect = max((bounds[2] - bounds[0]) / max(bounds[3] - bounds[1], 1e-12),
                 1e-6)
    out_w = min(max_size, max(w, h))
    out_h = max(1, min(max_size, int(round(out_w * aspect))))
    lats_g = np.linspace(bounds[2], bounds[0], out_h)   # north -> south rows
    lons_g = np.linspace(bounds[1], bounds[3], out_w)
    lon_m, lat_m = np.meshgrid(lons_g, lats_g)
    if crs != 4326:
        inv = Transformer.from_crs(4326, crs, always_xy=True)
        x_m, y_m = inv.transform(lon_m, lat_m)
    else:
        x_m, y_m = lon_m, lat_m
    col = np.floor((np.asarray(x_m) - t.c) / t.a).astype(np.int64)
    row = np.floor((np.asarray(y_m) - t.f) / t.e).astype(np.int64)
    inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
    sampled = np.full(lon_m.shape, np.nan)
    sampled[inside] = data[row[inside], col[inside]]

    lo, hi = threshold
    vals = np.where((sampled > lo) & (sampled <= hi), sampled, np.nan)
    overlay = _reds_colormap(vals, lo, hi)
    return overlay, bounds


def _png_b64(rgba: np.ndarray) -> str:
    return base64.b64encode(encode_png(rgba)).decode()


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>InstaGeo-TPU Map</title>
<link rel="stylesheet"
 href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>html,body,#map{{height:100%;margin:0}}</style></head>
<body><div id="map"></div><script>
var map = L.map('map');
L.tileLayer('https://tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
  {{maxZoom: 18, attribution: '&copy; OpenStreetMap'}}).addTo(map);
var overlays = {overlays_json};
var group = L.featureGroup();
overlays.forEach(function(o) {{
  L.imageOverlay('data:image/png;base64,' + o.png,
    [[o.bounds[0], o.bounds[1]], [o.bounds[2], o.bounds[3]]],
    {{opacity: 0.85}}).addTo(map);
  group.addLayer(L.rectangle(
    [[o.bounds[0], o.bounds[1]], [o.bounds[2], o.bounds[3]]],
    {{weight: 0, fillOpacity: 0}}));
}});
group.addTo(map);
if (overlays.length) map.fitBounds(group.getBounds()); else map.setView([0,0],2);
</script></body></html>
"""


def create_map_with_geotiff_tiles(
    tiles_to_overlay: Sequence[str],
    out_html: str,
    threshold: Tuple[float, float] = (0.8, 1.0),
) -> str:
    """Render prediction GeoTIFFs onto a Leaflet map HTML file.

    Surface equivalent of the reference's plotly mapbox figure builder
    (viz.py:46-159).
    """
    overlays = []
    failed = []
    for path in tiles_to_overlay:
        try:
            rgba, bounds = read_geotiff_to_overlay(path, threshold)
        except Exception as e:
            # Never silent: a CRS/codec the framework doesn't support must
            # not turn into "N tiles rendered" over an empty map.
            failed.append(path)
            log.warning("Skipping tile %s: %s", path, e)
            continue
        overlays.append({
            "png": _png_b64(rgba),
            "bounds": [bounds[0], bounds[1], bounds[2], bounds[3]],
            "name": os.path.basename(path),
        })
    if failed:
        log.warning("Rendered %d/%d tiles (%d failed)", len(overlays),
                    len(tiles_to_overlay), len(failed))
    html = _HTML_TEMPLATE.format(overlays_json=json.dumps(overlays))
    with open(out_html, "w") as f:
        f.write(html)
    return out_html
