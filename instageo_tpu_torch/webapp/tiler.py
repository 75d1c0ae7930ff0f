"""Tile service: slippy-map (XYZ) PNG tiles rendered from the task COGs.

The port's own copy of ``instageo_tpu/webapp/tiler.py``, which replaces
TiTiler (``instageo/new_apps/backend/app/tiler_service.py``): web-mercator
tile math, overview selection, nearest-neighbour reprojection from the COG's
CRS (UTM or EPSG:4326), RGB stretch for chips and a categorical colormap for
predictions, encoded by ``webapp/png.py``. Tiles are addressed by task id and
layer; file paths are never exposed (reference main.py:111-193).
"""

from __future__ import annotations

from collections import OrderedDict
import math
import os
import re
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from instageo_tpu_torch.data.crs import Transformer
from instageo_tpu_torch.data.geotiff import GeoTiffReader
from instageo_tpu_torch.webapp.png import encode_png

_R = 6378137.0
_ORIGIN = math.pi * _R

# Allowed characters for URL-supplied path components (UUID task ids,
# layer names) — anything else is rejected before touching the filesystem.
_SAFE_ID = re.compile(r"(?!\.+$)[A-Za-z0-9_.-]+")

# Categorical colors for prediction classes (RGBA).
CLASS_COLORS = {
    0: (0, 0, 0, 0),          # background: transparent
    1: (214, 40, 40, 200),    # class 1: red
    2: (244, 162, 97, 200),
    3: (42, 157, 143, 200),
    4: (38, 70, 83, 200),
    5: (233, 196, 106, 200),
}


def tile_bounds_mercator(z: int, x: int, y: int) -> Tuple[float, float, float, float]:
    """(min_x, min_y, max_x, max_y) in EPSG:3857 meters for an XYZ tile."""
    size = 2 * _ORIGIN / (2 ** z)
    min_x = -_ORIGIN + x * size
    max_x = min_x + size
    max_y = _ORIGIN - y * size
    min_y = max_y - size
    return min_x, min_y, max_x, max_y


def mercator_to_latlon(mx: np.ndarray, my: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lon = np.degrees(mx / _R)
    lat = np.degrees(2 * np.arctan(np.exp(my / _R)) - np.pi / 2)
    return lat, lon


def latlon_to_mercator(lat: float, lon: float) -> Tuple[float, float]:
    mx = math.radians(lon) * _R
    my = _R * math.log(math.tan(math.pi / 4 + math.radians(lat) / 2))
    return mx, my


class COGTiler:
    """Renders XYZ tiles from one COG."""

    def __init__(self, path: str, tile_size: int = 256) -> None:
        self.path = path
        self.tile_size = tile_size
        self.reader = GeoTiffReader(path)
        self.crs = self.reader.crs or 4326
        self.nodata = self.reader.nodata
        self.mtime = os.path.getmtime(path)
        # cache decoded levels lazily
        self._levels: Dict[int, np.ndarray] = {}
        # Tile renders run on the server's request threads and the
        # reader's shared fp seek/read is NOT thread-safe — concurrent
        # cache-miss decodes corrupt each other without this lock.
        self._decode_lock = threading.Lock()

    def _level(self, idx: int) -> np.ndarray:
        cached = self._levels.get(idx)
        if cached is None:
            with self._decode_lock:
                cached = self._levels.get(idx)
                if cached is None:
                    cached = self.reader.read(ifd_index=idx)
                    self._levels[idx] = cached
        return cached

    def bounds_4326(self) -> Tuple[float, float, float, float]:
        t = self.reader.transform
        w, h = self.reader.width, self.reader.height
        xs = [t.c, t.c + w * t.a]
        ys = [t.f, t.f + h * t.e]
        if self.crs == 4326:
            return min(xs), min(ys), max(xs), max(ys)
        tr = Transformer.from_crs(self.crs, 4326, always_xy=True)
        corners = [(x, y) for x in xs for y in ys]
        lons, lats = [], []
        for x, y in corners:
            lon, lat = tr.transform(x, y)
            lons.append(float(lon))
            lats.append(float(lat))
        return min(lons), min(lats), max(lons), max(lats)

    def _select_level(self, z: int) -> Tuple[int, float]:
        """Pick the overview whose resolution best matches the tile zoom."""
        merc_res = 2 * _ORIGIN / (2 ** z) / self.tile_size  # m/px at equator
        # Approximate source resolution in meters.
        src_res = abs(self.reader.transform.a)
        if self.crs == 4326:
            src_res *= 111320.0
        level = 0
        n_levels = len(self.reader.ifds)
        while level + 1 < n_levels and src_res * (2 ** (level + 1)) <= merc_res:
            level += 1
        return level, src_res

    def sample_tile(self, z: int, x: int, y: int) -> Tuple[np.ndarray, np.ndarray]:
        """(bands, ts, ts) sampled data + validity mask for one XYZ tile."""
        ts = self.tile_size
        min_x, min_y, max_x, max_y = tile_bounds_mercator(z, x, y)
        px = (np.arange(ts) + 0.5) / ts
        mx = min_x + px * (max_x - min_x)
        my = max_y - px * (max_y - min_y)
        mxg, myg = np.meshgrid(mx, my)
        lat, lon = mercator_to_latlon(mxg.ravel(), myg.ravel())
        if self.crs == 4326:
            sx, sy = lon, lat
        else:
            tr = Transformer.from_crs(4326, self.crs, always_xy=True)
            sx, sy = tr.transform(lon, lat)
        level, _ = self._select_level(z)
        data = self._level(level)
        t = self.reader.transform
        scale = 2 ** level
        inv = t.invert()
        cols = np.floor((inv.a * sx + inv.b * sy + inv.c) / scale).astype(int)
        rows = np.floor((inv.d * sx + inv.e * sy + inv.f) / scale).astype(int)
        h, w = data.shape[-2:]
        valid = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        rows_c = np.clip(rows, 0, h - 1)
        cols_c = np.clip(cols, 0, w - 1)
        out = data[:, rows_c, cols_c].reshape(data.shape[0], ts, ts)
        return out, valid.reshape(ts, ts)

    def render_tile(self, z: int, x: int, y: int, mode: str = "rgb",
                    value_range: Tuple[float, float] = (0, 3000),
                    colormap: Optional[Dict[int, Tuple]] = None) -> bytes:
        """Render a PNG tile: 'rgb' stretch or 'classes' colormap.

        ``colormap`` overrides CLASS_COLORS (the frontend passes its class
        palette exactly like the reference passes TiTiler ?colormap=...).
        """
        data, valid = self.sample_tile(z, x, y)
        ts = self.tile_size
        if self.nodata is not None:
            valid = valid & ~np.all(data == self.nodata, axis=0)
        rgba = np.zeros((ts, ts, 4), np.uint8)
        if mode == "classes":
            cmap = colormap if colormap else CLASS_COLORS
            classes = data[0].astype(int)
            for cls, color in cmap.items():
                m = valid & (classes == cls)
                rgba[m] = tuple(color) if len(color) == 4 else (*color, 200)
            other = valid & ~np.isin(classes, list(cmap))
            rgba[other] = (128, 0, 128, 200)
        else:
            lo, hi = value_range
            # 'gray': single-band grayscale stretch (the OpenAPI-documented
            # third mode); anything else: 3-band rgb stretch.
            bands = (data[:1] if mode == "gray" else data[:3]).astype(
                np.float32)
            scaled = np.clip((bands - lo) / max(hi - lo, 1e-6), 0, 1) * 255
            if scaled.shape[0] < 3:
                scaled = np.repeat(scaled[:1], 3, axis=0)
            rgba[..., :3] = scaled.transpose(1, 2, 0).astype(np.uint8)
            rgba[..., 3] = np.where(valid, 255, 0)
        return encode_png(rgba)

    def preview(self, max_size: int = 512, mode: str = "rgb",
                value_range: Tuple[float, float] = (0, 3000),
                colormap: Optional[Dict[int, Tuple]] = None) -> bytes:
        """Whole-image PNG preview from the smallest adequate overview."""
        level = len(self.reader.ifds) - 1
        while level > 0:
            ifd = self.reader.ifds[level]
            if max(ifd.width, ifd.height) >= max_size:
                break
            level -= 1
        data = self._level(level)
        # Decimate the WHOLE level to <= max_size (cropping first would
        # return a corner of any level much larger than max_size, e.g. a
        # COG without overviews).
        step = max(1, -(-max(data.shape[-2:]) // max_size))  # ceil div
        data = data[:, ::step, ::step][:, :max_size, :max_size]
        h, w = data.shape[-2:]
        rgba = np.zeros((h, w, 4), np.uint8)
        if mode == "classes":
            cmap = colormap if colormap else CLASS_COLORS
            classes = data[0].astype(int)
            for cls, color in cmap.items():
                rgba[classes == cls] = (
                    tuple(color) if len(color) == 4 else (*color, 200))
        else:
            lo, hi = value_range
            bands = (data[:1] if mode == "gray" else data[:3]).astype(
                np.float32)
            scaled = np.clip((bands - lo) / max(hi - lo, 1e-6), 0, 1) * 255
            if scaled.shape[0] < 3:
                scaled = np.repeat(scaled[:1], 3, axis=0)
            rgba[..., :3] = scaled.transpose(1, 2, 0).astype(np.uint8)
            rgba[..., 3] = 255
            if self.nodata is not None:
                rgba[..., 3] = np.where(
                    np.all(data == self.nodata, axis=0), 0, 255)
        return encode_png(rgba)

    def statistics(self) -> Dict[str, Any]:
        data = self._level(len(self.reader.ifds) - 1).astype(np.float64)
        mask = np.ones(data.shape[-2:], bool)
        if self.nodata is not None:
            mask = ~np.all(data == self.nodata, axis=0)
        out = {}
        for i in range(data.shape[0]):
            band = data[i][mask]
            if band.size == 0:
                out[f"b{i + 1}"] = {}
                continue
            out[f"b{i + 1}"] = {
                "min": float(band.min()), "max": float(band.max()),
                "mean": float(band.mean()), "std": float(band.std()),
            }
        return out

    def tilejson(self, tiles_url: str) -> Dict[str, Any]:
        b = self.bounds_4326()
        return {
            "tilejson": "2.2.0",
            "tiles": [tiles_url],
            "bounds": list(b),
            "center": [(b[0] + b[2]) / 2, (b[1] + b[3]) / 2, 10],
            "minzoom": 4,
            "maxzoom": 18,
        }

    def close(self) -> None:
        self.reader.close()


class TilerService:
    """Task-id keyed tiler registry (reference tiler_service.py:20-127)."""

    # Each cached tiler holds its decoded overview levels (up to the
    # full-res mosaic) — bound the cache or a long-running server leaks
    # one mosaic per viewed task until OOM.
    MAX_CACHED = 8

    def __init__(self, data_dir: str) -> None:
        self.data_dir = data_dir
        self._tilers: "OrderedDict[str, COGTiler]" = OrderedDict()
        self._lock = threading.Lock()

    def _cog_path(self, task_id: str, layer: str) -> str:
        # task_id arrives from the URL; it must never traverse out of the
        # tasks data dir ("../../etc" etc.). Server-created ids are UUIDs.
        if not _SAFE_ID.fullmatch(task_id) or not _SAFE_ID.fullmatch(layer):
            raise FileNotFoundError(f"No {layer} COG for task {task_id}")
        name = f"{task_id}_{layer}.tif"
        return os.path.join(self.data_dir, task_id, name)

    def get_tiler(self, task_id: str, layer: str) -> COGTiler:
        # Called from request threads concurrently; the lock covers only
        # the cache dict — a COLD construction (file open + IFD parse of a
        # large mosaic) happens OUTSIDE it, so tile traffic for cached
        # tasks never serializes behind one slow open. Evicted/invalidated
        # tilers are NOT closed eagerly — a request thread may still be
        # rendering from one; dropping the reference lets in-flight
        # renders finish and GC reclaim the file handle.
        key = f"{task_id}/{layer}"
        with self._lock:
            cached = self._tilers.get(key)
            if cached is not None:
                # A re-run task rewrites its COG; a cached tiler would
                # keep serving the OLD arrays — invalidate on mtime
                # change.
                try:
                    fresh = os.path.getmtime(cached.path) == cached.mtime
                except OSError:
                    fresh = False
                if fresh:
                    self._tilers.move_to_end(key)
                    return cached
                del self._tilers[key]
        path = self._cog_path(task_id, layer)
        if not os.path.exists(path):
            raise FileNotFoundError(f"No {layer} COG for task {task_id}")
        tiler = COGTiler(path)
        with self._lock:
            # Another thread may have built one meanwhile — keep the
            # first so its level cache is shared.
            existing = self._tilers.get(key)
            if existing is not None and existing.mtime >= tiler.mtime:
                # Keep the newest (a concurrent thread may have cached a
                # tiler for a REWRITTEN file); equal mtimes share the
                # first tiler's level cache.
                return existing
            self._tilers[key] = tiler
            while len(self._tilers) > self.MAX_CACHED:
                self._tilers.popitem(last=False)
            return tiler

    def visualize_urls(self, task_id: str, base: str = "/api/titiler") -> Dict:
        """Task-keyed tile/tilejson/preview/statistics URLs (reference
        tiler_service.py:45-92) — no filesystem paths exposed."""
        out = {}
        if not _SAFE_ID.fullmatch(task_id):
            return out
        for layer in ("chips", "predictions"):
            if os.path.exists(self._cog_path(task_id, layer)):
                out[layer] = {
                    "tiles": f"{base}/{task_id}/{layer}/tiles/{{z}}/{{x}}/{{y}}.png",
                    "tilejson": f"{base}/{task_id}/{layer}/tilejson.json",
                    "preview": f"{base}/{task_id}/{layer}/preview.png",
                    "statistics": f"{base}/{task_id}/{layer}/statistics",
                }
        return out
