"""Granule downloads + local multi-file granule loading.

The port's own copy of ``instageo_tpu/data/downloads.py`` over the standard
library's ``urllib`` instead of ``requests``:

* ``download_file`` / ``parallel_download``: authenticated HTTP fetches on
  a thread pool, with retries and small-file pruning (the HLS bulk path);
* ``open_mf_tiff_dataset``: local band files -> stacked (T·C, H, W) array;
* the legacy Sentinel-2 CDSE path: OAuth token management
  (``S2AuthState``), zip download + extraction, and ``open_mf_jp2_dataset``,
  which decodes JP2 band files through OpenJPEG (OpenCV, imported when it is
  called: a host-only path).
"""

from __future__ import annotations

import logging
import os
import threading
import urllib.request
import zipfile
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader
from instageo_tpu_torch.data.remote_io import NETWORK_ERRORS, UrllibSession
from instageo_tpu_torch.data.settings import GDAL_OPTIONS
from instageo_tpu_torch.utils.ratelimit import retry_backoff

log = logging.getLogger(__name__)

MIN_VALID_SIZE = 1024  # prune obviously-truncated downloads


@retry_backoff(NETWORK_ERRORS + (IOError,), max_tries=3, max_time=300)
def download_file(url: str, out_path: str,
                  headers: Optional[Dict[str, str]] = None) -> str:
    """Stream ``url`` into ``out_path`` (through a ``.part`` file); an error
    status or a file under ``MIN_VALID_SIZE`` bytes raises."""
    tmp = out_path + ".part"
    req = urllib.request.Request(url, headers=dict(headers or {}))
    with urllib.request.urlopen(req, timeout=120) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    if os.path.getsize(tmp) < MIN_VALID_SIZE:
        os.remove(tmp)
        raise IOError(f"Truncated download: {url}")
    os.replace(tmp, out_path)
    return out_path


def parallel_download(urls: Dict[str, str], outdir: str,
                      max_retries: int = 3, threads: Optional[int] = None,
                      headers: Optional[Dict[str, str]] = None) -> List[str]:
    """Download {filename: url} concurrently; existing valid files are
    skipped. Auth by the EarthData bearer token when one is configured."""
    os.makedirs(outdir, exist_ok=True)
    if headers is None:
        token = GDAL_OPTIONS.get_access_token()
        headers = {"Authorization": f"Bearer {token}"} if token else {}
    threads = threads or min(16, (os.cpu_count() or 1) * 4)
    done: List[str] = []

    def fetch(name: str, url: str) -> Optional[str]:
        out = os.path.join(outdir, name)
        if os.path.exists(out) and os.path.getsize(out) >= MIN_VALID_SIZE:
            return out
        try:
            return download_file(url, out, headers)
        except Exception as e:
            log.error("Download failed %s: %s", url, e)
            return None

    with ThreadPoolExecutor(threads) as pool:
        futs = {pool.submit(fetch, n, u): n for n, u in urls.items()}
        for fut in as_completed(futs):
            res = fut.result()
            if res:
                done.append(res)
    return done


def open_mf_tiff_dataset(
    band_files: Dict[str, Any], load_masks: bool = False
) -> Tuple[np.ndarray, Optional[np.ndarray], Affine, Optional[int]]:
    """Stack local band GeoTIFFs into (T·C, H, W) (+ masks).

    ``band_files`` = {"tiles": {name: path}, "fmasks": {name: path}}.
    """
    band_paths = list(band_files["tiles"].values())
    planes = []
    transform = crs = None
    for p in band_paths:
        with GeoTiffReader(p) as r:
            planes.append(r.read(1))
            transform = transform or r.transform
            crs = crs or r.crs
    min_h = min(b.shape[0] for b in planes)
    min_w = min(b.shape[1] for b in planes)
    bands = np.stack([b[:min_h, :min_w] for b in planes])
    masks = None
    if load_masks and band_files.get("fmasks"):
        mplanes = []
        for p in band_files["fmasks"].values():
            with GeoTiffReader(p) as r:
                mplanes.append(r.read(1)[:min_h, :min_w])
        masks = np.stack(mplanes)
    return bands, masks, transform, crs


# ---------------------------------------------------------------------------
# Sentinel-2 legacy CDSE path
# ---------------------------------------------------------------------------

CDSE_TOKEN_URL = ("https://identity.dataspace.copernicus.eu/auth/realms/CDSE/"
                  "protocol/openid-connect/token")
CDSE_DOWNLOAD_URL = ("https://catalogue.dataspace.copernicus.eu/odata/v1/"
                     "Products({pid})/$value")


class S2AuthState:
    """CDSE OAuth token management. ``session``: any object with
    ``post(url, data=, timeout=)`` (``remote_io.UrllibSession`` by default)."""

    def __init__(self, username: Optional[str] = None,
                 password: Optional[str] = None) -> None:
        self.username = username or os.environ.get("CDSE_USERNAME", "")
        self.password = password or os.environ.get("CDSE_PASSWORD", "")
        self._token: Optional[str] = None
        self._refresh: Optional[str] = None

    def get_token(self, session: Any = None) -> str:
        session = session or UrllibSession()
        data = {
            "client_id": "cdse-public",
            "grant_type": "password",
            "username": self.username,
            "password": self.password,
        }
        if self._refresh:
            data = {"client_id": "cdse-public", "grant_type": "refresh_token",
                    "refresh_token": self._refresh}
        r = session.post(CDSE_TOKEN_URL, data=data, timeout=30)
        if r.status_code != 200:
            self._refresh = None
            raise RuntimeError(f"CDSE auth failed: {r.status_code}")
        payload = r.json()
        self._token = payload["access_token"]
        self._refresh = payload.get("refresh_token")
        return self._token

    def headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self._token or self.get_token()}"}


def download_tile_data(product_id: str, outdir: str,
                       auth: Optional[S2AuthState] = None) -> str:
    """Download + extract one CDSE product zip."""
    auth = auth or S2AuthState()
    os.makedirs(outdir, exist_ok=True)
    zip_path = os.path.join(outdir, f"{product_id}.zip")
    if not os.path.exists(zip_path):
        download_file(CDSE_DOWNLOAD_URL.format(pid=product_id), zip_path,
                      headers=auth.headers())
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(outdir)
    return outdir


def parallel_downloads_s2(product_ids: Sequence[str], outdir: str,
                          workers: int = 4) -> List[str]:
    """Concurrent CDSE product downloads with one auth state per worker
    thread (its token minted once and refreshed), not one per product."""
    local = threading.local()

    def one(pid: str) -> Optional[str]:
        if not hasattr(local, "auth"):
            local.auth = S2AuthState()
        try:
            return download_tile_data(pid, outdir, local.auth)
        except Exception as e:
            log.error("S2 download failed %s: %s", pid, e)
            return None

    with ThreadPoolExecutor(workers) as pool:
        return [r for r in pool.map(one, product_ids) if r]


def open_mf_jp2_dataset(
    band_files: Dict[str, str],
    scl_file: Optional[str] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Stack JP2 band files (CDSE granules) via OpenJPEG (OpenCV).

    Georeferencing for CDSE JP2s comes from the granule metadata upstream.
    """
    import cv2

    planes = []
    for name, path in band_files.items():
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            raise IOError(f"Cannot decode JP2 {path}")
        planes.append(np.asarray(arr))
    min_h = min(p.shape[0] for p in planes)
    min_w = min(p.shape[1] for p in planes)
    bands = np.stack([p[:min_h, :min_w] for p in planes])
    scl = None
    if scl_file:
        scl_arr = cv2.imread(scl_file, cv2.IMREAD_UNCHANGED)
        if scl_arr is not None:
            scl = np.asarray(scl_arr)
    return bands, scl
