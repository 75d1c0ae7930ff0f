"""HTTP range-read file objects for remote COGs.

The port's own copy of ``instageo_tpu/data/remote_io.py`` over the standard
library's ``urllib.request`` instead of ``requests``: a seekable file over
HTTP Range requests with a 1 MiB block cache, retries with backoff, and the
file size from ``Content-Range`` (else a HEAD request). The ``session`` is
injectable: any object with ``get(url, headers=, timeout=)`` and
``head(url, headers=, timeout=)`` returning responses with ``status_code``,
``headers``, ``content`` and ``raise_for_status()``. ``UrllibSession.post``
serves the STAC search and the CDSE token requests.
"""

from __future__ import annotations

import http.client
import io
import json as _json
import logging
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from instageo_tpu_torch.utils.ratelimit import retry_backoff

log = logging.getLogger(__name__)

_BLOCK = 1 << 20  # 1 MiB cache blocks


class HTTPStatusError(urllib.error.URLError):
    """A response with a 4xx or 5xx status."""

    def __init__(self, url: str, status: int) -> None:
        super().__init__(f"HTTP {status} for {url}")
        self.status = status


# What a network read retries on (a missing local file is not one of them).
NETWORK_ERRORS = (urllib.error.URLError, http.client.HTTPException, ConnectionError,
                  TimeoutError)


class Response:
    """The part of a ``requests.Response`` the readers use."""

    def __init__(self, url: str, status_code: int, headers: Dict[str, str],
                 content: bytes) -> None:
        self.url, self.status_code = url, status_code
        self.headers, self.content = headers, content

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPStatusError(self.url, self.status_code)

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self) -> Any:
        return _json.loads(self.content)


class UrllibSession:
    """``get`` and ``head`` over ``urllib.request``; an error status comes
    back as a response, as with ``requests``."""

    def _open(self, method: str, url: str, headers: Optional[Dict[str, str]],
              timeout: Optional[float], data: Optional[bytes] = None) -> Response:
        req = urllib.request.Request(url, data=data, headers=dict(headers or {}),
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                body = r.read() if method != "HEAD" else b""
                return Response(url, r.status, dict(r.headers.items()), body)
        except urllib.error.HTTPError as e:
            return Response(url, e.code, dict(e.headers.items()) if e.headers else {},
                            e.read() if method != "HEAD" else b"")

    def get(self, url: str, headers: Optional[Dict[str, str]] = None,
            timeout: Optional[float] = None) -> Response:
        return self._open("GET", url, headers, timeout)

    def head(self, url: str, headers: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> Response:
        return self._open("HEAD", url, headers, timeout)

    def post(self, url: str, json: Any = None, data: Optional[Dict[str, str]] = None,
             headers: Optional[Dict[str, str]] = None,
             timeout: Optional[float] = None) -> Response:
        """A JSON body (``json``) or a form (``data``), as ``requests.post``."""
        headers = dict(headers or {})
        if json is not None:
            body = _json.dumps(json).encode()
            headers.setdefault("Content-Type", "application/json")
        else:
            body = urllib.parse.urlencode(data or {}).encode()
            headers.setdefault("Content-Type", "application/x-www-form-urlencoded")
        return self._open("POST", url, headers, timeout, body)


class HttpFile(io.RawIOBase):
    """Seekable read-only file over HTTP Range requests with block caching."""

    def __init__(self, url: str, session: Any = None,
                 headers: Optional[Dict[str, str]] = None,
                 block_size: int = _BLOCK) -> None:
        super().__init__()
        self.url = url
        self.session = session or UrllibSession()
        self.headers = dict(headers or {})
        self.block_size = block_size
        self._pos = 0
        self._size: Optional[int] = None
        self._cache: Dict[int, bytes] = {}

    @retry_backoff(NETWORK_ERRORS, max_tries=5, max_time=300)
    def _fetch(self, start: int, end: int) -> bytes:
        headers = {**self.headers, "Range": f"bytes={start}-{end - 1}"}
        r = self.session.get(self.url, headers=headers, timeout=60)
        r.raise_for_status()
        if self._size is None:
            cr = r.headers.get("Content-Range", "")
            if "/" in cr:
                try:
                    self._size = int(cr.rsplit("/", 1)[1])
                except ValueError:
                    pass
        return r.content

    def _block(self, idx: int) -> bytes:
        if idx not in self._cache:
            start = idx * self.block_size
            self._cache[idx] = self._fetch(start, start + self.block_size)
        return self._cache[idx]

    @property
    def size(self) -> int:
        if self._size is None:
            r = self.session.head(self.url, headers=self.headers, timeout=60)
            self._size = int(r.headers.get("Content-Length", 0)) or None
            if self._size is None:
                self._block(0)
        return self._size or 0

    # io protocol ----------------------------------------------------------
    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            self._pos = pos
        elif whence == os.SEEK_CUR:
            self._pos += pos
        elif whence == os.SEEK_END:
            self._pos = self.size + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self.size - self._pos
        out = bytearray()
        pos = self._pos
        end = pos + n
        while pos < end:
            bi = pos // self.block_size
            block = self._block(bi)
            off = pos - bi * self.block_size
            take = min(end - pos, len(block) - off)
            if take <= 0:
                break
            out += block[off : off + take]
            pos += take
        self._pos = pos
        return bytes(out)


def open_remote_geotiff(url: str, headers: Optional[Dict[str, str]] = None):
    """Open a remote COG with the port's GeoTIFF reader."""
    from instageo_tpu_torch.data.geotiff import GeoTiffReader

    return GeoTiffReader(url, fp=HttpFile(url, headers=headers))
