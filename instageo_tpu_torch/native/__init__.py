"""ctypes bindings for the native GeoTIFF decoder (``geotiff_native.cc``).

The port's counterpart of ``instageo_tpu/native``, with the same API:
``available``, ``read_info``, ``read_geotiff_native`` and
``read_batch_native``. The library is built at first use with ``g++``
(no ``make``) into ``build/instageo_tpu_torch/native/<hash of the source
and flags>/libinstageo_native.so`` beside the package, under a temporary
name that is renamed into place, so that concurrent builds (test workers,
loader threads) never load a half-written library. When it cannot be built
or loaded, ``available()`` is False, the reason is logged once
(``unavailable_reason``), and callers decode with the Python codec.

``decodes`` counts the files the native decoder decoded, ``fallback_decodes``
the files a caller decoded with the Python codec in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from instageo_tpu_torch.ops._build import BUILD_ROOT, HostCounter

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "geotiff_native.cc"
# No -march=native: a library found by the hash of its source must not
# depend on the machine that built it first. zlib is linked by its runtime
# name, which needs no development files.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-l:libz.so.1", "-lpthread")

decodes = HostCounter()           # files decoded by the native library
fallback_decodes = HostCounter()  # files decoded by the Python codec instead

_DTYPES = {1: np.uint8, 2: np.uint16, 3: np.int16, 4: np.int32,
           5: np.float32, 6: np.float64, 7: np.int8, 8: np.uint32}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
unavailable_reason: Optional[str] = None


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / "native" / h.hexdigest()[:16] / "libinstageo_native.so"


def build() -> Path:
    """Compile the library unless it exists; raises with the compiler's
    output on failure."""
    path = lib_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, unavailable_reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            unavailable_reason = str(e).strip()
            log.warning("native GeoTIFF decoder unavailable, decoding with the Python "
                        "codec: %s", unavailable_reason)
            return None
        lib.igt_open_info.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32)]
        lib.igt_open_info.restype = ctypes.c_int
        lib.igt_read_full.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.igt_read_full.restype = ctypes.c_int
        lib.igt_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int]
        lib.igt_read_batch.restype = ctypes.c_int
        lib.igt_last_error.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder is built and loaded (building it if needed)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {unavailable_reason}")
    return lib


def read_info(path: str) -> Tuple[int, int, int, np.dtype]:
    """(width, height, bands, dtype) of a raster."""
    lib = _require()
    w, h, b = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    dt = ctypes.c_int32()
    rc = lib.igt_open_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(b), ctypes.byref(dt))
    if rc != 0:
        raise IOError(f"{path}: {lib.igt_last_error().decode()}")
    return w.value, h.value, b.value, np.dtype(_DTYPES[dt.value])


def read_geotiff_native(path: str) -> np.ndarray:
    """Decode one raster to (bands, h, w)."""
    lib = _require()
    w, h, b, dtype = read_info(path)
    out = np.empty((b, h, w), dtype)
    rc = lib.igt_read_full(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes)
    if rc != 0:
        raise IOError(f"{path}: {lib.igt_last_error().decode()}")
    decodes.add()
    return out


def read_batch_native(paths: List[str], shape: Tuple[int, int, int],
                      dtype: np.dtype, n_threads: int = 0) -> np.ndarray:
    """Decode many same-shape rasters concurrently on the library's thread
    pool (``n_threads`` 0: one per core) -> (N, bands, h, w). A file that
    fails to decode is zero-filled and logged."""
    lib = _require()
    n = len(paths)
    out = np.empty((n,) + tuple(shape), np.dtype(dtype))
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.igt_read_batch(arr, n, out.ctypes.data_as(ctypes.c_void_p),
                                  out.nbytes // max(n, 1), n_threads)
    if failures:
        log.warning("native batch decode: %d/%d items failed", failures, n)
    decodes.add(n - failures)
    return out
