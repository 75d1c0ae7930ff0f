"""Where the port's compiled libraries are kept between processes.

Counterpart of ``instageo_tpu/utils/compile_cache.py``, whose persistent XLA
cache makes re-runs, serving restarts and queue workers start hot. The port
compiles only its CUDA kernels (``ops/_build.py``, ``nvcc``) and its native
GeoTIFF decoder (``native/``, ``g++``), each into ``<root>/<hash of the
sources and flags>/``, and a later process finds the library there. The
root is read when a library is built or looked up, from the JAX package's
environment names:

* ``INSTAGEO_COMPILE_CACHE_DIR``: the root (default: ``build/instageo_tpu_torch``
  beside the package);
* ``INSTAGEO_COMPILE_CACHE=0``: no shared cache; each process builds into a
  directory of its own, removed when it exits.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / "instageo_tpu_torch"

_lock = threading.Lock()
_private: Dict[int, Path] = {}  # pid -> this process's own root


def _private_root() -> Path:
    with _lock:
        root = _private.get(os.getpid())
        if root is None:
            root = Path(tempfile.mkdtemp(prefix="instageo_tpu_torch_build_"))
            _private[os.getpid()] = root
            atexit.register(shutil.rmtree, root, ignore_errors=True)
        return root


def enable_compilation_cache(cache_dir: Optional[str] = None) -> bool:
    """Keep this process's builds in ``cache_dir`` (else the root
    ``build_root`` names) for later processes; False, and nothing changed,
    under ``INSTAGEO_COMPILE_CACHE=0``."""
    if os.environ.get("INSTAGEO_COMPILE_CACHE", "1") == "0":
        return False
    if cache_dir:
        os.environ["INSTAGEO_COMPILE_CACHE_DIR"] = str(cache_dir)
    build_root().mkdir(parents=True, exist_ok=True)
    return True


def build_root() -> Path:
    """The directory under which compiled libraries are built and found."""
    if os.environ.get("INSTAGEO_COMPILE_CACHE", "1") == "0":
        return _private_root()
    path = os.environ.get("INSTAGEO_COMPILE_CACHE_DIR")
    return Path(path) if path else DEFAULT_ROOT
