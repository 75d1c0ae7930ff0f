"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/instageo_tpu_torch/<hash of the sources and flags>/lib<name>.so``
beside the package, then loaded with ``ctypes``. A changed source gets a new
directory; an unchanged one is loaded from the existing build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "instageo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCounter:
    """Kernel launches since the last reset (thread-safe). Each wrapper adds
    one where it launches its kernel, and nowhere else."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def call_on_device(device, fn, *args) -> int:
    """``fn(*args, stream)``: a C entry's launch on ``device``'s current
    stream (the raw ``cudaStream_t`` as an int), entering the device's
    context only when it is not the current one. torch's C-level queries
    skip the ``torch.cuda.Stream`` object that ``torch.cuda.current_stream``
    builds at every call."""
    import torch

    current = torch._C._cuda_getDevice()
    index = device.index if device.index is not None else current
    if index == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per source name (ptxas register and shared-memory counts).
build_logs: Dict[str, str] = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            f"{CSRC} at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources that have no library yet, one ``nvcc`` per
    source, all started together. Returns each name's library path."""
    paths = {name: _lib_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib
