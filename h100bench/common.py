"""Pieces every traffic kind shares: seeds, the weights made from a seed, the
program's configuration object, host clocks and device events, and the
run's context."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_module(path: Path, name: str):
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reference_module(config: Dict):
    """The plain reference named by the configuration (``reference``)."""
    return load_module(HERE / "reference" / f"{config['reference']}.py",
                       f"h100bench_reference_{config['reference']}")


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``spec`` (a reference's
    ``param_spec``) as float32 on ``device``, from ``seed``: one draw of
    uniforms and one of normals with a generator on the device, then each
    leaf's slice scaled to its init."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "weights"))
    n_uni = sum(_numel(s) for _, s, init in spec if init[0] in ("uniform", "range"))
    n_nor = sum(_numel(s) for _, s, init in spec if init[0] == "normal")
    uni = torch.rand(n_uni, generator=gen, device=device)
    nor = torch.randn(n_nor, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for name, shape, init in spec:
        n = _numel(shape)
        kind = init[0]
        if kind == "uniform":
            t = uni[iu:iu + n].mul(2.0 * init[1]).sub_(init[1])
            iu += n
        elif kind == "range":
            t = uni[iu:iu + n].mul(init[2] - init[1]).add_(init[1])
            iu += n
        elif kind == "normal":
            t = nor[inn:inn + n].mul(init[1])
            inn += n
        elif kind == "const":
            t = torch.full((n,), float(init[1]), device=device)
        elif kind == "count":
            t = torch.zeros((), dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t.reshape(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def program_config(config: Dict, overrides: Optional[Dict] = None):
    """The program's configuration object (``ConfigDict``) from the
    configuration file's ``program`` section, with dotted ``overrides``."""
    from instageo_tpu_torch.configs.config import ConfigDict

    cfg = json.loads(json.dumps(config["program"]))
    for key, value in (overrides or {}).items():
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return ConfigDict.wrap(cfg)


class Events:
    """Device events and synchronisation on a CUDA device; on the CPU
    (the harness's tests) every event has already happened."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def record(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait(self, ev) -> None:
        if ev is not None:
            ev.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


@dataclass
class Context:
    """What a traffic kind's ``run`` is handed: the cell's files, the run's arguments and
    the device."""

    cell: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float                    # perf_counter() at the process's start
    tracer: Any = None
    overrides: Dict[str, Any] = field(default_factory=dict)   # program config
    control: Optional[str] = None       # readings: what stands in the program's place
    notes: List[str] = field(default_factory=list)
    laps: List = field(default_factory=list)

    def lap(self, name: str) -> None:
        """Mark the end of a set-up phase (seconds since the process began)."""
        self.laps.append((name, time.perf_counter() - self.t_process))

    @property
    def events(self) -> Events:
        return Events(self.device)


def process_start() -> float:
    """``time.perf_counter()`` at the moment this process started, read
    from the kernel's record of its start (else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        import os

        hz = os.sysconf("SC_CLK_TCK")
        since_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - max(0.0, since_boot - start_ticks / hz)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


def percentile(values: List[float], pct: float) -> float:
    """The ``pct`` percentile by the nearest rank."""
    if not values:
        return float("nan")
    s = sorted(values)
    rank = max(1, int(-(-pct * len(s) // 100)))
    return s[min(rank, len(s)) - 1]
