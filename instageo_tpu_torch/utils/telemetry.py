"""Telemetry: FLOP counting, energy and carbon estimates, profiling, timers.

Counterpart of ``instageo_tpu/utils/telemetry.py``:

* ``get_model_complexity``: FLOPs of one forward from
  ``torch.utils.flop_counter.FlopCounterMode``;
* ``EmissionsTracker``: energy from wall time × the card's power draw,
  read with ``nvidia-smi --query-gpu=power.draw`` at start and stop;
* ``profile_trace``: a ``torch.profiler`` trace written to a directory;
* ``count_params`` and ``StepTimer``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

# Global grid average (kgCO2e/kWh), codecarbon's world default.
CARBON_INTENSITY = 0.475


@torch.no_grad()
def get_model_complexity(model: nn.Module, x: torch.Tensor) -> Dict[str, float]:
    """FLOPs of ``model(x)``, counted by ``FlopCounterMode``.

    The attention kernel is a ctypes call inside an ``autograd.Function``,
    which the counter does not see, so the forward is counted on the plain
    attention route (its two matmuls are the attention's 4·B·H·L²·Dh).
    """
    from torch.utils.flop_counter import FlopCounterMode

    blocks = [blk.attn for blk in model.prithvi_encoder.blocks]
    impls = [attn.attn_impl for attn in blocks]
    was_training = model.training
    model.eval()
    try:
        for attn in blocks:
            attn.attn_impl = "plain"
        with FlopCounterMode(display=False) as counter:
            model(x)
        flops = float(counter.get_total_flops())
    finally:
        for attn, impl in zip(blocks, impls):
            attn.attn_impl = impl
        model.train(was_training)
    return {"flops": flops, "gflops": flops / 1e9}


def count_params(model: nn.Module) -> int:
    return sum(int(p.numel()) for p in model.parameters())


def power_draw_w() -> Optional[float]:
    """The first card's power draw in watts, or None without ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclass
class EmissionsTracker:
    """Wall time × the mean of the card's power draw at start and stop
    (codecarbon's method). Without ``nvidia-smi`` the power and energy are
    None."""

    name: str = "instageo"
    output_dir: Optional[str] = None
    _start: float = 0.0
    _start_w: Optional[float] = None
    results: Dict[str, Optional[float]] = field(default_factory=dict)

    def start(self) -> None:
        self._start_w = power_draw_w()
        self._start = time.time()

    def stop(self) -> Dict[str, Optional[float]]:
        elapsed = time.time() - self._start
        end_w = power_draw_w()
        watts = None
        if self._start_w is not None and end_w is not None:
            watts = (self._start_w + end_w) / 2
        energy_kwh = None if watts is None else watts * elapsed / 3.6e6
        self.results = {
            "duration_s": elapsed,
            "power_w": watts,
            "energy_kwh": energy_kwh,
            "emissions_kg": None if energy_kwh is None else energy_kwh * CARBON_INTENSITY,
        }
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, f"{self.name}_emissions.json"), "w") as f:
                json.dump(self.results, f)
        return self.results

    def __enter__(self) -> "EmissionsTracker":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace (CPU, and CUDA when there is a card) of
    the block, written to ``<log_dir>/trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("Profiler trace written to %s", path)


class StepTimer:
    """Per-step wall-clock timing with summary statistics."""

    def __init__(self) -> None:
        self.times = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }
