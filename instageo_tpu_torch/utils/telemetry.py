"""Telemetry: FLOP counting, energy and carbon estimates, profiling, timers.

Counterpart of ``instageo_tpu/utils/telemetry.py``:

* ``get_model_complexity``: FLOPs of one forward from
  ``torch.utils.flop_counter.FlopCounterMode``;
* ``EmissionsTracker``: energy from wall time × the card's power draw,
  read with ``nvidia-smi --query-gpu=power.draw`` at start and stop;
* ``profile_trace``: a ``torch.profiler`` trace written to a directory;
* ``count_params`` and ``StepTimer``;
* ``rank_footprint``: what one rank of a run holds and launched: its
  parameter and AdamW-moment bytes (its shards under FSDP, ZeRO-1 or
  tensor parallelism), the card's peak memory, and its train epoch's
  kernel launches and collectives.
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


def get_carbon_info(tracker: EmissionsTracker) -> Dict[str, Optional[float]]:
    """The tracker's last results (the reference's ``get_carbon_info``)."""
    return dict(tracker.results)


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


def _local_bytes(t: torch.Tensor) -> int:
    t = t.to_local() if hasattr(t, "to_local") else t
    return int(t.numel()) * t.element_size()


def kernel_launches() -> Dict[str, int]:
    """Launches of each Hopper kernel in this process (direct and through
    CUDA graph replays), by route."""
    from instageo_tpu_torch.ops import attention, dropout

    fwd, bwd = attention.launches.total(), attention.bwd_launches.total()
    fwd_mma, bwd_mma = attention.fwd_mma_launches.total(), attention.bwd_mma_launches.total()
    return {"flash_attn_fwd_sm90": fwd - fwd_mma, "flash_attn_fwd": fwd_mma,
            "flash_attn_bwd_sm90": bwd - bwd_mma, "flash_attn_bwd": bwd_mma,
            "fused_dropout": dropout.launches.total()}


def rank_footprint(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
                   history: Dict) -> Dict:
    """This rank's parameter and moment bytes, peak device memory (on a
    card), and the kernel launches and the parallel layer's own collectives
    (``parallel/mesh.py:collectives``) of its last train epoch (``history``:
    ``Trainer.fit``'s)."""
    moments = 0
    if optimizer is not None:
        local = getattr(optimizer, "optim", optimizer)  # ZeroRedundancyOptimizer's share
        moments = sum(_local_bytes(v) for st in local.state.values() for v in st.values()
                      if isinstance(v, torch.Tensor) and v.dim() > 0)
    device = next(model.parameters()).device
    return {
        "param_bytes": sum(_local_bytes(p) for p in model.parameters()),
        "moment_bytes": moments,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "train_launches": history.get("train_launches"),
        "train_collectives": history.get("train_collectives"),
    }
