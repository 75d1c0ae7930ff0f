"""The traced sub-window of a ``--trace 1`` run: ``torch.profiler`` over a
steady stretch of the window, reduced to a compact summary (device time by
kernel name, busy and idle time, idle gaps by what the host was doing, the
program's counters), and no timeline is kept.

The window on the device runs from the first to the last device operation
recorded; a device operation is a kernel, a memcpy or a memset. Busy is
the union of their intervals; an idle gap is labelled with the innermost
host range (the harness's ``bench.*`` spans, else the program's operator or
runtime call) that was open at the gap's middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
SMALL_GAP_US = 20.0   # shorter gaps are launch-to-launch, lumped together
SMALL_GAP_LABEL = "(gaps under 20 us between device operations)"
SCAN = 2000           # host ranges looked at per gap


def counters() -> Dict[str, int]:
    """The program's launch counters (graph replays included)."""
    from instageo_tpu_torch.ops import _build, attention, dropout

    return {
        "attn_fwd_calls": attention.launches.total(),
        "attn_bwd_calls": attention.bwd_launches.total(),
        "dropout_calls": dropout.launches.total(),
        "graph_replays": _build.graph_replays.count,
    }


class Tracer:
    """Start and stop the profiler around a sub-window; ``units`` counts
    the chips, steps and requests that completed inside it."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.prof = None
        self.summary: Optional[Dict] = None
        self.units: Dict[str, float] = {}
        self._c0: Dict[str, int] = {}

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._c0 = counters()
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self, **units: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        c1 = counters()
        self.units = dict(units, **{k: c1[k] - self._c0[k] for k in c1})
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.summary = summarize(events)
        self.summary["units"] = self.units
        self.prof = None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[Dict]) -> Dict:
    """Reduce a Chrome trace's events (times in microseconds) to seconds:
    ``busy_s``, ``window_s``, ``kernels`` {name: [count, seconds]},
    ``memcpy`` {kind: seconds}, ``idle`` {label: seconds}."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), cat, e.get("name", "")))
        elif cat in HOST_CATS:
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), cat, e.get("name", "")))
    kernels: Dict[str, List[float]] = {}
    memcpy: Dict[str, float] = {}
    for s, e, cat, name in dev:
        if cat == "kernel":
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (e - s) * 1e-6
        else:
            memcpy[name] = memcpy.get(name, 0.0) + (e - s) * 1e-6
    busy = _merge([(s, e) for s, e, _, _ in dev])
    if not busy:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": kernels, "memcpy": memcpy,
                "idle": {}}
    start, end = busy[0][0], busy[-1][1]
    busy_s = sum(e - s for s, e in busy) * 1e-6
    idle: Dict[str, float] = {}
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2] == "user_annotation" and h[3].startswith("bench.")]
    for gs, ge in gaps:
        if ge - gs < SMALL_GAP_US:
            label = SMALL_GAP_LABEL
        else:
            label = _host_label(host, starts, spans, 0.5 * (gs + ge))
        idle[label] = idle.get(label, 0.0) + (ge - gs) * 1e-6
    return {"busy_s": busy_s, "window_s": (end - start) * 1e-6, "kernels": kernels,
            "memcpy": memcpy, "idle": idle}


def _host_label(host, starts, spans, t: float) -> str:
    """The innermost host range open at ``t``: a ``bench.*`` span, and the
    shortest operator or runtime call among the ``SCAN`` that started last
    before ``t``."""
    bench = [s for s in spans if s[0] <= t <= s[1]]
    best = None
    i = bisect.bisect_right(starts, t)
    for s, e, cat, name in reversed(host[max(0, i - SCAN):i]):
        if e >= t and cat != "user_annotation" and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    parts = []
    if bench:
        parts.append(min(bench, key=lambda s: s[1] - s[0])[3])
    if best is not None:
        parts.append(best[2])
    return " / ".join(parts) if parts else "(no host range)"


def kernel_class(name: str) -> str:
    """A kernel's class by its symbol's name."""
    n = name.lower()
    if "flash_attn_fwd" in n:
        return "attn_fwd"
    if "flash_attn_bwd" in n:
        return "attn_bwd"
    if "fused_dropout" in n:
        return "dropout"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "matmul")):
        return "matmul"
    if "adam" in n or "multi_tensor_apply" in n:
        return "optimizer"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def class_seconds(summary: Dict, cls: str) -> float:
    """Device seconds of the kernels of one class in the traced stretch."""
    return sum(v[1] for name, v in summary["kernels"].items() if kernel_class(name) == cls)


def transfer_seconds(summary: Dict) -> float:
    """Device seconds of copies between host and device."""
    return sum(s for name, s in summary["memcpy"].items()
               if "HtoD" in name or "DtoH" in name)


def breakdown(summary: Dict) -> Dict:
    """The contract's optional ``breakdown``: the ten device operations
    that took most time, and the ten host labels with the most idle."""
    ops = [(name[:160], v[1]) for name, v in summary["kernels"].items()]
    ops += [(name[:160], s) for name, s in summary["memcpy"].items()]
    ops.sort(key=lambda kv: -kv[1])
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n[:160], s] for n, s in idle[:10]]}
