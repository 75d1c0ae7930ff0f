"""Batch jobs against a served ``_tl`` model, each chip with its dates and
location: ``serve_closed``'s closed loop, one client with a fixed number of
batches in flight, with each request's coords passed to the fused predict.

The system under test is ``ModelServer(cfg).model`` driven through
``ops/preprocess.py:make_fused_predict_fn`` with the server's preprocess
settings: raw integer chips and their coords go in (``predict(raw,
temporal_coords, location_coords)``), classes come out. The inputs are
``serve_closed``'s pool of seeded host batches of raw chips, and beside
each batch its chips' coords as host numpy arrays, float32: (B, T, 2) year
and day of year of each frame, (B, 2) latitude and longitude, drawn per
chip from the seed within the traffic's ``coords`` ranges (one year per
chip, T distinct ascending days of year).

Requests, metrics and the check are ``serve_closed``'s; the reference takes
each checked batch's coords, and so does the BatchNorm calibration.

Stand-ins for the readings (``ctx.control``): ``no_coords``, the program
called without coords (adding no embedding, as a ``_tl`` model was served
before the fused predict took them); ``int8``, the program's int8 path
(``tpu.quant: int8``); ``fp8``, the reference computed in float8 in the
program's place, one precision below the configuration's bf16 (no window).
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from h100bench import check
from h100bench.common import derive_seed, make_weights, percentile, reference_module
from h100bench.kinds.serve_closed import (
    _calibration_chips,
    _preprocess,
    _raw_pool,
    _release_cache,
    _server,
)

CONTROLS = ("no_coords", "int8", "fp8")


def _coords_pool(ctx, n_pool: int, batch: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n_pool`` pairs of host arrays: (B, T, 2) float32 year and day of
    year, (B, 2) float32 latitude and longitude, per chip from the seed."""
    c = ctx.traffic["coords"]
    t = int(ctx.config["model"]["num_frames"])
    rng = np.random.default_rng(derive_seed(ctx.seed, "coords"))
    days = np.arange(c["days_of_year"][0], c["days_of_year"][1] + 1)
    pool = []
    for _ in range(n_pool):
        years = rng.integers(c["years"][0], c["years"][1] + 1, (batch, 1))
        doy = np.sort(np.stack([rng.choice(days, t, replace=False) for _ in range(batch)]))
        temporal = np.stack([np.repeat(years, t, axis=1), doy], axis=-1).astype(np.float32)
        location = np.stack([rng.uniform(*c["latitude"], batch),
                             rng.uniform(*c["longitude"], batch)], axis=1).astype(np.float32)
        pool.append((temporal, location))
    return pool


def _program_takes_coords() -> None:
    """Fail at once where the program's server does not take coords."""
    from instageo_tpu_torch.serve.server import ModelServer

    if not hasattr(ModelServer, "uses_coords"):
        raise RuntimeError("this program's fused predict takes no time or location coords "
                           "(ModelServer has no uses_coords): it cannot serve this cell")


def run(ctx) -> Dict:
    tr = ctx.traffic
    batch, in_flight, n_pool = int(tr["batch"]), int(tr["in_flight"]), int(tr["pool"])
    dev, ev = ctx.device, ctx.events
    if ctx.control not in (None,) + CONTROLS:
        raise ValueError(f"control {ctx.control!r}; this kind takes {CONTROLS}")
    if ctx.control != "fp8":
        _program_takes_coords()
    ref = reference_module(ctx.config)
    m = ctx.config["model"]

    # --- set-up -------------------------------------------------------------
    pool = _raw_pool(ctx, n_pool, batch)
    coords = _coords_pool(ctx, n_pool, batch)
    ctx.lap("raw chips and coords")
    pre = _preprocess(ctx)
    weights = make_weights(ref.param_spec(m), ctx.seed, dev)
    n_cal = int(tr["calibration_chips"])
    with ref.float32_exact():
        calib = ref.calibrate_bn(weights, _calibration_chips(ctx, pool), m, pre,
                                 *(torch.from_numpy(c[:n_cal]).to(dev) for c in coords[0]))
    weights.update(calib)
    calib = {n: t.cpu() for n, t in calib.items()}
    ctx.lap("weights")
    rng = np.random.default_rng(derive_seed(ctx.seed, "order"))
    order = rng.permutation(n_pool)
    checked = set(rng.choice(n_pool, size=int(tr["check_pool_batches"]), replace=False).tolist())
    if ctx.control == "fp8":   # the reference in the program's place: no window
        del weights
        params = _reference_params(ctx, ref, m, calib)
        kept = [(k, _reference_logits(ctx, ref, m, params, pool, coords, pre, k, quant="fp8")
                 .argmax(dim=1).to(torch.int8).cpu().numpy()) for k in sorted(checked)]
        del params
        _release_cache(dev)
        numbers = compare(ctx, ref, m, pool, coords, kept, calib, pre)
        correct, shown = check.judge(numbers, ctx.limits)
        return {"metrics": {}, "attempted": 0, "failed": 0, "memory_peak_bytes": 0,
                "correct": correct, "check": shown, "numbers": numbers, "requests": 0}
    server, predict = _server(ctx, weights)
    del weights
    _release_cache(dev)   # the device then holds what the program holds
    ctx.lap("server")
    with_coords = ctx.control != "no_coords"
    pinned = dev.type == "cuda"
    host_out = None

    def send(i: int, due: float):
        nonlocal host_out
        k = int(order[i % n_pool])
        with torch.profiler.record_function("bench.predict"):
            preds = predict(pool[k], *coords[k]) if with_coords else predict(pool[k])
        if host_out is None:
            host_out = [torch.empty(preds.shape, dtype=preds.dtype, pin_memory=pinned)
                        for _ in range(in_flight)]
        with torch.profiler.record_function("bench.copy_back"):
            out = host_out[i % in_flight]
            out.copy_(preds, non_blocking=pinned)
            done = ev.record()
        return i, k, due, done, out, preds

    for i in range(int(tr["warmup_requests"])):          # the one shape, warmed
        _, _, _, done, out, _ = send(i, 0.0)
        ev.wait(done)
        ctx.lap(f"warm-up request {i}")
    ev.sync()
    gc.collect()

    # --- the window ---------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    queue = collections.deque()
    lat, kept = [], []
    state = {"sent": 0, "done": 0, "t_last": t_start, "completed": 0}
    trace = ctx.tracer if ctx.trace else None
    t_a, t_b = tr["trace_requests"] if trace is not None else (0, 0)
    phase, trace_first = "before", 0

    def complete(item) -> float:
        i, k, due, done, out, _ = item
        with torch.profiler.record_function("bench.wait"):
            ev.wait(done)
        t_done = time.perf_counter()
        state["completed"] += 1
        if t_done - t_start <= ctx.seconds:
            lat.append(t_done - due)
            state["done"] += 1
            state["t_last"] = t_done
        if k in checked:
            kept.append((k, out.numpy().copy()))
        return t_done

    def may_send(now: float) -> bool:
        if phase == "on":
            return state["sent"] - trace_first < t_b
        return now - t_start < ctx.seconds or (trace is not None and phase == "before")

    def refill(now: float) -> None:
        while len(queue) < in_flight and may_send(now):
            queue.append(send(state["sent"], now))
            state["sent"] += 1

    refill(t_start)
    while queue:
        t_done = complete(queue.popleft())
        if trace is not None and phase == "before" and state["completed"] >= t_a:
            while queue:   # the traced stretch starts with nothing in flight
                t_done = complete(queue.popleft())
            trace.start()
            phase, trace_first = "on", state["sent"]
        elif phase == "on" and not queue and state["sent"] - trace_first >= t_b:
            trace.stop(chips=batch * t_b, requests=t_b)
            phase = "after"
        refill(t_done)
    sent, done_n, t_last = state["sent"], state["done"], state["t_last"]
    ev.sync()
    memory_peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    rate = batch * done_n / max(t_last - t_start, 1e-9)
    out_metrics = {
        "serve_chips_per_s": rate,
        "serve_p95_ms": 1e3 * percentile(lat, 95),
        "peak_gib": memory_peak / 2**30,
        "setup_s": setup_s,
    }
    ctx.notes.append(f"window: {done_n} requests of {batch} chips in {t_last - t_start:.3f} s; "
                     f"p50 {1e3 * percentile(lat, 50):.3f} ms; kept for the check: "
                     f"{len(kept)} from pool batches {sorted(checked)}")

    # --- the check, with the program's state freed --------------------------
    del server, predict, queue, host_out
    _release_cache(dev)
    numbers = compare(ctx, ref, m, pool, coords, kept, calib, pre)
    correct, shown = check.judge(numbers, ctx.limits)
    return {"metrics": out_metrics, "attempted": sent, "failed": 0,
            "memory_peak_bytes": memory_peak, "correct": correct, "check": shown,
            "numbers": numbers, "requests": done_n}


def _reference_params(ctx, ref, m, calib) -> Dict[str, torch.Tensor]:
    ref.exact_float32()
    params = make_weights(ref.param_spec(m), ctx.seed, ctx.device)
    params.update({n: t.to(ctx.device) for n, t in calib.items()})
    return params


def _reference_logits(ctx, ref, m, params, pool, coords, pre, k, quant=None) -> torch.Tensor:
    dev = ctx.device
    raw = torch.from_numpy(pool[k].astype(np.int32)).to(dev)
    temporal, location = (torch.from_numpy(c).to(dev) for c in coords[k])
    return ref.serve_logits(params, raw, m, pre, temporal, location, quant=quant)


def compare(ctx, ref, m, pool, coords, kept, calib, pre) -> Dict[str, float]:
    """Gaps of every kept answer against the reference's logits of its
    pool batch and coords, from the same weights and BatchNorm statistics."""
    if not kept:
        return {"max_gap": float("inf"), "mean_gap": float("inf"), "wrong_share": float("inf")}
    params = _reference_params(ctx, ref, m, calib)
    stats = check.GapStats(ctx.limits.get("_wrong_gap"))
    for k in sorted({k for k, _ in kept}):
        lg = _reference_logits(ctx, ref, m, params, pool, coords, pre, k)
        for kk, served in kept:
            if kk == k:
                stats.add(lg, torch.from_numpy(served).to(ctx.device))
        del lg
    return stats.numbers()
