"""Batch jobs against the served model: a closed loop of one client with a
fixed number of batches in flight, as ``serve/infer.py:
chip_inference_from_paths`` pipelines them.

The system under test is ``ModelServer(cfg).model`` driven through
``ops/preprocess.py:make_fused_predict_fn`` with the server's preprocess
settings: raw integer chips go in, classes come out; each batch's classes
are copied back into pinned host memory without blocking the host. The
inputs are a pool of seeded host batches of raw chips, drawn on the device
and kept in pageable host memory, as a decoder hands them over.

A request is one batch. It is due when the request ``in_flight`` places
before it completed (the window's first ones at its start), and done when
its classes are in host memory. Counted in the window: requests done by its
end. ``serve_chips_per_s``: their chips over the time from the window's
start to the last of them; ``serve_p95_ms``: the 95th percentile of their
due-to-done times; ``peak_gib``: the most device memory the process held
(``max_memory_reserved``) over the window, the harness's own set-up
tensors released before the warm-up.

Checked: every request of the window whose input is one of
``check_pool_batches`` pool batches drawn from the seed; each pixel's
class against the reference's logits of that batch (``check.GapStats``).
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Dict

import numpy as np
import torch

from h100bench import check
from h100bench.common import derive_seed, make_weights, percentile, program_config, reference_module


def _raw_pool(ctx, n_pool: int, batch: int):
    """``n_pool`` host batches of raw uint16 chips (B, bands, S, S), each
    band N(dn_mean, dn_std) clipped to [0, dn_max], drawn on the device."""
    raw = ctx.config["raw_chips"]
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(derive_seed(ctx.seed, "inputs"))
    mean = torch.tensor(raw["dn_mean"], dtype=torch.float32, device=dev)[None, :, None, None]
    std = torch.tensor(raw["dn_std"], dtype=torch.float32, device=dev)[None, :, None, None]
    shape = (batch, raw["bands"], raw["size"], raw["size"])
    pool = []
    for _ in range(n_pool):
        x = torch.randn(shape, generator=gen, device=dev).mul_(std).add_(mean)
        x = x.round_().clamp_(0, raw["dn_max"]).to(torch.int32)
        pool.append(x.cpu().numpy().astype(np.uint16))
    return pool


def _server(ctx, weights):
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
    from instageo_tpu_torch.serve.server import ModelServer

    overrides = dict(ctx.overrides)
    if ctx.control == "int8":
        overrides["tpu.quant"] = "int8"
    cfg = program_config(ctx.config, overrides)
    server = ModelServer(cfg, device=ctx.device)
    server.model.load_state_dict(weights, strict=True)
    predict = make_fused_predict_fn(server.model, is_reg_task=server.is_reg_task,
                                    **server.preprocess)
    return server, predict


def run(ctx) -> Dict:
    tr = ctx.traffic
    batch, in_flight, n_pool = int(tr["batch"]), int(tr["in_flight"]), int(tr["pool"])
    dev, ev = ctx.device, ctx.events
    ref = reference_module(ctx.config)
    m = ctx.config["model"]

    # --- set-up -------------------------------------------------------------
    pool = _raw_pool(ctx, n_pool, batch)
    ctx.lap("raw chips")
    pre = _preprocess(ctx)
    weights = make_weights(ref.param_spec(m), ctx.seed, dev)
    with ref.float32_exact():
        calib = ref.calibrate_bn(weights, _calibration_chips(ctx, pool), m, pre)
    weights.update(calib)
    calib = {n: t.cpu() for n, t in calib.items()}
    ctx.lap("weights")
    server, predict = _server(ctx, weights)
    del weights
    _release_cache(dev)   # the device then holds what the program holds
    ctx.lap("server")
    rng = np.random.default_rng(derive_seed(ctx.seed, "order"))
    order = rng.permutation(n_pool)
    checked = set(rng.choice(n_pool, size=int(tr["check_pool_batches"]), replace=False).tolist())
    pinned = dev.type == "cuda"
    host_out = None

    def send(i: int, due: float):
        nonlocal host_out
        k = int(order[i % n_pool])
        with torch.profiler.record_function("bench.predict"):
            preds = predict(pool[k])
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
    numbers = compare(ctx, ref, m, pool, kept, calib, pre)
    correct, shown = check.judge(numbers, ctx.limits)
    return {"metrics": out_metrics, "attempted": sent, "failed": 0,
            "memory_peak_bytes": memory_peak, "correct": correct, "check": shown,
            "numbers": numbers, "requests": done_n}


def compare(ctx, ref, m, pool, kept, calib, pre) -> Dict[str, float]:
    """Gaps of every kept answer against the reference's logits of its
    pool batch, from the same weights and BatchNorm statistics."""
    dev = ctx.device
    if not kept:
        return {"max_gap": float("inf"), "mean_gap": float("inf"), "wrong_share": float("inf")}
    ref.exact_float32()
    params = make_weights(ref.param_spec(m), ctx.seed, dev)
    params.update({n: t.to(dev) for n, t in calib.items()})
    stats = check.GapStats(ctx.limits.get("_wrong_gap"))
    for k in sorted({k for k, _ in kept}):
        raw = torch.from_numpy(pool[k].astype(np.int32)).to(dev)
        lg = ref.serve_logits(params, raw, m, pre)
        for kk, served in kept:
            if kk == k:
                stats.add(lg, torch.from_numpy(served).to(dev))
        del lg, raw
    return stats.numbers()


def _release_cache(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _preprocess(ctx) -> Dict:
    """The configuration's preprocessing, as the reference takes it."""
    dl = ctx.config["program"]["dataloader"]
    return dict(bands=dl.get("bands"), mean=dl["mean"], std=dl["std"],
                temporal_size=dl.get("temporal_dim", 1),
                constant_multiplier=dl.get("constant_multiplier", 1.0),
                img_size=dl.get("img_size", 224))


def _calibration_chips(ctx, pool) -> torch.Tensor:
    """The chips the BatchNorm statistics are taken over: the first
    ``calibration_chips`` of the first pool batch."""
    n = int(ctx.traffic["calibration_chips"])
    return torch.from_numpy(pool[0][:n].astype(np.int32)).to(ctx.device)
