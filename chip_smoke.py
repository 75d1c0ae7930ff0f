#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, one line each (any failure raises and exits non-zero):

1. device: the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build: every CUDA source under ``instageo_tpu_torch/ops/csrc``, in parallel,
   and the native GeoTIFF decoder (``instageo_tpu_torch/native``) beside
   them, with what the machine offers it (zlib's header and library), or
   the reason it is unavailable;
3. kernels: each kernel (attention forward, attention backward, fused
   dropout) against its plain PyTorch version on the shapes the serving and
   training paths give it, with its time, the plain version's, one PyTorch
   library call's (a yardstick only) and the card's bound for the same work;
   each kernel's device time per call from ``torch.profiler`` beside its
   earlier design's at the same shapes, in turns: the attention routes by
   head dim (wgmma for Dh 64 and 80, beside the mma.sync kernels); the
   backward's dq, dk and dv bit for bit from one call to the next; the
   dropout's mask equal to the plain Philox stream bit for bit, with its
   seed by value and from device memory, the two timed in turns; under
   deterministic mode the backward on its default (wgmma) route, two calls
   bit-equal;
4. slice: Prithvi-V1-100M at full width (T=3, 224 px, 13 classes, bf16,
   random weights from a seed) behind ``ModelServer``: online requests from
   8 threads through the dynamic batcher and one batch run over synthetic
   18-band chip files; the kernel launch count of that run (every forward
   launch on the wgmma route, none on mma.sync); kernel-vs-plain
   logits on one batch; chips/s at batch 16 and 64;
5. train: the crop config (float32 parameters, bf16 compute, AdamW lr 1e-4,
   wd 0.01, the config's class weights, ignore_index -1) through
   ``Trainer``: 10 steps on one fixed batch of 8 with the launches per step
   (none on either mma.sync route),
   one step with the kernels against one with the plain versions, a train
   and an eval epoch (partial last batch), and chips/s at batch 8 and 32;
6. graph: ``tpu.steps_per_call: auto`` (8 optimizer steps per CUDA graph
   at batch 8) against the one-step loop over 24 batches from the same
   weights and seeds, each run twice: launches per step through the
   replays; captured = eager and each run = its rerun bit for bit (losses
   and parameters), and again under deterministic mode; one group replayed
   twice from the state after the first group against plain steps from
   that state, bit for bit; the attention forward and backward captured
   alone, bit for bit; a dropout graph replayed with two
   seeds; ms per step eager vs captured at batch 8 and 32, and per eval
   batch at 8, in turns; the grouped eval epoch vs the eager;
7. loader: full-size synthetic chips through the native decoder and the
   Python codec (bit for bit), batch jobs at batch 64 with each (in turns),
   a loader epoch without and with the decoded-chip cache (cold, warm), a
   loader's first batch from a worker thread and a worker process, and an
   epoch of spawned workers dropped after its first batch, which must end
   cleanly;
8. run: the run CLI (``python -m instageo_tpu_torch.train.run``, called
   in-process) on the crop config as a user runs it (a loader thread, the
   chip cache, graphs of 8 steps) over 128 train and 16 val synthetic
   18-band chips and their CSVs: ``stats``, ``train`` (one epoch), ``eval``
   on the best checkpoint, ``chip_inference``; each mode's launches (every
   attention launch on the wgmma route, 5 dropout launches per step,
   replays included), eval against the saved epoch's validation metrics,
   the CLI's predictions against ``ModelServer``'s; chips/s and wall
   seconds per mode;
   replica: ``mode=replica`` of the same CLI (stats, train, eval on val and
   test, the report) over 128 + 16 + 16 such chips, from a fresh init
   (``replica.require_pretrained=False``): each stage's launches and
   seconds, the report naming the card, the test split's metrics against a
   direct ``mode=eval`` of the best checkpoint;
9. serve_models: every model the JAX package builds, through the serving
   entry points (``ModelServer(cfg)``, ``EvaluationPipeline``, the export
   artifact), bf16 with random weights from seed 0: the crop model with
   the fast head against the torch head at batch 64 (ms per predict in
   turns, launches per predict, kernel vs plain logits); the fast head in
   training (10 steps with the launches per step, then kernel vs plain);
   ``prithvi_eo_v2_300_tl`` (T=4, batch 16) and ``prithvi_eo_v2_600_tl``
   (T=4, Dh 80, batch 4): launches per predict, kernel vs plain logits and
   encoder features with and without coords; the GELU lowerings in turns; the serving layer on a
   fast-head checkpoint (pipeline evaluate = ``Trainer.test``, chip
   inference = the online batcher on decided pixels, the artifact run in a
   fresh interpreter without the port's models, its size); one JSON line
   per row, tagged ``[serve_models]``;
   quant: ``tpu.quant: int8`` (W8A8 through ``torch._int_mm``) through
   ``ModelServer(cfg)`` at batch 64: ms per predict against bf16 in turns,
   launches per predict, kernel vs plain attention, int8 vs bf16 argmax,
   the card against the CPU, the export artifact in a fresh interpreter,
   the Trainer's refusal, one fc1 GEMM int8 vs bf16 in turns; then a
   ``tpu.precision: f32`` model on the "xla" attention route (no kernel
   launch) against the CPU;
10. granule: whole-granule inference as a user runs it,
    ``mode=sliding_inference`` of the run CLI (in-process) on the crop config
    from a dataset JSON over a synthetic HLS MGRS tile (T=3 granules, one
    L30 and two S30, six band files each plus Fmask, 3660² px, a 300² px
    nodata block), random weights from seed 0 in a checkpoint, at batch 8
    (the yaml's) and 64: the prediction GeoTIFF (int8, the tile's
    georeferencing, −1 exactly on the block), 12 forward launches per chip
    batch on wgmma and none on mma.sync, the stitched canvas = the fused
    predict on the same batch (the last padded, as the path pads it) at 8
    chip windows bit for bit, the kernel vs the plain attention over the
    whole granule on decided pixels, a run at overlap 16 with full coverage
    and the kernel vs plain there too; decode, host-to-device, device,
    first-batch and wall seconds per granule, chips/s, peak device memory;
    then the CLI at batch 8 in two fresh interpreters on one
    ``INSTAGEO_COMPILE_CACHE_DIR``, one that builds the forward kernel there
    at its first launch and one that loads it from there with ``nvcc``
    barred: the cold cost a user's first and later runs pay; the second
    first runs serve_models' and quant's export artifacts (one interpreter
    for the three);
11. chip_ops: ``process_tile_chips`` on the same tile (196 chips of 256 px,
    Fmask cloud and shadow masking ``each`` and ``any``, 50,000 points with
    one dense chip): card = CPU bit for bit, also under deterministic mode;
    ms on each;
12. chip_creator: observations to chips to predictions, as a user runs the
    data CLIs (in-process, the STAC search answered with items of the
    granule tile: no network): 5,000 labelled points in EPSG:4326 over the
    tile through ``instageo_tpu_torch.data.chip_creator`` (HLS, 224 px,
    cloud masking, three steps 5 days apart that pick the three granules)
    with ``--device=cuda`` and ``--device=cpu``: every file equal byte for
    byte, the 16 x 16 grid of 18-band chips, probe chips equal to the
    tile's masked pixels and their seg maps to the points' labels, no kernel
    launched; the card run's manifest through ``mode=chip_inference`` (one
    prediction per chip, 12 forward launches per chip batch, none on
    mma.sync); ``raster_chip_creator --is_bbox_feature=true`` over a bbox in
    the tile on both devices, equal; wall, decode and ``process_tile_chips``
    seconds, peak device memory;
    data_prep: on the host, the data cleaner (drop, buffer, limit) over the
    card run's chips and the splitter over the cleaned CSV; whether
    ``libopenjp2`` loads and decodes the committed JP2 fixture; whether
    matplotlib is here for the regression plot;
13. webapp: the web platform as it is deployed (``webapp_phase``): the
    topology of ``instageo_tpu_torch/deploy/docker-compose.yml``, the
    backend and each queue's workers started from the file's commands with
    its environment, a job process per stage, on the card; a ``POST /api/run-model`` of the
    shipped registry's ``crop_classification`` (Prithvi-EO-V2-300M at full
    width and depth, random weights from seed 0) over a bbox of the granule
    tile holding its nodata block, polled to ``completed`` (stage seconds,
    each job process's cold-start parts and launches, peak device memory);
    visualize, tilejson, previews, statistics and the map's tiles at z
    10-12 from 8 client threads (p50, p99, tiles/s, each PNG decoded); stages
    2 and 3 in this process on copies of the chips, with the kernel
    (launches 24 per chip batch; the COG = the worker-run one bit for bit)
    and with the plain attention (argmax on decided pixels); ``python -m
    instageo_tpu_torch.webapp.main`` with its own workers and auth on in a
    fresh interpreter;
14. parallel: ``parallel/`` as a user runs it (``parallel_phase``): the
    600M recipe (``configs/prithvi600_v5e8.yaml``: Prithvi-EO-V2-600M at
    full width and depth, FSDP, ZeRO-1, grad_accum 2, steps_per_call 4,
    head dropout on, random weights from the run's seed) under
    ``python -m torch.distributed.run --nproc-per-node <visible cards> -m
    instageo_tpu_torch.train.run`` over synthetic 13-band 224 px chips, 8
    optimizer steps at the global batch 128; its plain twin (the same CLI
    in one process, ``tpu.fsdp=False tpu.zero1=False``, captured groups):
    each step's loss bit for bit at world 1 (within 1e-3 relative across
    more ranks, whose gradient sums run in another order), ms per step,
    each rank's parameter and moment bytes and peak memory, launches per
    step counted around the train epoch alone (``metrics.jsonl``'s ``train_launches``:
    #1 and #3 once per block per micro-batch on the sm90 route, #6 once
    per head dropout per micro-batch); with two cards or more, the crop
    yaml as DP, tp=2, pp=2 and tp=2 sp, each within 1e-3 of one process;
    then ``tpu.remat`` at the crop model's full width (V1-100M, L 589,
    batch 8): 2 forward launches per block per step against 1, losses and
    parameters bit for bit against a run without; peak memory of each; with
    one card visible, one line says what needs two;
15. examples: the port's walkthroughs (``examples_phase``), each in a fresh
    interpreter as a user runs it, all side by side: the quickstart on the
    card (wall seconds, #1 4 per forward and #3 4 per step on the wgmma
    route and none on mma.sync, its export artifact against a
    ``ModelServer`` of its checkpoint on one batch), ``InstaGeo_Demo.ipynb``'s
    code cells in one interpreter, held to the same launches and checks,
    the multichip walkthrough under ``torch.distributed.run`` at world =
    the visible cards (each placement's loss at both steps within 1e-3 of
    data parallelism's; with one card, the tensor-parallel placement named
    as needing two), the raster chip creator demo on the card and on the
    CPU (every file equal byte for byte);
16. one JSON line ``{"kernels": [...]}``;
17. last line: ``{"ok": true, "device": {...}}``.

The model and data settings come from the port's
``configs/multitemporal_crop_classification.yaml``.

Each path runs with every launch count set to 0 just before it and read
just after it; a launch that a CUDA graph replays counts once per replay.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shlex
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial
from unittest import mock

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, dense): bf16 and int8
# tensor-core rates and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

# The configuration every path runs, from the port's config files.
CROP_CONFIG = "multitemporal_crop_classification"

# (B, H, L, Dh, output layout, inputs): the serving shape at batch 64, also
# as the model passes q/k/v ("qkv": views of one (B, L, 3, H, Dh) projection
# buffer, models/prithvi.py), the training shape at batch 8, the T=1 length
# 197, the 600M variant's heads-first shapes (Dh=80), and the serving shapes
# of the _tl variants at T=4 (300M: L=785, batch 16; 600M: L=1025, batch 4);
# other rows take contiguous q/k/v.
KERNEL_SHAPES = [
    (64, 12, 589, 64, "merged", "contiguous"),
    (64, 12, 589, 64, "merged", "qkv"),
    (8, 12, 589, 64, "merged", "contiguous"),
    (8, 12, 197, 64, "merged", "contiguous"),
    (16, 16, 513, 80, "heads_first", "contiguous"),
    (4, 16, 1025, 80, "heads_first", "contiguous"),
    (16, 16, 785, 64, "merged", "contiguous"),
    (4, 16, 1025, 80, "merged", "contiguous"),
    (8, 16, 589, 64, "merged", "contiguous"),  # the web stage 2's 300M at batch 8
    (64, 16, 257, 80, "merged", "qkv"),  # the 600M recipe's micro-batch of 64
    (8, 4, 5, 64, "merged", "contiguous"),  # the quickstart's prithvi_eo_tiny at 32 px
]
# The forward kernels' symbols, by route, as the profiler names them.
FWD_KERNEL_SYMBOL = {"wgmma": "flash_attn_fwd_sm90_kernel", "mma_sync": "flash_attn_fwd_kernel"}
# The dropout kernel's symbol (tools/profile_dropout_designs.py times the
# earlier design's beside it).
DROPOUT_SYMBOL = "fused_dropout_kernel"
# (B, H, L, Dh, entry) of the backward: the training step at batch 8 and 32,
# T=1, the 600M shapes heads-first (L=1025 trains on the card), and the
# q-blocked entry.
BWD_SHAPES = [
    (8, 12, 589, 64, "merged"),
    (32, 12, 589, 64, "merged"),
    (8, 12, 197, 64, "merged"),
    (8, 16, 513, 80, "heads_first"),
    (2, 16, 1025, 80, "heads_first"),
    (8, 16, 513, 80, "bloq"),
    (64, 16, 257, 80, "merged"),  # the 600M recipe's micro-batch of 64
    (8, 4, 5, 64, "merged"),  # the quickstart's prithvi_eo_tiny at 32 px
]
# The five dropout inputs of one batch-8 training step of the crop model: the
# four upscaling blocks' ConvTranspose outputs and the head's last dropout.
DROPOUT_SHAPES = [(8, 1152, 28, 28), (8, 576, 56, 56), (8, 288, 112, 112),
                  (8, 144, 224, 224), (8, 144, 224, 224)]
O_TOL = 3e-2    # bf16 output, atol = rtol (the JAX package's bf16 attention test)
LSE_TOL = 1e-3  # float32 row statistics, other summation order
# Backward kernel vs plain: both round dS and P to bf16 at the TPU kernel's
# points but sum in other orders, so single elements can differ by a bf16
# rounding; the whole gradient must agree to 1e-2 of its norm. From one call
# to the next the kernels give the same bits: every sum is taken in one
# thread block in a fixed order.
BWD_REL_TOL = 1e-2
KEEP_SIGMAS = 5.0  # dropout keep fraction within 5 binomial sigma of 1 - p
# One bf16 training step with the kernels vs with the plain versions
# (dropout off): other summation orders through 12 bf16 blocks. Gradients:
# ‖Δ‖ ≤ tol·‖plain gradient‖ per parameter, or, where the model is more
# sensitive than that to where the attention rounds P, GRAD_YARDSTICK_FACTOR
# times the gap of a plain step that keeps P in float32. With the torch
# head the median parameter differs by about 6e-3 and the first head stage,
# which takes the encoder's bf16 output through a BatchNorm, by 3.4e-2 to
# 5.0e-2 on an H100; with the fast head after 10 steps the median by 3e-2
# and the first head stage by 0.052, as much as the float32-P step's gap
# there (0.052). A wrong stride or a wrong wiring gives gaps of order 1.
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
GRAD_YARDSTICK_FACTOR = 1.5
TRAIN_BN_REL_TOL = 2e-2
# Kernel vs plain attention through 12 bf16 blocks: the two differ only in
# summation order, so the logits may differ by a few bf16 roundings.
LOGIT_TOL = 0.05         # max |logit diff| / max |logit|
# The same through the encoder alone, on its float32 feature map (what the
# head reads): ‖kernel − plain‖ / ‖plain‖. On an H100 4.2e-3 for the 300M
# _tl variant at T=4 (with and without coords) and 5.0e-3 for the 600M
# (32 blocks); a wrong stride or wiring gives gaps of order 1.
FEATURE_REL_TOL = 2e-2
DECIDED_GAP = 0.01       # pixels whose top-2 gap is at least this x max |logit| ...
ARGMAX_AGREEMENT = 0.99  # ... agree at least this often
# Captured vs eager training (``steps_per_call``): nothing in the step sums
# in an order that changes from run to run, so the captured and eager runs,
# and each run and its rerun, agree bit for bit (losses and parameters).
# The eval metrics within GRAPH_EVAL_TOL.
GRAPH_EVAL_TOL = 1e-3
SEED = 1042  # the run CLI's
# The run phase's wall seconds per mode when each loader spawned a worker
# process, over 48 train and 16 val chips (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md keeps the comparison).
SPAWNED_RUN_WALL_S = {"stats": 14.864, "train": 32.432, "eval": 12.282,
                      "chip_inference": 11.674}
# mode=eval on the saved checkpoint vs that epoch's validation metrics: the
# same chips, weights and batches (bf16 weights cast once at load instead of
# at each use), so they differ only by rounding.
EVAL_TOL = 1e-3


class Clock:
    """Prints each named part's wall seconds as a ``[time]`` line."""

    def __init__(self, phase: str) -> None:
        self.phase, self.t0 = phase, time.perf_counter()

    def lap(self, part: str) -> None:
        now = time.perf_counter()
        print(f"[time] {self.phase} {part}: {now - self.t0:.2f} s", flush=True)
        self.t0 = now


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, device, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call: CUDA events on a card, else the host clock."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int = 20, warmup: int = 2, match=None, attempts: int = 5) -> float:
    """Mean device time per call of ``fn`` from a ``torch.profiler`` trace of
    ``iters`` calls. Unlike ``time_ms`` it leaves out the host's time and the
    gaps between launches. With ``match``, ``fn`` launches one kernel whose
    name holds it: the mean over its traced launches (the trace may miss a
    launch). Without, every kernel counts, summed over ``iters``: a trace in
    which the longest kernel does not run a whole number of times per call
    lost events and is taken again, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if match is not None:
            times = [t for name, ts in by_name.items() if match in name for t in ts]
            if len(times) >= iters // 2:
                return sum(times) / len(times) / 1e3
        elif by_name:
            longest = max(by_name.values(), key=sum)
            if len(longest) % iters == 0:
                return sum(map(sum, by_name.values())) / 1e3 / iters
        print(f"[kernels] the profiler traced {sum(map(len, by_name.values()))} kernels "
              f"(match {match!r}) for {iters} calls (attempt {attempt + 1})", flush=True)
    raise RuntimeError(f"chip_smoke check failed: no whole trace of {match!r} "
                       f"in {attempts} attempts")


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b: int, h: int, l: int, d: int):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * 2 + b * h * l * 4  # q, k, v, O bf16; lse f32
    return _bound(flops, nbytes)


def attention_bwd_bound(b: int, h: int, l: int, d: int):
    """The TPU backward kernel's work: five L x L x Dh products (S, dP, dq,
    dk, dv); q, k, v, O, dO read and dq, dk, dv written in bf16, lse f32."""
    return _bound(10.0 * b * h * l * l * d, 16.0 * b * h * l * d + 4.0 * b * h * l)


def dropout_bound(numel: int):
    """Bytes only: bf16 in, bf16 out, one mask byte."""
    return _bound(0.0, 5.0 * numel)


def _rel_err(x, ref) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30)).item()


def _fwd_inputs(device, b: int, h: int, l: int, d: int, inputs: str, seed: int):
    """q, k, v (B, H, L, Dh) bf16: contiguous, or views of one (B, L, 3, H,
    Dh) buffer as the model's qkv projection gives them."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    if inputs == "qkv":
        qkv = torch.randn((b, l, 3, h, d), generator=g, device=device).to(torch.bfloat16)
        return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(torch.randn((b, h, l, d), generator=g, device=device).to(torch.bfloat16)
                 for _ in range(3))


def kernel_phase(device, shapes, iters: int = 20) -> list:
    """Hold the attention forward against its plain version at ``shapes``.
    Per shape: the route ``fwd_route`` gives; the wrapper's time (CUDA
    events around back-to-back calls, host cost included) and the kernel's
    device time (``torch.profiler``, per launch); at a wgmma head dim the
    mma.sync design's times too ("prev"), in turns new, prev, prev, new."""
    import torch
    import torch.nn.functional as F

    from instageo_tpu_torch.ops import attention as tattn

    on_card = device.type == "cuda"
    results = []
    for i, (b, h, l, d, layout, inputs) in enumerate(shapes):
        q, k, v = _fwd_inputs(device, b, h, l, d, inputs, seed=i)
        route = tattn.fwd_route(d)
        launched, mma0 = tattn.launches.count, tattn.fwd_mma_launches.count
        o, lse = tattn.flash_attention_fwd(q, k, v, layout)
        launches = tattn.launches.count - launched
        mma_launches = tattn.fwd_mma_launches.count - mma0
        o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, layout)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        what = (b, h, l, d, layout, inputs)
        check(torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL),
              f"O off the plain version at {what}: max {err}")
        check(lse_err <= LSE_TOL, f"lse off by {lse_err} at {what}")
        if on_card:
            check(launches == 1 and mma_launches == (route == "mma_sync"),
                  f"{launches} launches, {mma_launches} on mma.sync, at {what} ({route})")
        new = lambda: tattn.flash_attention_fwd(q, k, v, layout)  # noqa: E731
        row = dict(shape=[b, h, l, d], layout=layout, inputs=inputs, route=route,
                   max_abs_err=err, lse_max_abs_err=lse_err, launches=launches)
        if route == "wgmma" and on_card:
            prev = lambda: tattn._flash_attention_fwd_cuda(q, k, v, layout, "mma_sync")  # noqa: E731
            o_prev, lse_prev = prev()
            row["prev_max_abs_err"] = (o_prev.float() - o_ref.float()).abs().max().item()
            check(torch.allclose(o_prev.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
                  and (lse_prev - lse_ref).abs().max().item() <= LSE_TOL,
                  f"the mma.sync design is off the plain version at {what}")
            del o_prev, lse_prev
            row.update(_in_turns(new, prev, device, iters,
                                 (FWD_KERNEL_SYMBOL["wgmma"], FWD_KERNEL_SYMBOL["mma_sync"])))
        else:
            row.update(ms=time_ms(new, device, iters),
                       device_ms=(device_ms(new, iters, match=FWD_KERNEL_SYMBOL[route])
                                  if on_card else None))
        row["plain_ms"] = time_ms(lambda: tattn.flash_attention_fwd_plain(q, k, v, layout),
                                  device, max(2, iters // 4))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        row["library_ms"] = time_ms(sdpa, device, iters)
        row["library_device_ms"] = device_ms(sdpa, iters) if on_card else None
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, l, d)
        print("[kernels] flash_attn_fwd " + json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, o, lse, o_ref, lse_ref
    if device.type == "cuda":
        refused = (
            (torch.zeros((1, 2, 33, 64), device=device), TypeError, "float32"),
            (torch.zeros((1, 2, 33, 72), device=device, dtype=torch.bfloat16),
             ValueError, "Dh=72"),
        )
        for x, exc, what in refused:
            o = torch.zeros((1, 33, 2 * x.shape[-1]), device=device, dtype=x.dtype)
            lse = torch.zeros((1, 2, 33, 1), device=device)
            for call in (lambda: tattn.flash_attention_fwd(x, x, x),
                         lambda: tattn.flash_attention_bwd(x, x, x, o, o, lse, "merged")):
                try:
                    call()
                except exc:
                    continue
                raise RuntimeError(f"an attention kernel wrapper took a {what} input")
        print("[kernels] float32 and Dh=72 inputs on the card raise, forward and "
              "backward", flush=True)
    return results


def _in_turns(new, prev, device, iters: int, symbols=(None, None)) -> dict:
    """A kernel (``new``) and its earlier design (``prev``) timed in turns
    (new, prev, prev, new): wrapper ms by CUDA events and device ms per call
    by ``torch.profiler`` (of the kernel named by ``symbols``' entry, else
    of every kernel a call launches), each turn and the means."""
    turns = {"new": [], "prev": []}
    for name in ("new", "prev", "prev", "new"):
        fn = new if name == "new" else prev
        symbol = symbols[0] if name == "new" else symbols[1]
        turns[name].append((time_ms(fn, device, iters), device_ms(fn, iters, match=symbol)))
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(ms=mean([t[0] for t in turns["new"]]),
                device_ms=mean([t[1] for t in turns["new"]]),
                prev_ms=mean([t[0] for t in turns["prev"]]),
                prev_device_ms=mean([t[1] for t in turns["prev"]]), turns=turns)


def bwd_kernel_phase(device, shapes, iters: int = 10) -> list:
    """Hold the backward kernels against their plain version at ``shapes``,
    on the forward kernel's O and lse and a random dO. Per shape: the route
    ``bwd_route`` gives; dq, dk and dv bit for bit equal between two calls,
    and on the card in a CUDA graph's replay; at a wgmma head dim the
    mma.sync design ("prev") checked too and timed in turns with the wgmma
    kernels (new, prev, prev, new), by wrapper ms and by device ms per call
    (all three launches summed); SDPA's backward on its own forward, by
    wrapper ms and device ms."""
    import torch
    import torch.nn.functional as F

    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.ops import attention as tattn

    on_card = device.type == "cuda"
    results = []
    for i, (b, h, l, d, entry) in enumerate(shapes):
        layout = "heads_first" if entry == "heads_first" else "merged"
        what = (b, h, l, d, entry)
        route = tattn.bwd_route(d)
        g = torch.Generator(device=device).manual_seed(100 + i)
        q, k, v = (torch.randn((b, h, l, d), generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = tattn.flash_attention_fwd(q, k, v, layout)
        do = torch.randn(o.shape, generator=g, device=device).to(torch.bfloat16)
        launched, mma0 = tattn.bwd_launches.count, tattn.bwd_mma_launches.count
        grads = tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)
        launches = tattn.bwd_launches.count - launched
        mma_launches = tattn.bwd_mma_launches.count - mma0
        refs = tattn.flash_attention_bwd_plain(q, k, v, o, do, lse, layout)
        rel = {f"d{n}": _rel_err(x, r) for n, x, r in zip("qkv", grads, refs)}
        err = max((x.float() - r.float()).abs().max().item() for x, r in zip(grads, refs))
        check(all(bool(torch.isfinite(x).all()) for x in grads),
              f"non-finite gradients at {what}")
        check(max(rel.values()) <= BWD_REL_TOL,
              f"backward off the plain version at {what}: {rel}")
        if on_card:
            check(launches == 1 and mma_launches == (route == "mma_sync"),
                  f"{launches} backward launches, {mma_launches} on mma.sync, at {what} ({route})")
        again = tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)
        row = dict(shape=[b, h, l, d], entry=entry, route=route, rel_err=rel, max_abs_err=err,
                   launches=launches,
                   same_bits=[bool(torch.equal(x, y)) for x, y in zip(grads, again)])
        if on_card:
            graph = _build.CapturedGraph(
                lambda: tattn.flash_attention_bwd(q, k, v, o, do, lse, layout))
            graph.replay()
            row["same_bits"] += [bool(torch.equal(x, y)) for x, y in zip(grads, graph.outputs)]
            del graph
        check(all(row["same_bits"]), f"dq, dk, dv of two calls (and of a graph replay) equal "
              f"{row['same_bits']} at {what} ({route})")
        del again
        if route == "wgmma" and on_card:
            prev = tattn._flash_attention_bwd_cuda(q, k, v, o, do, lse, layout, "mma_sync")
            row["prev_rel_err"] = {f"d{n}": _rel_err(x, r) for n, x, r in zip("qkv", prev, refs)}
            row["prev_max_abs_err"] = max((x.float() - r.float()).abs().max().item()
                                          for x, r in zip(prev, refs))
            check(max(row["prev_rel_err"].values()) <= BWD_REL_TOL,
                  f"the mma.sync backward is off the plain version at {what}")
            del prev
        del grads, refs
        if entry == "bloq":
            # The q-blocked entry end to end: autograd through both kernels
            # against autograd through both plain versions.
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            tattn.flash_attention_bloq(*leaves).backward(do)
            plain = [t.detach().requires_grad_() for t in (q, k, v)]
            tattn.flash_attention_bloq(*plain, impl="plain").backward(do)
            rel.update({f"entry_d{n}": _rel_err(a.grad, p.grad)
                        for n, a, p in zip("qkv", leaves, plain)})
            check(max(rel.values()) <= BWD_REL_TOL,
                  f"flash_attention_bloq gradients off the plain entry: {rel}")
            del leaves, plain
        new = lambda: tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)  # noqa: E731
        if route == "wgmma" and on_card:
            row.update(_in_turns(new, lambda: tattn._flash_attention_bwd_cuda(
                q, k, v, o, do, lse, layout, "mma_sync"), device, iters))
        else:
            row.update(ms=time_ms(new, device, iters),
                       device_ms=device_ms(new, iters) if on_card else None)
        row["plain_ms"] = time_ms(
            lambda: tattn.flash_attention_bwd_plain(q, k, v, o, do, lse, layout), device,
            max(2, iters // 4))
        # Yardstick: SDPA's backward alone, on one SDPA forward.
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        do_hf = (do.view(b, l, h, d).permute(0, 2, 1, 3).contiguous()
                 if layout == "merged" else do)
        sdpa_bwd = lambda: torch.autograd.grad(out, (qs, ks, vs), do_hf, retain_graph=True)  # noqa: E731
        row["library_ms"] = time_ms(sdpa_bwd, device, iters)
        row["library_device_ms"] = device_ms(sdpa_bwd, iters) if on_card else None
        row["bound_ms"], row["bound_by"] = attention_bwd_bound(b, h, l, d)
        print("[kernels] flash_attn_bwd " + json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, o, lse, do, qs, ks, vs, out, do_hf
        if on_card:
            torch.cuda.empty_cache()
    return results


def deterministic_bwd_phase(device, shape=(8, 12, 589, 64)) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)`` the backward keeps
    its default route (the wgmma kernels at Dh 64), none on mma.sync: two
    calls give the same dq, dk and dv bit for bit."""
    import torch

    from instageo_tpu_torch.ops import attention as tattn

    b, h, l, d = shape
    g = torch.Generator(device=device).manual_seed(300)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    o, lse = tattn.flash_attention_fwd(q, k, v, "merged")
    do = torch.randn(o.shape, generator=g, device=device).to(torch.bfloat16)
    torch.use_deterministic_algorithms(True)
    try:
        route = tattn.bwd_route(d)
        all0, mma0 = tattn.bwd_launches.count, tattn.bwd_mma_launches.count
        first = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        second = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        launched = tattn.bwd_launches.count - all0
        mma = tattn.bwd_mma_launches.count - mma0
    finally:
        torch.use_deterministic_algorithms(False)
    equal = [bool(torch.equal(a, c)) for a, c in zip(first, second)]
    check(route == "wgmma" and mma == 0 and (launched == 2 or device.type != "cuda"),
          f"deterministic mode: route {route}, {launched} launches, {mma} on mma.sync")
    check(all(equal), f"deterministic backward differs between two calls: dq/dk/dv equal {equal}")
    print(f"[kernels] deterministic mode at {shape}: bwd_route {route}, {launched} calls on it, "
          f"{mma} on mma.sync, dq, dk, dv bit-equal between them", flush=True)
    return dict(shape=list(shape), route=route, launches=launched, mma_launches=mma,
                equal=equal)


def dropout_phase(device, shapes, p: float = 0.1, iters: int = 20) -> list:
    """Hold the dropout kernel's mask to the plain Philox stream and its
    output to ``dropout_apply`` on that mask, bit for bit, at ``shapes``,
    with the seed by value and from device memory; check its keep rate,
    streams and backward. Times the kernel, by wrapper ms and device ms,
    beside ``F.dropout``; and the kernel with the seed from device memory
    ("seed_ptr") in turns with it by value."""
    import torch
    import torch.nn.functional as F

    from instageo_tpu_torch.ops import dropout as tdrop

    on_card = device.type == "cuda"
    results = []
    for i, shape in enumerate(shapes):
        g = torch.Generator(device=device).manual_seed(200 + i)
        x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
        n = x.numel()
        launched = tdrop.launches.count
        out, mask = tdrop.fused_dropout_fwd(x, p, seed=i)
        launches = tdrop.launches.count - launched
        check(out.dtype == x.dtype and mask.dtype == torch.bool, "dropout output types")
        _, plain_mask = tdrop.fused_dropout_seeded_plain(x, p, seed=i)
        check(torch.equal(mask, plain_mask),
              f"dropout mask is not the plain Philox stream at {shape}: "
              f"{(mask != plain_mask).sum().item()} of {n} differ")
        check(torch.equal(out, tdrop.dropout_apply(x, mask, p)),
              f"dropout output is not x·1/(1-p) on its mask at {shape}")
        del plain_mask
        if on_card:
            check(launches == 1, f"{launches} dropout launches at {shape}")
        keep = {}
        for rate in (0.1, 0.5):
            _, m = tdrop.fused_dropout_fwd(x, rate, seed=i)
            keep[rate] = m.float().mean().item()
            sigma = (rate * (1 - rate) / n) ** 0.5
            check(abs(keep[rate] - (1 - rate)) <= KEEP_SIGMAS * sigma,
                  f"keep fraction {keep[rate]} at p={rate}, {shape}")
        same = tdrop.fused_dropout_fwd(x, p, seed=i)[1]
        other = tdrop.fused_dropout_fwd(x, p, seed=i + 1000)[1]
        check(torch.equal(same, mask) and not torch.equal(other, mask),
              "one mask per seed, another for another seed")
        # The seed read from device memory (the captured training step's
        # route): the same 64 bits, the same mask and output.
        seeds = torch.tensor([7, i, 2**63 - 5], dtype=torch.int64, device=device)
        held = lambda: tdrop.fused_dropout_fwd(x, p, (seeds, 1))  # noqa: E731
        held_out, held_mask = held()
        check(torch.equal(held_mask, mask) and torch.equal(held_out, out),
              f"the seed from device memory gives another mask than by value at {shape}")
        del held_out, held_mask
        # An element offset (a data-parallel rank's first row): the mask is
        # the stream from that element, by value and from device memory,
        # on whole 8-element units and element by element.
        for offset in (n // shape[0] * (shape[0] // 2), 12345, (1 << 40) + 3):
            ref = tdrop.philox_bits(n, i, device, start=offset).reshape(shape) >= \
                tdrop.threshold(p)
            for seed in (i, (seeds, 1)):
                off_out, off_mask = tdrop.fused_dropout_fwd(x, p, seed, offset)
                check(torch.equal(off_mask, ref) and torch.equal(
                    off_out, tdrop.dropout_apply(x, ref, p)),
                    f"dropout at element offset {offset} is not philox_bits(start={offset}) "
                    f"at {shape}: {(off_mask != ref).sum().item()} of {n} differ")
            del ref, off_out, off_mask
        out0, mask0 = tdrop.fused_dropout_fwd(x, 0.0, seed=i)
        check(bool(mask0.all()) and torch.equal(out0, x), "p = 0 keeps everything")
        xr = x.detach().requires_grad_()
        grad = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
        tdrop.fused_dropout(xr, p, seed=i).backward(grad)
        check(torch.equal(xr.grad, tdrop.dropout_apply(grad, mask, p)),
              "dropout backward is where(mask, g/(1-p), 0)")
        del xr, grad, out0, mask0, same, other
        new = lambda: tdrop.fused_dropout_fwd(x, p, seed=i)  # noqa: E731
        row = dict(shape=list(shape), keep={str(k): v for k, v in keep.items()},
                   max_abs_err=0.0, launches=launches)
        if on_card:
            row.update(ms=time_ms(new, device, iters),
                       device_ms=device_ms(new, iters, match=DROPOUT_SYMBOL))
            ptr = _in_turns(held, new, device, iters, (DROPOUT_SYMBOL, DROPOUT_SYMBOL))
            row.update(seed_ptr_ms=ptr["ms"], seed_ptr_device_ms=ptr["device_ms"],
                       seed_value_turns_ms=ptr["prev_ms"],
                       seed_value_turns_device_ms=ptr["prev_device_ms"])
        else:
            row.update(ms=time_ms(new, device, iters), device_ms=None)
        row["plain_ms"] = time_ms(lambda: tdrop.fused_dropout_seeded_plain(x, p, i), device,
                                  max(2, iters // 4))
        library = lambda: F.dropout(x, p, training=True)  # noqa: E731
        row["library_ms"] = time_ms(library, device, iters)
        row["library_device_ms"] = device_ms(library, iters) if on_card else None
        row["bound_ms"], row["bound_by"] = dropout_bound(n)
        print("[kernels] fused_dropout " + json.dumps(row), flush=True)
        results.append(row)
        del x, out, mask
    if on_card:
        x = torch.zeros((3, 5), device=device)
        for rate, dtype, exc in ((1.0, torch.bfloat16, ValueError),
                                 (0.1, torch.float16, TypeError)):
            try:
                tdrop.fused_dropout_fwd(x.to(dtype), rate, seed=0)
            except exc:
                continue
            raise RuntimeError(f"the dropout wrapper took rate {rate} in {dtype}")
        print("[kernels] a dropout rate of 1.0 and a float16 input on the card raise",
              flush=True)
    return results


def _counters() -> dict:
    from instageo_tpu_torch.ops import attention as tattn
    from instageo_tpu_torch.ops import dropout as tdrop

    return {"flash_attn_fwd": tattn.launches, "flash_attn_fwd_mma": tattn.fwd_mma_launches,
            "flash_attn_bwd": tattn.bwd_launches, "flash_attn_bwd_mma": tattn.bwd_mma_launches,
            "fused_dropout": tdrop.launches}


def reset_counts() -> None:
    from instageo_tpu_torch import native
    from instageo_tpu_torch.models import prithvi
    from instageo_tpu_torch.ops import _build

    for counter in (*_counters().values(), _build.graph_replays, native.decodes,
                    native.fallback_decodes, prithvi.xla_attn_calls):
        counter.reset()


def read_counts() -> dict:
    """Each kernel's launches on the device since the reset: made directly
    (``count``) plus those that graph replays made (``replayed``: the
    launches each graph recorded at its capture, once per replay)."""
    return {name: counter.total() for name, counter in _counters().items()}


def read_graph_counts() -> dict:
    """What CUDA graphs did since the reset: their replays, and per kernel
    the launches recorded at capture and those that replays made."""
    from instageo_tpu_torch.ops import _build

    return {"graph_replays": _build.graph_replays.count,
            "captured": {n: c.captured for n, c in _counters().items()},
            "replayed": {n: c.replayed for n, c in _counters().items()}}


def _write_chips(root: str, n: int, raw: np.ndarray) -> list:
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    paths = []
    for i in range(n):
        path = os.path.join(root, f"tile_{i:03d}_chip.tif")
        transform = Affine.from_origin(300000.0 + 6720.0 * i, 4500000.0, 30.0, 30.0)
        write_geotiff(path, raw[i % len(raw)], transform=transform, crs=32615)
        paths.append(path)
    return paths


def crop_setup():
    """The crop config from the port's config file: the config, the model's
    keyword arguments, the train phase's trainer config, and the
    dataloader's mean, std and bands."""
    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.train.factory import model_channels

    cfg = load_config(CROP_CONFIG, overrides={"model.load_pretrained_weights": False})
    model_kw = dict(variant=str(cfg.model.model_name), num_classes=int(cfg.model.num_classes),
                    temporal_step=int(cfg.dataloader.temporal_dim),
                    image_size=int(cfg.dataloader.img_size), num_bands=model_channels(cfg))
    train_cfg = {
        "train": {"learning_rate": cfg.train.learning_rate,
                  "weight_decay": cfg.train.weight_decay,
                  "batch_size": cfg.train.batch_size, "num_epochs": 1,
                  "class_weights": list(cfg.train.class_weights),
                  "ignore_index": cfg.train.ignore_index, "scheduler": cfg.train.scheduler},
        "model": {"num_classes": cfg.model.num_classes,
                  "freeze_backbone": cfg.model.freeze_backbone,
                  "weight_clip_range": cfg.model.weight_clip_range},
    }
    data = dict(mean=list(cfg.dataloader.mean), std=list(cfg.dataloader.std),
                bands=list(cfg.dataloader.bands))
    return cfg, model_kw, train_cfg, data


def _normalise(raw: np.ndarray, temporal_step: int, data: dict) -> np.ndarray:
    """Host normalisation of one raw chip (T·C, H, W) -> (C, T, H, W)."""
    c = len(data["mean"])
    x = raw.astype(np.float32).reshape(temporal_step, c, *raw.shape[-2:])
    mean = np.asarray(data["mean"], np.float32)[None, :, None, None]
    std = np.asarray(data["std"], np.float32)[None, :, None, None]
    return ((x - mean) / std).transpose(1, 0, 2, 3)


def _describe_gap(gap: dict) -> str:
    return (f"max |logit diff| {gap['max_abs_diff']:.6g} (<= {LOGIT_TOL} x max |logit| "
            f"{gap['scale']:.6g}); argmax agreement {gap['agreement']:.6f} of all pixels, "
            f"{gap['agreement_decided']:.6f} (>= {ARGMAX_AGREEMENT}) of the "
            f"{gap['decided']:.4f} whose top-2 gap >= {DECIDED_GAP} x max |logit|")


@contextlib.contextmanager
def plain_attention(model):
    """``model``'s encoder blocks on the plain attention inside the block."""
    blocks = model.prithvi_encoder.blocks
    try:
        for blk in blocks:
            blk.attn.attn_impl = "plain"
        yield
    finally:
        for blk in blocks:
            blk.attn.attn_impl = "kernel"


def kernel_vs_plain_logits(model, x, **coords) -> dict:
    """The model's float32 NHWC logits on ``x`` with the attention kernel
    and with its plain version: max |diff| within LOGIT_TOL of max |logit|,
    argmax agreement at least ARGMAX_AGREEMENT on the pixels whose top-2
    gap is at least DECIDED_GAP of max |logit|. Returns the statistics and
    the kernel's logits."""
    import torch

    with torch.inference_mode():
        logits_k = model(x, channels_last=True, **coords).float()
        with plain_attention(model):
            logits_p = model(x, channels_last=True, **coords).float()
    check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
    same = logits_k.argmax(-1) == logits_p.argmax(-1)
    diff = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    top2 = logits_p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * scale
    agree_decided = same[decided].float().mean().item()
    check(diff <= LOGIT_TOL * scale, f"kernel/plain logits differ by {diff} of {scale}")
    check(agree_decided >= ARGMAX_AGREEMENT,
          f"kernel/plain argmax agreement {agree_decided} on decided pixels")
    return dict(max_abs_diff=diff, scale=scale, agreement=same.float().mean().item(),
                agreement_decided=agree_decided, decided=decided.float().mean().item(),
                logits=logits_k)


def kernel_vs_plain_features(model, x, **coords) -> dict:
    """The encoder's float32 feature map on ``x`` with the attention kernel
    and with its plain version: ‖Δ‖ within FEATURE_REL_TOL of ‖plain
    features‖. Returns the statistics and the kernel's features."""
    import torch

    with torch.inference_mode():
        feats_k = model(x, return_features=True, **coords)[1]
        with plain_attention(model):
            feats_p = model(x, return_features=True, **coords)[1]
    diff = feats_k - feats_p
    stats = dict(rel=(diff.norm() / feats_p.norm()).item(), max_abs_diff=diff.abs().max().item(),
                 scale=feats_p.abs().max().item())
    print(f"[features] kernel vs plain encoder features: ‖Δ‖/‖f‖ {stats['rel']:.6g} "
          f"(<= {FEATURE_REL_TOL}), max |Δ| {stats['max_abs_diff']:.6g} of max |f| "
          f"{stats['scale']:.6g}", flush=True)
    check(bool(torch.isfinite(feats_k).all()), "non-finite features")
    check(stats["rel"] <= FEATURE_REL_TOL,
          f"kernel/plain features differ by {stats['rel']} of their norm")
    return dict(stats, features=feats_k)


def slice_phase(device, cfg, model_kw: dict, data: dict, n_requests: int = 24,
                n_threads: int = 8, n_files: int = 32, batch: int = 16,
                throughput_batches=(16, 64), throughput_iters: int = 5) -> dict:
    """Serve the model of ``cfg`` (random weights from seed 0, bf16):
    online requests + a batch run over chip files."""
    import torch

    from instageo_tpu_torch.ops import attention as tattn
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.serve.server import ModelServer

    t_build = time.perf_counter()
    server = ModelServer(cfg, device=device)
    t_build = time.perf_counter() - t_build
    model = server.model
    check(model.dtype == torch.bfloat16, f"the served model computes in {model.dtype}")
    depth = len(model.prithvi_encoder.blocks)
    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    pre = {k: v for k, v in server.preprocess.items() if k not in ("mean", "std")}
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 10000, (8, 6 * t, size, size), dtype=np.uint16)
    tmp = tempfile.TemporaryDirectory()
    try:
        paths = _write_chips(tmp.name, n_files, raw)
        out_dir = os.path.join(tmp.name, "predictions")
        chips = [_normalise(raw[i % len(raw)], t, data) for i in range(n_requests)]

        # --- the serving path: counts from 0, read right after ----------
        reset_counts()
        batcher = server.online_batcher(max_batch=batch)
        answers = [None] * n_requests

        def client(worker: int) -> None:
            for i in range(worker, n_requests, n_threads):
                answers[i] = batcher.submit(chips[i]).result(timeout=600)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(w,)) for w in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        online_s = time.perf_counter() - t0
        check(not any(th.is_alive() for th in threads), "an online client hung")
        run = server.chip_inference_from_paths(paths, out_dir, batch_size=batch)
        launches = tattn.launches.count
        others = read_counts()
        forwards = batcher.batches_run + math.ceil(n_files / batch)
        health = server.health_check()
        # ------------------------------------------------------------------

        check(all(a is not None for a in answers), "an online request got no answer")
        for a in answers:
            check(a.shape == (size, size) and a.dtype == np.int8, f"answer {a.shape} {a.dtype}")
            check(int(a.min()) >= 0 and int(a.max()) < classes, "class out of range")
        check(run["num_chips"] == n_files, f"batch run served {run['num_chips']} chips")
        written = sorted(os.listdir(out_dir))
        check(len(written) == n_files, f"{len(written)} prediction files of {n_files}")
        for name in written:
            with GeoTiffReader(os.path.join(out_dir, name)) as r:
                pred = r.read()
            check(pred.shape == (1, size, size) and pred.dtype == np.int8,
                  f"{name}: {pred.shape} {pred.dtype}")
            check(int(pred.min()) >= 0 and int(pred.max()) < classes, f"{name}: class range")
        check(launches == depth * forwards,
              f"{launches} kernel launches for {forwards} forwards of {depth} blocks")
        check(others["flash_attn_bwd"] == 0 and others["fused_dropout"] == 0,
              f"serving launched training kernels: {others}")
        check(others["flash_attn_fwd_mma"] == 0,
              f"serving took the mma.sync forward: {others}")
        print(f"[slice] served {n_requests} online requests from {n_threads} threads in "
              f"{batcher.batches_run} batches ({online_s:.3f} s) and {n_files} chip files "
              f"({run['chips_per_sec']:.2f} chips/s incl. decode+write); "
              f"{launches} attention launches = {depth} x {forwards} forwards, "
              f"{others['flash_attn_fwd_mma']} of them on mma.sync; "
              f"health {json.dumps(health['device'])}", flush=True)
        server.close()

        # --- kernel vs plain attention on one batch -----------------------
        x = torch.from_numpy(np.stack(chips[:4])).to(device)
        gap = kernel_vs_plain_logits(model, x)
        diff, agree = gap["max_abs_diff"], gap["agreement"]
        print(f"[slice] kernel vs plain attention, batch 4: {_describe_gap(gap)}", flush=True)

        # --- throughput: raw uint16 chips in host memory -> int8 classes in
        # host memory, through the fused predict (host clock, synchronised
        # by the copy back) -----------------------------------------------
        predict = make_fused_predict_fn(model, data["mean"], data["std"], **pre)
        rates = {}
        for b in throughput_batches:
            batch_raw = raw[np.arange(b) % len(raw)]
            for _ in range(2):
                predict(batch_raw).cpu()
            t0 = time.perf_counter()
            for _ in range(throughput_iters):
                predict(batch_raw).cpu()
            ms = (time.perf_counter() - t0) * 1e3 / throughput_iters
            rates[b] = b * 1e3 / ms
            print(f"[slice] fused predict batch {b}: {ms:.3f} ms per call, "
                  f"{rates[b]:.2f} chips/s", flush=True)
    finally:
        server.close()
        tmp.cleanup()
    return dict(launches=launches, other_launches=others, forwards=forwards, agreement=agree,
                max_logit_diff=diff, chips_per_s=rates, build_s=t_build)


def _crop_batch(n: int, temporal_step: int, size: int, classes: int, seed: int, data: dict):
    """Synthetic crop chips: uint16 raw bands normalised on the host, and
    labels constant over 16-px patches in [0, classes) with a band of -1
    (ignored) rows at the top."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 10000, (n, 6 * temporal_step, size, size), dtype=np.uint16)
    x = np.stack([_normalise(r, temporal_step, data) for r in raw])
    patches = rng.integers(0, classes, (n, size // 16, size // 16))
    y = np.repeat(np.repeat(patches, 16, axis=1), 16, axis=2).astype(np.int64)
    y[:, :8] = -1
    return x, y


def attention_fwd_plain_f32p(q, k, v, layout: str = "merged"):
    """The plain attention forward with P left in float32 for the PV
    product, a rounding point the TPU kernel places otherwise: the gradient
    yardstick of ``kernel_vs_plain_step``."""
    import torch

    b, h, l, d = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, v.float()) / denom).to(q.dtype)
    if layout == "merged":
        out = out.permute(0, 2, 1, 3).reshape(b, l, h * d)
    return out, m + torch.log(denom)


def kernel_vs_plain_step(device, model, model_kw: dict, cfg: dict, xb, yb, tag: str,
                         **model_extra):
    """One train step (dropout off) from ``model``'s state with the kernels,
    with the plain versions, and with the plain versions but P in float32
    (``attention_fwd_plain_f32p``): the loss within TRAIN_LOSS_REL_TOL, the
    BatchNorm statistics within TRAIN_BN_REL_TOL, and each gradient's gap to
    the plain step within TRAIN_GRAD_REL_TOL or GRAD_YARDSTICK_FACTOR times
    the float32-P step's gap. ``model`` is left in the state and dropout
    rate it came with. ``model_extra``: the model's other
    ``create_prithvi_seg`` arguments (its head). Returns the loss gap and
    the three worst gradients as (name, gap, the float32-P step's gap)."""
    import torch

    from instageo_tpu_torch.models.seg import (
        Dropout,
        UpscalingBlock,
        create_prithvi_seg,
        train_mode,
    )
    from instageo_tpu_torch.ops import attention as tattn
    from instageo_tpu_torch.train.trainer import Trainer

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rates = {m: m.p for m in model.modules() if isinstance(m, Dropout)}
    plain = create_prithvi_seg(**model_kw, **model_extra, dtype=torch.bfloat16,
                               param_dtype=torch.float32, attn_impl="plain",
                               dropout_impl="plain", device=device, seed=0)
    step = {}
    try:
        for name, m, fwd_plain in (("kernel", model, tattn.flash_attention_fwd_plain),
                                   ("plain", plain, tattn.flash_attention_fwd_plain),
                                   ("plain f32 P", plain, attention_fwd_plain_f32p)):
            m.load_state_dict(state)
            train_mode(m, torch.Generator(), dropout_rate=0.0)
            with mock.patch.object(tattn, "flash_attention_fwd_plain", fwd_plain):
                loss = float(Trainer(cfg, m, device=device).train_step(xb, yb,
                                                                       torch.Generator()))
            step[name] = (loss, {n: p.grad.float().clone() for n, p in m.named_parameters()},
                          {n: b.clone() for n, b in m.named_buffers() if "running" in n})
    finally:
        model.load_state_dict(state)
        for m, p in rates.items():
            m.p = p
    (loss_k, grads_k, bn_k), (loss_p, grads_p, bn_p) = step["kernel"], step["plain"]
    grads_y = step["plain f32 P"][1]
    # The bias of a conv that feeds a BatchNorm has an exact gradient of 0
    # (BatchNorm subtracts each channel's batch mean), so both versions give
    # rounding noise there: it is held against its conv weight's gradient.
    scale_of = {f"{name}.2.bias": f"{name}.2.weight" for name, mod in model.named_modules()
                if isinstance(mod, UpscalingBlock)}

    def rel(grads):
        return {n: ((grads[n] - grads_p[n]).norm()
                    / grads_p[scale_of.get(n, n)].norm().clamp_min(1e-30)).item()
                for n in grads_p}

    grad_rel, yard_rel = rel(grads_k), rel(grads_y)
    limit = {n: max(TRAIN_GRAD_REL_TOL, GRAD_YARDSTICK_FACTOR * yard_rel[n]) for n in grad_rel}
    over = {n: (v, limit[n]) for n, v in grad_rel.items() if v > limit[n]}
    bn_rel = {n: _rel_err(bn_k[n], bn_p[n]) for n in bn_p}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = [(n, v, yard_rel[n])
             for n, v in sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]]
    print(f"[{tag}] kernel vs plain step (dropout off): loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.3g} <= {TRAIN_LOSS_REL_TOL}); gradient rel err max "
          f"{worst[0][1]:.4g}, median {float(np.median(list(grad_rel.values()))):.4g} over "
          f"{len(grad_rel)} params (each <= {TRAIN_GRAD_REL_TOL} or {GRAD_YARDSTICK_FACTOR} x "
          f"the float32-P step's gap; the {len(scale_of)} conv biases ahead of BatchNorm "
          f"against their weight's gradient; worst "
          f"{json.dumps(worst)} as [name, kernel, float32 P]); "
          f"float32-P step's gap max {max(yard_rel.values()):.4g}, median "
          f"{float(np.median(list(yard_rel.values()))):.4g}; BN running stats rel err max "
          f"{max(bn_rel.values()):.4g} (<= {TRAIN_BN_REL_TOL})", flush=True)
    check(loss_rel <= TRAIN_LOSS_REL_TOL, f"kernel/plain loss {loss_k} vs {loss_p}")
    check(not over, f"kernel/plain gradients differ (gap, limit): {over}")
    check(max(bn_rel.values()) <= TRAIN_BN_REL_TOL, f"BN running stats differ: {bn_rel}")
    return loss_rel, worst


def train_phase(device, model_kw: dict, cfg: dict, data: dict, fixed_steps: int = 10,
                throughput_batches=(8, 32), throughput_steps: int = 6) -> dict:
    """Train the crop model through ``Trainer`` and check what each part
    gives (see the module docstring, phase 5)."""
    import torch

    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.train.trainer import Trainer

    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    batch = cfg["train"]["batch_size"]
    model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                               device=device, seed=0)
    depth = len(model.prithvi_encoder.blocks)
    trainer = Trainer(cfg, model, device=device)
    x, y = _crop_batch(max(throughput_batches + (3 * batch,)), t, size, classes, seed=1,
                       data=data)
    xb, yb = trainer.prepare_batch(x[:batch], y[:batch], batch)
    gen = torch.Generator().manual_seed(0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # --- the training path: counts from 0, read right after -------------
    reset_counts()
    losses = [trainer.train_step(xb, yb, gen) for _ in range(fixed_steps)]
    counts = read_counts()
    # ----------------------------------------------------------------------
    losses = [float(loss) for loss in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else 0.0
    check(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    per_step = {name: n / fixed_steps for name, n in counts.items()}
    expected = {"flash_attn_fwd": depth, "flash_attn_fwd_mma": 0, "flash_attn_bwd": depth,
                "flash_attn_bwd_mma": 0, "fused_dropout": 5}
    if device.type == "cuda":
        check(per_step == expected, f"launches per step {per_step}, expected {expected}")
    print(f"[train] {fixed_steps} steps at batch {batch} on one batch: losses "
          f"{json.dumps([round(v, 6) for v in losses])}; launches per step {json.dumps(per_step)}; "
          f"peak {peak_gb:.2f} GiB", flush=True)

    # --- one step with the kernels vs one with the plain versions ---------
    loss_rel, worst = kernel_vs_plain_step(device, model, model_kw, cfg, xb, yb, "train")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- loops: a train epoch with a partial last batch, an eval epoch ---
    batches = [(x[i:i + batch], y[i:i + batch]) for i in (0, batch)]
    tail = slice(2 * batch, 2 * batch + max(1, batch - 3))
    batches.append((x[tail], y[tail]))
    train_m = trainer.run_train_epoch(iter(batches), gen, batch)
    val_m = trainer.run_eval_epoch(iter(batches), batch)
    keys = ["train_loss", "val_loss", "val_IoU", "val_Acc"] + [
        f"val_IoU_{c}" for c in range(classes)]
    metrics = {**train_m, **val_m}
    check(all(k in metrics and math.isfinite(metrics[k]) for k in keys),
          f"missing or non-finite epoch metrics: { {k: metrics.get(k) for k in keys} }")
    print(f"[train] epoch over {len(batches)} batches (last of {len(batches[-1][0])}, "
          f"padded): train_loss {metrics['train_loss']:.6f}; eval: val_loss "
          f"{metrics['val_loss']:.6f}, val_IoU {metrics['val_IoU']:.6f}, val_Acc "
          f"{metrics['val_Acc']:.6f}", flush=True)

    # --- throughput: host batches -> one optimizer step each (host clock,
    # synchronised by reading the epoch's loss) --------------------------
    rates = {}
    for b in throughput_batches:
        host = [(x[:b], y[:b])] * throughput_steps
        trainer.run_train_epoch(iter(host[:2]), gen, b)
        t0 = time.perf_counter()
        trainer.run_train_epoch(iter(host), gen, b)
        ms = (time.perf_counter() - t0) * 1e3 / throughput_steps
        rates[b] = dict(ms_per_step=ms, chips_per_s=b * 1e3 / ms)
        print(f"[train] batch {b}: {ms:.3f} ms per step, {b * 1e3 / ms:.2f} chips/s",
              flush=True)
    return dict(losses=losses, launches=counts, launches_per_step=per_step,
                grad_rel_max=worst[0][1], loss_rel=loss_rel, rates=rates, peak_gb=peak_gb)


def _first_difference(a: dict, b: dict):
    """Where two training runs part: None when their losses and parameters
    are equal bit for bit, else the first step whose loss differs and the
    parameters that differ."""
    import torch

    steps = [i for i, (x, y) in enumerate(zip(a["losses"], b["losses"])) if x != y]
    params = [n for n, p in a["params"].items() if not torch.equal(p, b["params"][n])]
    if not steps and not params:
        return None
    return (f"first differing loss at step {steps[0] + 1 if steps else None} of "
            f"{len(a['losses'])}; {len(params)} of {len(a['params'])} parameters differ, "
            f"first {params[:3]}")


def graph_phase(device, model_kw: dict, cfg: dict, data: dict, n_batches: int = 24,
                rate_batches=(8, 32), rate_steps: int = 16) -> dict:
    """``tpu.steps_per_call: auto`` (k = 8 at batch 8) against the one-step
    loop on the crop model: the same weights, batches and seeds through
    ``Trainer.run_train_epoch``, each run twice, all four equal bit for bit;
    once more under deterministic mode; one group from a saved state,
    replayed twice and as plain steps, bit for bit; the attention captured
    alone; the launches per step through the replays; a dropout-only graph
    replayed with two seeds; ms per train step (batch 8 and 32) and per eval
    batch (8) in turns; the grouped eval epoch against the eager one."""
    import warnings

    import torch

    from instageo_tpu_torch.models.seg import SeedSlots, create_prithvi_seg
    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.ops import attention as tattn
    from instageo_tpu_torch.ops import dropout as tdrop
    from instageo_tpu_torch.train.trainer import Trainer, epoch_generator

    on_card = device.type == "cuda"
    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    batch = cfg["train"]["batch_size"]
    model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                               device=device, seed=0)
    depth = len(model.prithvi_encoder.blocks)
    init = {n: v.detach().clone() for n, v in model.state_dict().items()}
    x, y = _crop_batch(max(2 * batch, max(rate_batches)), t, size, classes, seed=4, data=data)
    rng = np.random.default_rng(5)
    picks = [rng.choice(len(x), batch, replace=False) for _ in range(n_batches)]

    def batches(ixs=picks):
        for ix in ixs:
            yield x[ix], y[ix]

    def trainer_for(steps_per_call):
        return Trainer({**cfg, "tpu": {"steps_per_call": steps_per_call}}, model, device=device)

    def run(steps_per_call):
        model.load_state_dict(init)
        trainer = trainer_for(steps_per_call)
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        metrics = trainer.run_train_epoch(batches(), epoch_generator(SEED, 0), batch, losses)
        wall = time.perf_counter() - t0
        out = dict(k=trainer.steps_per_call, steps=trainer.step, wall_s=wall,
                   counts=read_counts(), graphs=read_graph_counts(),
                   losses=[float(v) for v in losses], train_loss=metrics["train_loss"],
                   params={n: p.detach().clone() for n, p in model.named_parameters()})
        del trainer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return out

    def four_runs():
        """Eager, captured, captured, eager: each run's launches per step
        (every attention launch on the wgmma route)."""
        expected = {"flash_attn_fwd": depth, "flash_attn_fwd_mma": 0, "flash_attn_bwd": depth,
                    "flash_attn_bwd_mma": 0, "fused_dropout": 5}
        runs = {}
        for name, spc in (("eager", 1), ("captured", "auto"), ("captured_2", "auto"),
                          ("eager_2", 1)):
            runs[name] = r = run(spc)
            per_step = {n: c / r["steps"] for n, c in r["counts"].items()}
            print(f"[graph] {name}: k={r['k']}, {r['steps']} steps in "
                  f"{r['wall_s']:.3f} s, launches per step {json.dumps(per_step)}, graph "
                  f"replays {r['graphs']['graph_replays']}, captured "
                  f"{json.dumps(r['graphs']['captured'])}", flush=True)
            check(r["steps"] == n_batches and all(math.isfinite(v) for v in r["losses"]),
                  f"{name}: {r['steps']} steps, losses {r['losses']}")
            if on_card:
                check(per_step == expected,
                      f"{name}: launches per step {per_step}, expected {expected}")
        if on_card:
            cap = runs["captured"]
            k = cap["k"]
            check(k == 8, f"steps_per_call auto gave k={k} at batch {batch}, expected 8")
            check(cap["graphs"]["graph_replays"] == n_batches // k - 1
                  and cap["graphs"]["captured"] == {n: c * k for n, c in expected.items()},
                  f"graph counts {cap['graphs']}: expected {n_batches // k - 1} "
                  f"replays of {k} captured steps")
        return runs

    pairs = (("captured", "eager"), ("captured_2", "eager_2"), ("eager_2", "eager"),
             ("captured_2", "captured"))
    clock = Clock("graph")
    # --- captured = eager and each run = its rerun, bit for bit: launches,
    # losses and every parameter after n_batches AdamW steps ----------------
    runs = four_runs()
    parted = {f"{a}/{b}": _first_difference(runs[a], runs[b]) for a, b in pairs}
    print(f"[graph] {n_batches} steps, captured vs eager and run vs rerun: "
          f"{json.dumps({p: d or 'bit-equal' for p, d in parted.items()})}", flush=True)
    # Checked at the end of the script, so that a failure here still leaves
    # the later phases' numbers.
    checks = [(not any(parted.values()), f"captured vs eager or run vs rerun differ: {parted}")]
    for r in runs.values():
        r.pop("params")
    clock.lap("four runs")

    # --- deterministic mode: captured vs eager bit for bit -----------------
    det = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name, spc in (("eager", 1), ("captured", "auto")):
                det[name] = run(spc)
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).splitlines()[0][:200] for w in caught
                  if "deterministic" in str(w.message)})
    det_parted = _first_difference(det["captured"], det["eager"])
    det_per_step = {n: c / det["captured"]["steps"] for n, c in det["captured"]["counts"].items()}
    print(f"[graph] deterministic mode: captured vs eager "
          f"{det_parted or 'bit-equal (losses and every parameter)'}; launches per step "
          f"{json.dumps(det_per_step)}; ops without a deterministic CUDA version in the "
          f"step: {json.dumps(ops) if ops else 'none'}", flush=True)
    if on_card:
        check(det_per_step["flash_attn_bwd"] == depth and det_per_step["flash_attn_bwd_mma"] == 0,
              f"deterministic mode: backward launches per step {det_per_step}")
    check(det_parted is None, f"captured vs eager differ under deterministic mode: "
          f"{det_parted} (ops that warned: {ops or 'none'})")
    for r in det.values():
        r.pop("params")
    clock.lap("deterministic runs")

    # --- one group from a saved state: plain steps, then replayed twice -----
    model.load_state_dict(init)
    trainer = trainer_for("auto")
    k = trainer.steps_per_call
    gen = epoch_generator(SEED, 0)
    trainer.run_train_epoch(batches(picks[:k]), gen, batch)  # plain steps, then the capture
    saved_model = {n: v.clone() for n, v in model.state_dict().items()}
    optimizer = trainer.optimizer
    saved_opt = [(v, v.clone()) for st in optimizer.state.values() for v in st.values()
                 if torch.is_tensor(v)]
    saved_opt += [(g["lr"], g["lr"].clone()) for g in optimizer.param_groups
                  if torch.is_tensor(g["lr"])]
    saved_gen, saved_step = gen.get_state(), trainer.step

    def from_saved(steps_per_call):
        """The next k batches from the saved state, restored in place (the
        graph holds these tensors)."""
        model.load_state_dict(saved_model)
        for live, saved in saved_opt:
            live.copy_(saved)
        gen.set_state(saved_gen)
        trainer.step, trainer.steps_per_call = saved_step, steps_per_call
        losses = []
        trainer.run_train_epoch(batches(picks[k:2 * k]), gen, batch, losses)
        return dict(losses=[float(v) for v in losses],
                    params={n: p.detach().clone() for n, p in model.named_parameters()})

    reset_counts()
    window = {}
    for name, spc in (("eager", 1), ("captured", k), ("captured_2", k)):
        window[name] = from_saved(spc)
    window_replays = read_graph_counts()["graph_replays"]
    del trainer, optimizer, saved_opt, saved_model
    window_parted = {f"{a}/eager": _first_difference(window[a], window["eager"])
                     for a in ("captured", "captured_2")}
    print(f"[graph] steps {k + 1}..{2 * k} from the state after step {k} (plain steps, then 2 "
          f"graph replays; {window_replays} replays counted): "
          f"{json.dumps({p: d or 'bit-equal' for p, d in window_parted.items()})}", flush=True)
    checks.append((not any(window_parted.values()),
                   f"captured vs eager from one state differ: {window_parted}"))
    if on_card:
        checks.append((window_replays == 2, f"{window_replays} replays from the saved state"))
    del window
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("one group from a saved state")

    # --- the attention alone, forward and backward captured at the step's
    # shape: O, dq, dk, dv = eager bit for bit ---------------------------------
    if on_card:
        arch = model.arch
        pt, ph, pw = arch.patch_size
        heads = arch.num_heads
        shape = (batch, heads, (arch.num_frames // pt) * (size // ph) * (size // pw) + 1,
                 arch.embed_dim // heads)
        g = torch.Generator(device=device).manual_seed(301)
        q, kk, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
                    .requires_grad_() for _ in range(3))
        do = torch.randn((shape[0], shape[2], arch.embed_dim), generator=g,
                         device=device).to(torch.bfloat16)

        def fwd_bwd():
            o = tattn.flash_attention_blo(q, kk, v)
            return (o.detach(),) + torch.autograd.grad(o, (q, kk, v), do)

        eager_out = fwd_bwd()
        graph = _build.CapturedGraph(fwd_bwd)
        attn = []
        for _ in range(2):
            graph.replay()
            o, dq, dk, dv = graph.outputs
            attn.append({n: bool(torch.equal(x, e))
                         for n, x, e in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), eager_out)})
        held = {("forward" if c is tattn.launches else "backward"): n
                for c, n in graph.launches.items()}
        print(f"[graph] attention forward + backward captured alone at {shape} (the "
              f"{tattn.bwd_route(shape[-1])} backward), two replays vs eager: "
              f"{json.dumps(attn)}; launches held {json.dumps(held)}", flush=True)
        check(graph.launches == {tattn.launches: 1, tattn.bwd_launches: 1},
              f"the attention graph holds {graph.launches}")
        check(all(all(r.values()) for r in attn), f"captured attention differs from eager: {attn}")
        del graph, eager_out, q, kk, v, do
    clock.lap("attention graph")

    # --- a dropout-only graph: one mask per replayed seed --------------------
    xd = torch.randn(DROPOUT_SHAPES[-1], device=device).to(torch.bfloat16)
    slots = SeedSlots(1, device)
    masks = {}
    if on_card:
        graph = _build.CapturedGraph(lambda: tdrop.fused_dropout_fwd(xd, 0.1, slots.take()))
        for seed in (11, 2**62 + 3):
            slots.buffer.fill_(seed)
            graph.replay()
            mask = graph.outputs[1].clone()
            plain = tdrop.fused_dropout_seeded_plain(xd, 0.1, seed)[1]
            masks[seed] = bool(torch.equal(mask, plain))
            masks.setdefault("masks", []).append(mask)
        two = masks.pop("masks")
        check(all(masks.values()) and not torch.equal(*two),
              f"dropout graph replays: equal to the plain stream {masks}, two masks differ "
              f"{not torch.equal(*two)}")
        check(graph.launches == {tdrop.launches: 1}, "the dropout graph holds one launch")
        print(f"[graph] a dropout graph of {DROPOUT_SHAPES[-1]} replayed with seeds {list(masks)}: "
              "each mask = the plain Philox stream of its seed, the two differ", flush=True)
        del graph, two
    del xd
    clock.lap("dropout graph")

    # --- the grouped eval epoch against the eager one ------------------------
    evals, eval_trainers = {}, {}
    for name, spc in (("eager", 1), ("captured", "auto")):
        trainer = eval_trainers[name] = trainer_for(spc)
        reset_counts()
        evals[name] = {step: trainer.run_eval_epoch(batches(), batch, step)
                       for step in ("val", "test")}
        evals[name]["counts"] = read_counts()
        evals[name]["replays"] = read_graph_counts()["graph_replays"]
    keys = [k for k in evals["eager"]["val"] if not k.startswith("val_IoU_")
            and not k.startswith("val_F1_")]
    eval_gap = max(abs(evals["captured"][st][k.replace("val", st)]
                       - evals["eager"][st][k.replace("val", st)])
                   for st in ("val", "test") for k in keys)
    auc_gap = abs(evals["captured"]["test"]["test_roc_auc"] - evals["eager"]["test"]["test_roc_auc"])
    print(f"[graph] eval epochs of {n_batches} batches, captured vs eager: largest metric gap "
          f"{eval_gap:.3g}, roc_auc {auc_gap:.3g} (<= {GRAPH_EVAL_TOL}); val_loss "
          f"{evals['captured']['val']['val_loss']:.6f}; graph replays "
          f"{evals['captured']['replays']}; launches {json.dumps(evals['captured']['counts'])}",
          flush=True)
    check(max(eval_gap, auc_gap) <= GRAPH_EVAL_TOL, f"captured eval differs by {eval_gap}")
    if on_card:
        check(evals["captured"]["counts"]["flash_attn_fwd"] == 2 * depth * n_batches,
              f"eval launches {evals['captured']['counts']}")
    # ms per eval batch, eager vs captured, in turns (host clock, synchronised
    # by the epoch's metrics; both graphs of the val epoch are captured).
    eval_turns = {"eager": [], "captured": []}
    for name in ("eager", "captured", "captured", "eager"):
        t0 = time.perf_counter()
        eval_trainers[name].run_eval_epoch(batches(), batch, "val")
        eval_turns[name].append((time.perf_counter() - t0) * 1e3 / n_batches)
    eval_ms = {n: sum(v) / len(v) for n, v in eval_turns.items()}
    print(f"[graph] eval at batch {batch}: {eval_ms['eager']:.3f} ms per batch eager, "
          f"{eval_ms['captured']:.3f} captured; turns {json.dumps(eval_turns)}", flush=True)
    del eval_trainers, trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    clock.lap("eval epochs")

    # --- ms per step, eager vs captured, in turns (host clock, synchronised
    # by the epoch's metrics) -----------------------------------------------
    rates = {}
    for b in rate_batches:
        host = [(x[:b], y[:b])] * rate_steps
        trainers = {"eager": trainer_for(1), "captured": trainer_for("auto")}
        gen = torch.Generator().manual_seed(0)
        for tr in trainers.values():
            tr.run_train_epoch(iter(host[:8]), gen, b)  # warm-up; captures the graph
        turns = {"eager": [], "captured": []}
        for name in ("eager", "captured", "captured", "eager"):
            t0 = time.perf_counter()
            trainers[name].run_train_epoch(iter(host), gen, b)
            turns[name].append((time.perf_counter() - t0) * 1e3 / rate_steps)
        rates[b] = {n: sum(v) / len(v) for n, v in turns.items()}
        rates[b]["turns"] = turns
        rates[b]["k"] = trainers["captured"].steps_per_call
        print(f"[graph] batch {b}: {rates[b]['eager']:.3f} ms per step eager, "
              f"{rates[b]['captured']:.3f} captured (k={rates[b]['k']}); turns "
              f"{json.dumps(turns)}", flush=True)
        del trainers
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        clock.lap(f"rates at batch {b}")
    del model
    return dict(runs=runs, parted=parted, deterministic=det, deterministic_ops=ops,
                window=window_parted, eval_gap=eval_gap, eval_ms=eval_ms, rates=rates,
                launches=runs["captured"]["counts"], graphs=runs["captured"]["graphs"],
                checks=checks)


def _write_dataset(root: str, n_train: int, n_val: int, n_bands: int, size: int,
                   classes: int, n_test: int = 0) -> list:
    """Synthetic uint16 chips of ``n_bands`` bands and int16 label rasters
    (labels 0..classes, constant over 16-px patches; signed, since
    ``reduce_to_zero`` maps 0 to the ignored -1) with train.csv, val.csv and,
    for ``n_test`` chips more, test.csv (columns Input, Label; paths
    relative to ``root``). Returns the val chips' paths."""
    import csv

    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    rng = np.random.default_rng(2)
    rows = []
    for i in range(n_train + n_val + n_test):
        raw = rng.integers(1, 10000, (n_bands, size, size), dtype=np.uint16)
        patches = rng.integers(0, classes + 1, (-(-size // 16), -(-size // 16)))
        label = np.repeat(np.repeat(patches, 16, axis=0), 16, axis=1)[:size, :size]
        transform = Affine.from_origin(300000.0 + 30.0 * size * i, 4500000.0, 30.0, 30.0)
        write_geotiff(os.path.join(root, f"tile_{i:03d}_chip.tif"), raw, transform=transform,
                      crs=32615)
        write_geotiff(os.path.join(root, f"tile_{i:03d}_label.tif"),
                      label[None].astype(np.int16), transform=transform, crs=32615)
        rows.append({"Input": f"tile_{i:03d}_chip.tif", "Label": f"tile_{i:03d}_label.tif"})
    parts = [("train.csv", rows[:n_train]), ("val.csv", rows[n_train:n_train + n_val])]
    if n_test:
        parts.append(("test.csv", rows[n_train + n_val:]))
    for name, part in parts:
        with open(os.path.join(root, name), "w", newline="") as f:
            writer = csv.DictWriter(f, ["Input", "Label"])
            writer.writeheader()
            writer.writerows(part)
    return [os.path.join(root, r["Input"]) for r in rows[n_train:n_train + n_val]]


def loader_phase(device, model_kw: dict, data: dict, n_chips: int = 128, batch: int = 64,
                 n_cache: int = 64, extra=()) -> dict:
    """The host path that feeds the card, on full-size synthetic chips (18
    uint16 bands, 224 px): the native decoder against the Python codec bit
    for bit (deflate on noise; LZW, striped and tiled with the predictor, on
    16-px patches);
    ``chip_inference_from_paths`` at batch 64 with each decoder, in turns;
    a loader epoch without the decoded-chip cache, with it cold and warm;
    the time to a loader's first batch with a worker thread and a worker
    process, one each; on the card, an epoch of spawned workers dropped
    after its first batch in a child process, beside the codec check.
    ``extra``: config overrides (a CPU rehearsal's image size)."""
    import torch

    from instageo_tpu_torch import native
    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.data.dataloader import create_dataloader
    from instageo_tpu_torch.data.geotiff import GeoTiffReader, write_geotiff
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.serve.infer import chip_inference_from_paths
    from instageo_tpu_torch.train import run

    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    n_bands = 6 * t
    out: dict = {"native": native.available(), "reason": native.unavailable_reason}
    clock = Clock("loader")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    early = None
    try:
        data_root = os.path.join(root, "dataset")
        os.makedirs(data_root)
        _write_dataset(data_root, n_cache, 0, n_bands, size, classes)
        clock.lap(f"writing {n_cache} chips and labels")
        base = [f"--config-name={CROP_CONFIG}", f"root_dir={data_root}", *extra]
        if device.type != "cuda":
            base.append("device=cpu")
        # An epoch of spawned workers dropped after its first batch: the
        # workers must end cleanly (they aborted at exit while their queues
        # still moved tensors into shared memory). It runs beside the codec
        # check and the chip writes, which time nothing.
        code = ("import sys\n"
                "from instageo_tpu_torch.configs.config import load_config_from_argv\n"
                "from instageo_tpu_torch.data.dataloader import create_dataloader\n"
                "from instageo_tpu_torch.train import run\n"
                "cfg = load_config_from_argv(sys.argv[2:])\n"
                "ds = run._make_dataset(sys.argv[1], cfg, run._train_preprocess(cfg, False))\n"
                "loader = create_dataloader(ds, 8, num_workers=2, worker_mode='process',\n"
                "                           device='cuda')\n"
                "batches = iter(loader)\n"
                "next(batches)\n"
                "del batches, loader\n")
        if device.type == "cuda":
            early = (subprocess.Popen(
                [sys.executable, "-c", code, f"{data_root}/train.csv", *base],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), time.perf_counter())
        rng = np.random.default_rng(6)
        if out["native"]:
            same = {}
            noise = rng.integers(0, 10000, (n_bands, size, size), dtype=np.uint16)
            # LZW chips constant over 16-px patches: the Python codec's LZW
            # takes minutes on a full-size chip of noise.
            patches = np.repeat(np.repeat(rng.integers(
                0, 10000, (n_bands, -(-size // 16), -(-size // 16)), dtype=np.uint16), 16, 1),
                16, 2)[:, :size, :size]
            for name, raw, kw in (
                    ("deflate", noise, dict(compress="deflate")),
                    ("lzw", patches, dict(compress="lzw")),
                    ("lzw_tiled_predictor", patches,
                     dict(compress="lzw", tiled=True, tile_size=64, predictor=True))):
                path = os.path.join(root, f"codec_{name}.tif")
                write_geotiff(path, raw, **kw)
                with GeoTiffReader(path) as r:
                    python_codec = r.read()
                decoded = native.read_geotiff_native(path)
                same[name] = bool(np.array_equal(decoded, python_codec)
                                  and np.array_equal(decoded, raw))
            check(all(same.values()), f"native decoder vs the Python codec: {same}")
            print(f"[loader] native decoder = Python codec bit for bit on {n_bands}-band {size} "
                  f"px uint16 chips: {json.dumps(same)}", flush=True)
            out["bit_equal"] = same
        else:
            print(f"[loader] the native decoder is unavailable here: {out['reason']}", flush=True)

        clock.lap("codec check")

        # --- batch jobs over chip files: native vs Python decode, in turns ---
        raw = rng.integers(0, 10000, (8, n_bands, size, size), dtype=np.uint16)
        paths = _write_chips(root, n_chips, raw)
        clock.lap(f"writing {n_chips} chips")
        if early is not None:
            proc, t0 = early
            _, err = proc.communicate(timeout=600)
            check(proc.returncode == 0 and "terminate called" not in err,
                  f"a dropped process-mode epoch: exit {proc.returncode}\n{err[-3000:]}")
            print(f"[loader] a process-mode epoch (2 workers) dropped after its first batch "
                  f"ended cleanly: exit {proc.returncode} in {time.perf_counter() - t0:.2f} s "
                  "(beside the codec check and the chip writes)", flush=True)
            clock.lap("early drop")
        model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, device=device, seed=0)
        kw = dict(temporal_size=t, bands=data["bands"][:n_bands], constant_multiplier=1.0,
                  batch_size=batch, img_size=size)
        chip_inference_from_paths(paths[:batch], os.path.join(root, "warm"), model,
                                  data["mean"], data["std"], **kw)
        turns = {True: [], False: []}
        decodes = {}
        for use_native in (True, False, False, True):
            reset_counts()
            # The Python codec's turns: the native decoder made unavailable.
            with mock.patch.object(native, "available", lambda: use_native and out["native"]):
                n, dt = chip_inference_from_paths(
                    paths, os.path.join(root, f"pred_{use_native}"), model, data["mean"],
                    data["std"], **kw)
            check(n == n_chips, f"batch job served {n} chips")
            turns[use_native].append(n / dt)
            decodes[use_native] = (native.decodes.count, native.fallback_decodes.count)
        rates = {("native" if k else "python"): sum(v) / len(v) for k, v in turns.items()}
        if out["native"]:
            check(decodes[True] == (n_chips, 0) and decodes[False] == (0, n_chips),
                  f"files decoded (native, Python codec): {decodes}")
        print(f"[loader] chip_inference_from_paths, {n_chips} chips at batch {batch}: "
              f"{rates['native']:.2f} chips/s with the native decoder, {rates['python']:.2f} "
              f"with the Python codec (turns {json.dumps({str(k): v for k, v in turns.items()})}; "
              f"native decodes {decodes[True][0]})", flush=True)
        out["batch_job_chips_per_s"], out["batch_job_turns"] = rates, turns
        del model
        clock.lap("batch jobs")

        # --- a loader epoch through the decoded-chip cache ------------------
        epochs, walls = {}, {}
        for name, cache in (("uncached", None), ("cache_cold", "cache"), ("cache_warm", "cache")):
            cfg = load_config_from_argv(
                base + ([f"dataloader.cache_dir={data_root}/{cache}"] if cache else []))
            t0 = time.perf_counter()
            ds = run._make_dataset(f"{data_root}/train.csv", cfg,
                                   run._train_preprocess(cfg, augment=False), seed=SEED)
            loader = create_dataloader(ds, 8, num_workers=int(cfg.dataloader.num_workers),
                                       device=device)
            epochs[name] = [tuple(a.clone() for a in b) for b in loader]
            walls[name] = time.perf_counter() - t0
            del loader, ds
        for name in ("cache_cold", "cache_warm"):
            check(all(torch.equal(a, b) for ba, bb in zip(epochs["uncached"], epochs[name])
                      for a, b in zip(ba, bb)) and len(epochs[name]) == len(epochs["uncached"]),
                  f"{name} batches differ from the uncached epoch")
        cache_rates = {n: n_cache / w for n, w in walls.items()}
        print(f"[loader] {n_cache} chips, QA scan + one epoch (config's workers, thread mode): "
              + ", ".join(f"{n} {cache_rates[n]:.2f} chips/s ({walls[n]:.3f} s)" for n in walls)
              + "; cold and warm batches = uncached", flush=True)
        out["cache_chips_per_s"], out["cache_wall_s"] = cache_rates, walls
        del epochs
        clock.lap("cache epochs")

        # --- time to the first batch: a worker thread vs a worker process,
        # over one batch of chips, so that each epoch runs to its end ------
        cfg = load_config_from_argv(base)
        with open(f"{data_root}/train.csv") as f:
            first_rows = f.read().splitlines()[:9]
        with open(f"{data_root}/first.csv", "w") as f:
            f.write("\n".join(first_rows) + "\n")
        ds = run._make_dataset(f"{data_root}/first.csv", cfg,
                               run._train_preprocess(cfg, augment=False), seed=SEED)
        first = {"thread": [], "process": []}
        for mode in ("thread", "process"):
            t0 = time.perf_counter()
            loader = create_dataloader(ds, 8, num_workers=1, worker_mode=mode, device=device)
            batches = iter(loader)
            batch = next(batches)
            first[mode].append(time.perf_counter() - t0)
            check(next(batches, None) is None, "the first-batch loader holds one batch")
            check(device.type != "cuda" or all(t.is_pinned() for t in batch
                                               if isinstance(t, torch.Tensor)),
                  f"the {mode} loader's batch is not in pinned memory")
            del batches, loader
        out["first_batch_s"] = {m: sum(v) / len(v) for m, v in first.items()}
        print(f"[loader] first batch (8 chips) with one worker: thread "
              f"{out['first_batch_s']['thread']:.3f} s, process "
              f"{out['first_batch_s']['process']:.3f} s (turns {json.dumps(first)})", flush=True)
        clock.lap("first batches")

    finally:
        if early is not None and early[0].poll() is None:
            early[0].kill()
            early[0].communicate()
        tmp.cleanup()
    return out


def run_phase(device, extra=(), n_train: int = 128, n_val: int = 16) -> dict:
    """The run CLI (``instageo_tpu_torch.train.run.main``, in-process) on
    the crop config over synthetic chip CSVs, as a user runs it (a worker
    thread, the decoded-chip cache, ``steps_per_call: auto``, so ``train``
    replays a graph of 8 steps): ``stats``, ``train`` (one epoch), ``eval``
    on the best checkpoint, ``chip_inference``; each mode with the launch
    counts set to 0 just before it and read just after, replays included.
    Checks the loss, the launches of each mode, eval against the saved
    epoch's validation metrics, and the CLI's predictions against
    ``ModelServer.chip_inference_from_paths`` on the same checkpoint.
    ``extra``: more overrides (a tiny model for a CPU rehearsal)."""
    import torch

    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.models.registry import get_arch
    from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device
    from instageo_tpu_torch.serve.server import ModelServer
    from instageo_tpu_torch.train import run

    on_card = device.type == "cuda"
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    base = [f"--config-name={CROP_CONFIG}", f"root_dir={root}",
            f"train_filepath={root}/train.csv", f"valid_filepath={root}/val.csv",
            f"test_filepath={root}/val.csv", f"run_dir={root}/run",
            f"dataloader.cache_dir={root}/cache",
            "model.load_pretrained_weights=False", "train.num_epochs=1", *extra]
    if not on_card:
        base.append("device=cpu")
    cfg = load_config_from_argv(base)
    dl = cfg.dataloader
    size, t, classes = int(dl.img_size), int(dl.temporal_dim), int(cfg.model.num_classes)
    batch = int(cfg.train.batch_size)
    depth = get_arch(str(cfg.model.model_name), depth=int(cfg.model.depth)).depth
    try:
        t0 = time.perf_counter()
        val_paths = _write_dataset(root, n_train, n_val, len(dl.bands), size, classes)
        print(f"[run] wrote {n_train} + {n_val} chips of {len(dl.bands)} bands, {size} px "
              f"with labels 0..{classes} in {time.perf_counter() - t0:.2f} s", flush=True)
        out, counts, graphs, wall = {}, {}, {}, {}
        ckpt = os.path.join(root, "run", "instageo_best_checkpoint")
        for mode, more in (("stats", []), ("train", []),
                           ("eval", [f"checkpoint_path={ckpt}"]),
                           ("chip_inference", [f"checkpoint_path={ckpt}"])):
            # --- one mode of the CLI: counts from 0, read right after ----
            reset_counts()
            t0 = time.perf_counter()
            out[mode] = run.main(base + [f"mode={mode}"] + more)
            if on_card:
                torch.cuda.synchronize()
            wall[mode] = time.perf_counter() - t0
            counts[mode], graphs[mode] = read_counts(), read_graph_counts()
            # ---------------------------------------------------------------
            chips = n_train if mode in ("stats", "train") else n_val
            print(f"[run] mode={mode}: {chips} chips in {wall[mode]:.3f} s wall "
                  f"({chips / wall[mode]:.2f} chips/s; with spawned workers over 48 train / "
                  f"16 val chips: {SPAWNED_RUN_WALL_S[mode]} s); launches "
                  f"{json.dumps(counts[mode])}, graph replays "
                  f"{graphs[mode]['graph_replays']}", flush=True)

        stats = out["stats"]
        check(len(stats["mean"]) == len(dl.mean) and len(stats["class_weights"]) <= classes,
              f"stats: {stats}")
        hist = out["train"]
        check(math.isfinite(hist["train_loss"]) and math.isfinite(hist["val_loss"]),
              f"train: non-finite losses {hist}")
        print(f"[run] mode=train: train_loss {hist['train_loss']:.6f}, val_loss "
              f"{hist['val_loss']:.6f}; the epoch (train + validation) took "
              f"{hist['epoch_time_s']:.3f} s of the mode's {wall['train']:.3f} s wall", flush=True)
        steps, val_batches = -(-n_train // batch), -(-n_val // batch)
        expected = {
            "train": {"flash_attn_fwd": depth * (steps + val_batches), "flash_attn_fwd_mma": 0,
                      "flash_attn_bwd": depth * steps, "flash_attn_bwd_mma": 0,
                      "fused_dropout": 5 * steps},
            "eval": {"flash_attn_fwd": depth * val_batches, "flash_attn_fwd_mma": 0,
                     "flash_attn_bwd": 0, "flash_attn_bwd_mma": 0, "fused_dropout": 0},
        }
        expected["chip_inference"] = expected["eval"]
        if on_card:
            for mode, want in expected.items():
                check(counts[mode] == want, f"mode={mode}: launches {counts[mode]}, "
                      f"expected {want}")
            groups = steps // 8  # steps_per_call auto: k = 8 at batch 8
            check(graphs["train"]["graph_replays"] == groups - 1,
                  f"mode=train: {graphs['train']['graph_replays']} graph replays for "
                  f"{groups} full groups of 8 steps")
        with open(ckpt + ".metrics.json") as f:
            saved = json.load(f)
        ev = out["eval"]
        eval_gap = {k: abs(ev[f"test_{k}"] - saved[f"val_{k}"]) for k in ("IoU", "loss")}
        check(max(eval_gap.values()) <= EVAL_TOL,
              f"eval on the checkpoint vs the saved epoch's validation: {eval_gap}")
        check(out["chip_inference"] == n_val, f"chip_inference served {out['chip_inference']}")
        written = sorted(os.listdir(os.path.join(root, "predictions")))
        check(len(written) == n_val, f"{len(written)} predictions for {n_val} chips")

        # --- where a mode's host time goes: the val loader's first batch and
        # whole pass, with the config's worker count and with none ---------
        from instageo_tpu_torch.data.dataloader import create_dataloader

        val_ds = run._make_dataset(f"{root}/val.csv", cfg, run._train_preprocess(cfg, False))
        loader_s = {}
        for workers in sorted({int(dl.num_workers), 0}, reverse=True):
            t0 = time.perf_counter()
            loader = create_dataloader(val_ds, batch, num_workers=workers, device=device)
            batches = iter(loader)
            next(batches)
            first = time.perf_counter() - t0
            for _ in batches:
                pass
            loader_s[workers] = (first, time.perf_counter() - t0)
            del batches, loader
        print(f"[run] val loader ({n_val} chips, decode + normalise): " + "; ".join(
            f"{w} workers: first batch {a:.3f} s, all {b:.3f} s" for w, (a, b) in loader_s.items()),
            flush=True)

        # --- the CLI's predictions vs the server's on the same checkpoint --
        server = ModelServer(load_config_from_argv(base + [f"checkpoint_path={ckpt}"]),
                             device=device)
        model = server.model
        pre = dict(temporal_size=t, bands=list(dl.bands),
                   constant_multiplier=float(dl.constant_multiplier), img_size=size)
        server_dir = os.path.join(root, "server_predictions")
        try:
            server.chip_inference_from_paths(val_paths, server_dir, batch_size=batch)
        finally:
            server.close()
        mean_t = torch.tensor(list(dl.mean), dtype=torch.float32, device=device)
        std_t = torch.tensor(list(dl.std), dtype=torch.float32, device=device)
        bands_t = torch.tensor(list(dl.bands), device=device)
        same_decided = decided_n = same_all = 0
        for i in range(0, n_val, batch):
            paths = val_paths[i:i + batch]
            raws, cli, srv = [], [], []
            for p in paths:
                name = os.path.basename(p).replace("chip", "prediction")
                for store, path in ((raws, p), (cli, os.path.join(root, "predictions", name)),
                                    (srv, os.path.join(server_dir, name))):
                    with GeoTiffReader(path) as r:
                        store.append(r.read())
            with torch.inference_mode():
                x = preprocess_chips(raw_to_device(np.stack(raws), device), mean_t, std_t,
                                     t, bands_t, pre["constant_multiplier"], img_size=size)
                logits = model(x, channels_last=True).float()
            top2 = logits.topk(2, dim=-1).values
            decided = ((top2[..., 0] - top2[..., 1])
                       >= DECIDED_GAP * logits.abs().max()).cpu().numpy()
            same = np.stack(cli)[:, 0] == np.stack(srv)[:, 0]
            same_decided += int(same[decided].sum())
            decided_n += int(decided.sum())
            same_all += int(same.sum())
        agree = same_decided / max(decided_n, 1)
        check(agree >= ARGMAX_AGREEMENT,
              f"CLI vs server predictions agree on {agree} of decided pixels")
        rates = {mode: (n_train if mode in ("stats", "train") else n_val) / wall[mode]
                 for mode in wall}
        print(f"[run] eval on the checkpoint: test_IoU {ev['test_IoU']:.6f} vs saved val_IoU "
              f"{saved['val_IoU']:.6f}, test_loss {ev['test_loss']:.6f} vs val_loss "
              f"{saved['val_loss']:.6f} (within {EVAL_TOL}); test_roc_auc "
              f"{ev['test_roc_auc']:.6f}; CLI vs ModelServer predictions: {agree:.6f} of "
              f"{decided_n} decided pixels agree (>= {ARGMAX_AGREEMENT}), "
              f"{same_all / (n_val * size * size):.6f} of all", flush=True)
        del model
        if on_card:
            torch.cuda.empty_cache()
        return dict(counts=counts, graphs=graphs, wall_s=wall, chips_per_s=rates,
                    eval_gap=eval_gap,
                    agreement=agree, train_loss=hist["train_loss"],
                    epoch_s=hist["epoch_time_s"], loader_s=loader_s)
    finally:
        tmp.cleanup()


def replica_phase(device, smi: str, extra=(), n_train: int = 128, n_val: int = 16,
                  n_test: int = 16) -> dict:
    """``mode=replica`` of the run CLI (``instageo_tpu_torch.train.run.main``,
    in-process) on the crop config at full width, as a user replicates:
    ``replica.require_pretrained=False`` (no pretrained file in the
    repository), one epoch, graphs of 8 steps, over the run phase's
    synthetic chips (``n_train`` train, ``n_val`` val, ``n_test`` test).
    Each stage (stats, train, eval on val, eval on test) runs with the
    launch counts set to 0 just before it and read just after, replays
    included. Checks that ``report.json`` and ``REPORT.md`` are written,
    that ``hardware`` names the card, each stage's launches (every
    attention launch on wgmma, 5 dropout launches per step, none on
    mma.sync), and that the test split's metrics equal a direct
    ``mode=eval`` on the best checkpoint (within EVAL_TOL).
    ``extra``: more overrides (a tiny model for a CPU rehearsal)."""
    import torch

    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.models.registry import get_arch
    from instageo_tpu_torch.train import replica, run

    on_card = device.type == "cuda"
    clock = Clock("replica")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    run_dir = os.path.join(root, "replica")
    base = [f"--config-name={CROP_CONFIG}", f"root_dir={root}",
            f"train_filepath={root}/train.csv", f"valid_filepath={root}/val.csv",
            f"test_filepath={root}/test.csv", f"run_dir={run_dir}",
            "model.load_pretrained_weights=False", "train.num_epochs=1",
            "replica.require_pretrained=False", *extra]
    if not on_card:
        base.append("device=cpu")
    cfg = load_config_from_argv(base)
    dl = cfg.dataloader
    size, classes = int(dl.img_size), int(cfg.model.num_classes)
    batch = int(cfg.train.batch_size)
    depth = get_arch(str(cfg.model.model_name), depth=int(cfg.model.depth)).depth
    try:
        _write_dataset(root, n_train, n_val, len(dl.bands), size, classes, n_test=n_test)
        clock.lap(f"wrote {n_train} + {n_val} + {n_test} chips")
        stages = {}
        cli = run.main

        def staged(argv):
            """One stage of the replica: counts from 0, read right after."""
            mode = next(a.split("=", 1)[1] for a in argv if a.startswith("mode="))
            if mode == "eval":
                mode = os.path.basename(
                    [a.split("=", 1)[1] for a in argv if a.startswith("run_dir=")][-1])
            reset_counts()
            t0 = time.perf_counter()
            result = cli(argv)
            if on_card:
                torch.cuda.synchronize()
            stages[mode] = dict(wall_s=time.perf_counter() - t0, counts=read_counts(),
                                graph_replays=read_graph_counts()["graph_replays"])
            return result

        t0 = time.perf_counter()
        with mock.patch.object(run, "main", staged):
            report = cli(base + ["mode=replica"])
        wall = time.perf_counter() - t0
        check(list(stages) == ["stats", "train", "eval_val", "eval_test"],
              f"replica stages {list(stages)}")
        for name in ("report.json", "REPORT.md"):
            check(os.path.getsize(os.path.join(run_dir, name)) > 0, f"replica wrote no {name}")
        with open(os.path.join(run_dir, "report.json")) as f:
            saved = json.load(f)
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        check(kind in saved["hardware"], f"report hardware {saved['hardware']!r}")
        with open(os.path.join(run_dir, "REPORT.md")) as f:
            check(kind in f.read(), "REPORT.md does not name the device")

        steps, val_batches = -(-n_train // batch), -(-n_val // batch)
        test_batches = -(-n_test // batch)
        none = {"flash_attn_fwd": 0, "flash_attn_fwd_mma": 0, "flash_attn_bwd": 0,
                "flash_attn_bwd_mma": 0, "fused_dropout": 0}
        expected = {
            "stats": none,
            "train": dict(none, flash_attn_fwd=depth * (steps + val_batches),
                          flash_attn_bwd=depth * steps, fused_dropout=5 * steps),
            "eval_val": dict(none, flash_attn_fwd=depth * val_batches),
            "eval_test": dict(none, flash_attn_fwd=depth * test_batches),
        }
        if on_card:
            for name, want in expected.items():
                check(stages[name]["counts"] == want,
                      f"replica {name}: launches {stages[name]['counts']}, expected {want}")
            check(stages["train"]["graph_replays"] == steps // 8 - 1,
                  f"replica train: {stages['train']['graph_replays']} graph replays")

        # --- the test split against a direct mode=eval of the checkpoint ----
        reset_counts()
        direct = cli(["--config-path", os.path.join(run_dir, ".hydra"), "--config-name",
                      "config", "mode=eval", f"checkpoint_path={report['checkpoint']}",
                      f"test_filepath={root}/test.csv", f"run_dir={root}/direct_eval"])
        gap = {col: abs(report["metrics"]["test"][col] / 100.0 - float(direct[key]))
               for col, key in replica._EVAL_KEYS.items()}
        check(max(gap.values()) <= EVAL_TOL,
              f"replica test metrics vs a direct mode=eval: {gap}")
        for name, st in stages.items():
            print(f"[replica] stage {name}: {st['wall_s']:.3f} s wall (report: "
                  f"{report['stages'].get(name + '_s', float('nan')):.3f} s); launches "
                  f"{json.dumps(st['counts'])}, graph replays {st['graph_replays']}", flush=True)
        print(f"[replica] {smi}: mode=replica {wall:.3f} s wall; hardware "
              f"{saved['hardware']!r}; test {json.dumps(report['metrics']['test'])}, val "
              f"{json.dumps(report['metrics']['val'])}; reference deltas "
              f"{json.dumps(report.get('deltas'))}; test vs a direct mode=eval: max gap "
              f"{max(gap.values()):.3g} (<= {EVAL_TOL})", flush=True)
        clock.lap("mode=replica")
        return dict(stages=stages, wall_s=wall, metrics=report["metrics"], eval_gap=gap,
                    hardware=saved["hardware"])
    finally:
        tmp.cleanup()


SERVE_TURNS = 3           # predict timings: turns of each model in alternation
ARTIFACT_AGREEMENT = 0.999  # artifact vs server class ids on decided pixels


def _serve_row(smi: str, **row) -> None:
    print("[serve_models] " + json.dumps({"card": smi, **row}), flush=True)


def _predict_turns(predicts: dict, raw, turns: int, iters: int) -> dict:
    """Host-clock ms per fused predict call of each named predict, the names
    taken in turns (raw uint16 chips in host memory to int8 classes in host
    memory): the mean and each turn's."""
    for fn in predicts.values():
        for _ in range(2):
            fn(raw).cpu()
    per_turn = {name: [] for name in predicts}
    for _ in range(turns):
        for name, fn in predicts.items():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(raw).cpu()
            per_turn[name].append((time.perf_counter() - t0) * 1e3 / iters)
    return {name: dict(ms=float(np.mean(v)), turns=[round(x, 3) for x in v])
            for name, v in per_turn.items()}


def _predict_launches(predict, raw, depth: int, tag: str, on_card: bool) -> dict:
    """Launch counts of one fused predict, from 0: on the card ``depth``
    forward launches, all on the wgmma route, nothing else."""
    reset_counts()
    predict(raw).cpu()
    counts = read_counts()
    want = {"flash_attn_fwd": depth, "flash_attn_fwd_mma": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_mma": 0, "fused_dropout": 0}
    if on_card:
        check(counts == want, f"{tag}: launches per predict {counts}, expected {want}")
    return counts


def _artifact_prepare(server, x, root: str, depth: int, on_card: bool,
                      batches=(64, 7)) -> dict:
    """``server``'s export artifact (``ModelServer.export_artifact``) written
    into ``root`` (its size under 4 bytes per parameter) with what a fresh
    interpreter needs to run it on the first ``b`` chips of ``x`` for each of
    ``batches``, and what it must give: the server's class ids and its
    decided pixels. Returns the job for ``_artifact_child`` and
    ``_artifact_verify``."""
    import torch

    from instageo_tpu_torch.serve.infer import make_predict_fn

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "predict.pt2")
    t0 = time.perf_counter()
    server.export_artifact(path)
    export_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in server.model.parameters())
    nbytes = os.path.getsize(path)
    check(nbytes < 4 * n_params, f"artifact {nbytes} bytes for {n_params} parameters")
    job = dict(path=path, state=os.path.join(root, "state.pt"), x=os.path.join(root, "x.pt"),
               out=os.path.join(root, "y"), want=os.path.join(root, "want"),
               decided=os.path.join(root, "decided.pt"), batches=list(batches), depth=depth,
               on_card=on_card, export_s=export_s, bytes=nbytes, params=n_params)
    torch.save(server.model.state_dict(), job["state"])
    torch.save(x.cpu(), job["x"])
    live = make_predict_fn(server.model)
    with torch.inference_mode():
        logits = server.model(x, channels_last=True).float()
    top2 = logits.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * logits.abs().max()).cpu()
    torch.save(decided, job["decided"])
    for b in batches:
        torch.save(live(x[:b]).cpu(), f"{job['want']}.{b}.pt")
    return job


def _artifact_child(jobs: list) -> dict:
    """What a fresh interpreter runs for ``_artifact_prepare``'s jobs: each
    artifact loaded with ``load_predict``, called on each batch (the
    forward launches of each call counted), the outputs saved; then which
    of the port's model modules the interpreter imported (none may be)."""
    import torch

    from instageo_tpu_torch.ops import attention
    from instageo_tpu_torch.serve.export import load_predict

    recs = []
    for job in jobs:
        t0 = time.perf_counter()
        predict, meta = load_predict(job["path"])
        state = torch.load(job["state"], weights_only=True)
        x = torch.load(job["x"], weights_only=True)
        launches = {}
        for b in job["batches"]:
            before = attention.launches.count
            y = predict(state, x[:b])
            launches[b] = attention.launches.count - before
            torch.save(y.cpu(), f"{job['out']}.{b}.pt")
        recs.append(dict(launches=launches, meta=meta, seconds=time.perf_counter() - t0))
    return dict(artifacts=recs, models_imported=[
        m for m in sys.modules if m.startswith("instageo_tpu_torch.models")])


def _artifact_fresh(jobs: list, root: str) -> dict:
    """``_artifact_child`` of ``jobs`` in a fresh interpreter of its own:
    its record, with the interpreter's wall seconds."""
    path = os.path.join(root, "artifact_jobs.json")
    with open(path, "w") as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys, chip_smoke; print(json.dumps("
         "chip_smoke._artifact_child(json.load(open(sys.argv[1])))))", path],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    check(proc.returncode == 0, f"the artifacts' interpreter failed:\n{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec


def _artifact_verify(job: dict, child: dict, models_imported: list) -> dict:
    """A job's artifact as the fresh interpreter ran it: no model module
    imported, class ids equal to the server's on decided pixels
    (>= ARTIFACT_AGREEMENT), ``depth`` forward launches per call on the
    card."""
    import torch

    check(not models_imported, f"load_predict imported {models_imported}")
    decided = torch.load(job["decided"], weights_only=True)
    agreement = {}
    for b in job["batches"]:
        got = torch.load(f"{job['out']}.{b}.pt", weights_only=True)
        same = got == torch.load(f"{job['want']}.{b}.pt", weights_only=True)
        agreement[b] = same[decided[:b]].float().mean().item()
        check(agreement[b] >= ARTIFACT_AGREEMENT,
              f"artifact vs server at batch {b}: {agreement[b]} of decided pixels")
        if job["on_card"]:
            check(child["launches"][str(b)] == job["depth"],
                  f"artifact at batch {b}: {child['launches'][str(b)]} forward launches")
    return dict(bytes=job["bytes"], params=job["params"], agreement=agreement,
                export_s=job["export_s"], fresh_interpreter_s=child["seconds"], child=child)


def serving_row(smi: str, row: dict, art: dict) -> dict:
    """The serve_models phase's serving-layer row, with its export artifact
    as a fresh interpreter ran it (``_artifact_verify``'s record)."""
    child = art["child"]
    _serve_row(smi, **row, artifact_bytes=art["bytes"], artifact_bound_bytes=4 * art["params"],
               export_s=art["export_s"], fresh_interpreter_s=art["fresh_interpreter_s"],
               artifact_launches=child["launches"], artifact_agreement_decided=art["agreement"],
               artifact_meta=child["meta"])
    return dict(eval_gap=row["evaluate_vs_trainer_test_max_gap"], bytes=art["bytes"],
                params=art["params"], agreement=art["agreement"], launches=child["launches"])


def quant_artifact_row(art: dict) -> dict:
    """The quant phase's int8 export artifact as a fresh interpreter ran it."""
    print(f"[quant] int8 export artifact: {art['bytes']} bytes (< {4 * art['params']}), "
          f"exported in {art['export_s']:.3f} s; a fresh interpreter in "
          f"{art['fresh_interpreter_s']:.3f} s: launches {art['child']['launches']}, "
          f"class ids vs the server {art['agreement']} of decided pixels (>= "
          f"{ARTIFACT_AGREEMENT})", flush=True)
    return {k: v for k, v in art.items() if k != "child"}


def _server_predict(server):
    """The fused predict (raw chips to class ids on the card) of a
    ``ModelServer``'s model with its config's preprocessing."""
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn

    pre = {k: v for k, v in server.preprocess.items() if k not in ("mean", "std")}
    return make_fused_predict_fn(server.model, server.preprocess["mean"],
                                 server.preprocess["std"], **pre)


def _server_chips(server, raw, device):
    """Raw chips preprocessed on ``device`` as ``server``'s config says."""
    import torch

    from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device

    p = server.preprocess
    return preprocess_chips(
        raw_to_device(raw, device), torch.tensor(p["mean"], device=device),
        torch.tensor(p["std"], device=device), p["temporal_size"],
        torch.tensor(list(p["bands"]), device=device), p["constant_multiplier"],
        img_size=p["img_size"])


def serve_models_phase(device, smi: str, overrides=None, batch: int = 64, train_batch: int = 8,
                       fixed_steps: int = 10, variants=(("prithvi_eo_v2_300_tl", 4, 16),
                                 ("prithvi_eo_v2_600_tl", 4, 4)),
                       n_chips: int = 16, turns: int = SERVE_TURNS, iters: int = 5, *,
                       artifact_dir: str) -> dict:
    """Every model the JAX package builds, served through the port's entry
    points (``ModelServer(cfg)``, ``EvaluationPipeline``, the export
    artifact) at full width with random weights from seed 0 in bf16:

    1. the crop config with the fast head against the torch head at batch
       64, in turns: ms per fused predict, launches per predict, the fast
       head's logits with the kernel against the plain attention;
    2. the fast head in training, as the train phase: 10 steps on one
       batch of 8 with the launches per step (the forward and backward once
       per block, the dropout in 3 stages and the head), then one step with
       the kernels against one with the plain versions, the gradients also
       against a plain step that keeps P in float32;
    3. each ``_tl`` variant at T=4: launches per predict, kernel against
       plain logits and encoder features without coords and (300M) with
       them, and the coords' effect on the features beyond the kernel/plain
       gap;
    4. the GELU lowerings on the crop model at batch 64, in turns: ms per
       predict and argmax agreement with ``exact``;
    5. the serving layer on a port checkpoint of the fast-head model over
       synthetic chips: ``EvaluationPipeline.evaluate`` against
       ``Trainer.test`` on the same loader, ``chip_inference`` against the
       online batcher on decided pixels, the exported artifact run in a
       fresh interpreter that does not import the port's models (batch 64
       and 7: class ids against the server's, launches per call) and its
       size against 4 bytes per parameter.

    ``overrides``: config overrides (a CPU rehearsal's tiny model); on the
    CPU no kernel launches, so the launch checks hold only on the card.
    ``artifact_dir``: where step 5's artifact is prepared for a fresh
    interpreter that a later phase starts (``out["artifact_job"]``, its row
    ``out["serving_row"]``, held by ``_artifact_verify`` and printed by
    ``serving_row``)."""
    import torch

    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.data.dataloader import create_dataloader, eval_collate, process_test
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.serve.pipeline import EvaluationPipeline
    from instageo_tpu_torch.serve.server import ModelServer
    from instageo_tpu_torch.train import run
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import model_channels
    from instageo_tpu_torch.train.trainer import Trainer

    on_card = device.type == "cuda"
    overrides = dict(overrides or {})
    if not on_card:
        overrides["device"] = "cpu"
    clock = Clock("serve_models")
    rng = np.random.default_rng(7)

    def config(**more):
        return load_config(CROP_CONFIG, overrides={
            "model.load_pretrained_weights": False, **overrides, **more})

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def raw_chips(n, cfg):
        dl = cfg.dataloader
        return rng.integers(0, 10000, (n, len(dl.bands), int(dl.img_size), int(dl.img_size)),
                            dtype=np.uint16)

    out = {}
    # --- 1. fast head vs torch head ----------------------------------------
    cfg = config()
    servers = {head: ModelServer(config(**{"model.head_impl": head}), device=device)
               for head in ("torch", "fast")}
    depth = len(servers["torch"].model.prithvi_encoder.blocks)
    raw = raw_chips(batch, cfg)
    predicts = {head: _server_predict(sv) for head, sv in servers.items()}
    launches = {head: _predict_launches(fn, raw, depth, f"{head} head", on_card)
                for head, fn in predicts.items()}
    timing = _predict_turns(predicts, raw, turns, iters)
    gap = kernel_vs_plain_logits(servers["fast"].model,
                                 _server_chips(servers["fast"], raw, device))
    print(f"[serve_models] fast head, kernel vs plain attention, batch {batch}: "
          f"{_describe_gap(gap)}", flush=True)
    for head in ("torch", "fast"):
        _serve_row(smi, part="head", head=head, model=str(cfg.model.model_name),
                   batch=batch, ms_per_predict=timing[head]["ms"],
                   turns_ms=timing[head]["turns"],
                   chips_per_s=batch * 1e3 / timing[head]["ms"],
                   fwd_launches_per_predict=launches[head]["flash_attn_fwd"],
                   mma_sync_launches=launches[head]["flash_attn_fwd_mma"],
                   **({k: v for k, v in gap.items() if k != "logits"} if head == "fast" else {}))
    out["heads"] = dict(timing=timing, launches=launches,
                        gap={k: v for k, v in gap.items() if k != "logits"})
    fast_server = servers.pop("fast")
    del servers, predicts, gap
    free()
    clock.lap("fast vs torch head")

    # --- 2. one fast-head train step ---------------------------------------
    model_kw = dict(variant=str(cfg.model.model_name), num_classes=int(cfg.model.num_classes),
                    temporal_step=int(cfg.dataloader.temporal_dim),
                    image_size=int(cfg.dataloader.img_size), num_bands=model_channels(cfg))
    data = dict(mean=list(cfg.dataloader.mean), std=list(cfg.dataloader.std))
    train_cfg = {"train": {k: cfg.train[k] for k in ("learning_rate", "weight_decay",
                                                    "class_weights", "ignore_index")},
                 "model": {"num_classes": cfg.model.num_classes}}
    model = create_prithvi_seg(**model_kw, head_impl="fast", dtype=torch.bfloat16,
                               param_dtype=torch.float32, device=device, seed=0)
    trainer = Trainer(train_cfg, model, device=device)
    x, y = _crop_batch(train_batch, model_kw["temporal_step"], model_kw["image_size"],
                       model_kw["num_classes"], seed=1, data=data)
    xb, yb = trainer.prepare_batch(x, y, train_batch)
    gen = torch.Generator().manual_seed(0)
    reset_counts()
    losses = [float(trainer.train_step(xb, yb, gen)) for _ in range(fixed_steps)]
    counts = {k: v / fixed_steps for k, v in read_counts().items()}
    want = {"flash_attn_fwd": depth, "flash_attn_fwd_mma": 0, "flash_attn_bwd": depth,
            "flash_attn_bwd_mma": 0, "fused_dropout": 4}
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"fast-head train steps: losses {losses}")
    if on_card:
        check(counts == want, f"fast-head launches per train step {counts}, expected {want}")
    loss_rel, worst = kernel_vs_plain_step(device, model, model_kw, train_cfg, xb, yb,
                                           "serve_models", head_impl="fast")
    _serve_row(smi, part="fast_head_train_step", batch=train_batch, steps=fixed_steps,
               losses=losses, launches_per_step=counts, kernel_vs_plain_loss_rel=loss_rel,
               kernel_vs_plain_grad_rel_worst=worst)
    out["train_step"] = dict(launches=counts, loss_rel=loss_rel, grad_rel=worst[0][1])
    del model, trainer, xb, yb
    free()
    clock.lap("fast-head train step")

    # --- 3. the _tl variants at T=4 -----------------------------------------
    out["variants"] = {}
    for variant, t, b in variants:
        vcfg = config(**{"model.model_name": variant, "dataloader.temporal_dim": t,
                         "dataloader.bands": list(range(6 * t))})
        server = ModelServer(vcfg, device=device)
        enc = server.model.prithvi_encoder
        vdepth, heads = len(enc.blocks), enc.blocks[0].attn.num_heads
        raw = raw_chips(b, vcfg)
        counts = _predict_launches(_server_predict(server), raw, vdepth, variant, on_card)
        xv = _server_chips(server, raw, device)
        years = torch.from_numpy(rng.integers(2015, 2025, (b, t)).astype(np.float32))
        days = torch.from_numpy(rng.integers(1, 366, (b, t)).astype(np.float32))
        coords = dict(
            temporal_coords=torch.stack([years, days], dim=-1).to(device),
            location_coords=torch.from_numpy(np.stack(
                [rng.uniform(-60, 60, b), rng.uniform(-180, 180, b)], axis=1)
                .astype(np.float32)).to(device))
        plain = kernel_vs_plain_logits(server.model, xv)
        feats = kernel_vs_plain_features(server.model, xv)
        row = dict(part="variant", variant=variant, temporal_dim=t, batch=b,
                   tokens=int(enc.patch_embed(xv[:1]).shape[1]) + 1,
                   head_dim=enc.embed_dim // heads, depth=vdepth,
                   fwd_launches_per_predict=counts["flash_attn_fwd"],
                   mma_sync_launches=counts["flash_attn_fwd_mma"],
                   no_coords={k: v for k, v in plain.items() if k != "logits"},
                   no_coords_features={k: v for k, v in feats.items() if k != "features"})
        if variant.endswith("_600_tl"):
            row["note"] = "kernel vs plain without coords only"
        else:
            with_coords = kernel_vs_plain_logits(server.model, xv, **coords)
            feats_c = kernel_vs_plain_features(server.model, xv, **coords)
            # With random weights the logits (~0.07) move by about one bf16
            # step; the encoder's float32 features show the embeddings
            # (scale 0.1), which must move them by more than the kernel and
            # the plain attention differ there.
            moved = (feats_c["features"] - feats["features"]).abs().max().item()
            noise = feats["max_abs_diff"]
            check(moved > noise, f"{variant}: coords moved the features by {moved}, no more "
                  f"than the kernel/plain difference {noise}")
            row.update(with_coords={k: v for k, v in with_coords.items() if k != "logits"},
                       with_coords_features={k: v for k, v in feats_c.items()
                                             if k != "features"},
                       coords_moved_logits_by=(with_coords["logits"]
                                               - plain["logits"]).abs().max().item(),
                       coords_moved_features_by=moved)
            del with_coords, feats_c
        _serve_row(smi, **row)
        out["variants"][variant] = row
        del server, enc, xv, plain, feats, coords
        free()
        clock.lap(variant)

    # --- 4. the GELU lowerings ----------------------------------------------
    servers = {g: ModelServer(config(**{"tpu.gelu": g}), device=device)
               for g in ("exact", "tanh", "bf16")}
    raw = raw_chips(batch, cfg)
    timing = _predict_turns({g: _server_predict(sv) for g, sv in servers.items()}, raw, turns,
                            iters)
    preds = {g: _server_predict(sv)(raw).cpu() for g, sv in servers.items()}
    for g in servers:
        agree = (preds[g] == preds["exact"]).float().mean().item()
        _serve_row(smi, part="gelu", gelu=g, batch=batch, ms_per_predict=timing[g]["ms"],
                   turns_ms=timing[g]["turns"], chips_per_s=batch * 1e3 / timing[g]["ms"],
                   argmax_agreement_with_exact=agree)
    out["gelu"] = timing
    del servers, preds
    free()
    clock.lap("gelu lowerings")

    # --- 5. the serving layer ------------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    try:
        dl = cfg.dataloader
        size, classes = int(dl.img_size), int(cfg.model.num_classes)
        paths = _write_dataset(root, 0, n_chips, len(dl.bands), size, classes)
        ckpt = BestCheckpointer(os.path.join(root, "run")).save(
            {"model": fast_server.model.state_dict()})
        pcfg = config(**{"model.head_impl": "fast", "root_dir": root,
                         "test_filepath": f"{root}/val.csv", "checkpoint_path": ckpt})
        pipe = EvaluationPipeline(pcfg)
        metrics = pipe.evaluate()
        server = pipe.server
        batch_size = int(pcfg.train.batch_size)
        pre = partial(process_test, mean=list(dl.mean), std=list(dl.std),
                      temporal_size=int(dl.temporal_dim), img_size=int(pcfg.test.img_size),
                      crop_size=int(pcfg.test.crop_size), stride=int(pcfg.test.stride))
        loader = create_dataloader(run._make_dataset(f"{root}/val.csv", pcfg, pre), batch_size,
                                   collate_fn=eval_collate, num_workers=0, device=device)
        ref = Trainer(pcfg, server.model, device=device).test(lambda: iter(loader), batch_size)
        eval_gap = max(abs(metrics[k] - v) for k, v in ref.items())
        check(set(ref) <= set(metrics) and eval_gap <= EVAL_TOL,
              f"EvaluationPipeline.evaluate vs Trainer.test: {metrics} vs {ref}")

        result = pipe.chip_inference(os.path.join(root, "predictions"))
        check(result["num_chips"] == n_chips, f"chip_inference served {result['num_chips']}")
        raws, written = [], []
        for p in paths:
            name = os.path.basename(p).replace("chip", "prediction")
            with GeoTiffReader(p) as r:
                raws.append(r.read())
            with GeoTiffReader(os.path.join(root, "predictions", name)) as r:
                written.append(r.read(1))
        xs = _server_chips(server, np.stack(raws), device)
        batcher = server.online_batcher(max_batch=batch_size)
        online = np.stack([batcher.submit(c).result(timeout=600) for c in xs.cpu().numpy()])
        with torch.inference_mode():
            logits = server.model(xs, channels_last=True).float()
        top2 = logits.topk(2, dim=-1).values
        decided_ci = ((top2[..., 0] - top2[..., 1])
                      >= DECIDED_GAP * logits.abs().max()).cpu().numpy()
        same = np.stack(written) == online
        check(bool(same[decided_ci].all()),
              f"chip_inference vs online batcher: {int((~same[decided_ci]).sum())} decided "
              "pixels differ")

        x64 = _server_chips(server, raw_chips(batch, cfg), device)
        row = dict(part="serving_layer", chips=n_chips,
                   evaluate_vs_trainer_test_max_gap=eval_gap,
                   chip_inference_vs_online_decided_pixels=int(decided_ci.sum()),
                   chip_inference_pixels=int(decided_ci.size),
                   chip_inference_vs_online_agree=True)
        # Run later, in a fresh interpreter shared with other phases.
        out["artifact_job"] = _artifact_prepare(
            server, x64, os.path.join(artifact_dir, "serve_models"), depth, on_card)
        out["serving_row"] = row
        pipe.cleanup()
    finally:
        tmp.cleanup()
    del fast_server
    free()
    clock.lap("serving layer")
    return out


# The synthetic granule of the granule and chip_ops phases: one HLS MGRS tile
# at 30 m (3660 px), three timesteps (the first an L30 granule, the others
# S30), and a block that is 0 in every band (top row, left column, side).
F32_LOGIT_TOL = 1e-3  # f32 card vs CPU: max |logit diff| / max |logit| (f32 sums in other orders)
GEMM_SHAPE = (64 * 589, 768, 3072)  # fc1 of V1-100M at batch 64: (B·L, D) x (D, 4D)


def quant_phase(device, smi: str, overrides=None, batch: int = 64, f32_batch: int = 16,
                cpu_chips: int = 2, turns: int = SERVE_TURNS, iters: int = 5,
                gemm_shape=GEMM_SHAPE, gemm_iters: int = 20, *, artifact_dir: str) -> dict:
    """``tpu.quant: int8`` (dynamic W8A8, ``ops/quant.py``) served through
    ``ModelServer(cfg)`` on the crop config at full width, random weights
    from seed 0:

    1. the int8 and the bf16 model at ``batch``: ms per fused predict in
       turns, launches per predict (the forward kernel once per block, on
       wgmma), the int8 model's logits with the kernel against the plain
       attention, its argmax against the bf16 model's (reported);
    2. the int8 model on the card against the same config on the CPU, on
       ``cpu_chips`` chips: max |logit diff| within LOGIT_TOL of max |logit|,
       argmax agreement at least ARGMAX_AGREEMENT on decided pixels;
    3. its export artifact in a fresh interpreter against the server, at
       ``batch`` (prepared in ``artifact_dir`` for a later phase's fresh
       interpreter, ``out["artifact_job"]``, as in serve_models);
    4. the Trainer refusing it in training;
    5. ``int8_matmul`` (quantize, ``torch._int_mm``, rescale; the weight
       quantized once, as a served layer holds it) against ``F.linear`` in
       bf16 at ``gemm_shape``, in turns, with the quantize pass and the
       int8 product timed apart;
    6. the crop config with ``tpu.precision: f32`` at ``f32_batch``: the
       "xla" attention route once per block per predict, no kernel launch,
       logits within F32_LOGIT_TOL of the CPU's.

    ``overrides``: config overrides (a CPU rehearsal's tiny model); on the
    CPU no kernel launches, so the launch checks hold only on the card."""
    import torch
    import torch.nn.functional as F

    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.models import prithvi
    from instageo_tpu_torch.ops.quant import int8_matmul, quantize_symmetric
    from instageo_tpu_torch.serve.server import ModelServer
    from instageo_tpu_torch.train.trainer import Trainer

    on_card = device.type == "cuda"
    cpu = torch.device("cpu")
    overrides = dict(overrides or {})
    clock = Clock("quant")
    rng = np.random.default_rng(11)

    def config(**more):
        return load_config(CROP_CONFIG, overrides={
            "model.load_pretrained_weights": False, **overrides, **more})

    def logits_of(model, x):
        with torch.inference_mode():
            return model(x, channels_last=True).float()

    def against_cpu(card_logits, cpu_logits, tol, tag):
        """max |Δ| / max |logit| and argmax agreement on decided pixels."""
        diff = (card_logits - cpu_logits).abs().max().item()
        scale = cpu_logits.abs().max().item()
        top2 = cpu_logits.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * scale
        agree = (card_logits.argmax(-1) == cpu_logits.argmax(-1))[decided].float().mean().item()
        check(diff <= tol * scale and agree >= ARGMAX_AGREEMENT,
              f"{tag}: card vs CPU max |diff| {diff} of {scale} (<= {tol}), argmax "
              f"agreement {agree} on decided pixels")
        return dict(max_abs_diff=diff, scale=scale, agreement_decided=agree,
                    decided=decided.float().mean().item())

    out = {}
    tmp = tempfile.TemporaryDirectory()
    try:
        # --- 1. int8 vs bf16 through ModelServer ----------------------------
        qcfg = config(**{"tpu.quant": "int8"})
        servers = {"int8": ModelServer(qcfg, device=device),
                   "bf16": ModelServer(config(), device=device)}
        depth = len(servers["int8"].model.prithvi_encoder.blocks)
        dl = qcfg.dataloader
        raw = rng.integers(0, 10000, (batch, len(dl.bands), int(dl.img_size),
                                      int(dl.img_size)), dtype=np.uint16)
        predicts = {name: _server_predict(sv) for name, sv in servers.items()}
        launches = {name: _predict_launches(fn, raw, depth, f"{name} predict", on_card)
                    for name, fn in predicts.items()}
        timing = _predict_turns(predicts, raw, turns, iters)
        x = _server_chips(servers["int8"], raw, device)
        gap = kernel_vs_plain_logits(servers["int8"].model, x)
        q_logits = gap.pop("logits")
        b_logits = logits_of(servers["bf16"].model, x)
        top2 = b_logits.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * b_logits.abs().max()
        same = q_logits.argmax(-1) == b_logits.argmax(-1)
        vs_bf16 = dict(agreement=same.float().mean().item(),
                       agreement_decided=same[decided].float().mean().item(),
                       decided=decided.float().mean().item())
        print(f"[quant] {smi}: batch {batch}, ms per fused predict in turns: int8 "
              f"{timing['int8']['ms']:.3f} {timing['int8']['turns']}, bf16 "
              f"{timing['bf16']['ms']:.3f} {timing['bf16']['turns']} (int8 / bf16 "
              f"{timing['int8']['ms'] / timing['bf16']['ms']:.4f}); launches per predict "
              f"{json.dumps(launches['int8'])}; int8 kernel vs plain attention: "
              f"{_describe_gap(gap)}; int8 vs bf16 argmax agreement "
              f"{vs_bf16['agreement']:.6f} of all pixels, {vs_bf16['agreement_decided']:.6f} "
              f"of the {vs_bf16['decided']:.4f} decided by the bf16 logits", flush=True)
        out.update(timing=timing, launches=launches, kernel_vs_plain=gap, vs_bf16=vs_bf16)
        del predicts, b_logits
        clock.lap("int8 vs bf16")

        # --- 2. the card against the CPU, under quant -----------------------
        # The same weights on the CPU (a CPU generator draws others from the seed).
        cpu_server = ModelServer(config(**{"tpu.quant": "int8", "device": "cpu"}), device=cpu)
        cpu_server.model.load_state_dict(servers["int8"].model.state_dict())
        xc = _server_chips(cpu_server, raw[:cpu_chips], cpu)
        out["vs_cpu"] = against_cpu(q_logits[:cpu_chips].cpu(),
                                    logits_of(cpu_server.model, xc), LOGIT_TOL, "int8")
        print(f"[quant] int8 on the card vs the port on the CPU, {cpu_chips} chips: max |logit "
              f"diff| {out['vs_cpu']['max_abs_diff']:.6g} (<= {LOGIT_TOL} x max |logit| "
              f"{out['vs_cpu']['scale']:.6g}); argmax agreement "
              f"{out['vs_cpu']['agreement_decided']:.6f} (>= {ARGMAX_AGREEMENT}) of the "
              f"{out['vs_cpu']['decided']:.4f} decided pixels", flush=True)
        del cpu_server, xc, q_logits
        clock.lap("int8 card vs CPU")

        # --- 3. the export artifact in a fresh interpreter, at one batch ----
        # Run later, in a fresh interpreter shared with other phases.
        out["artifact_job"] = _artifact_prepare(
            servers["int8"], x, os.path.join(artifact_dir, "quant"), depth, on_card,
            batches=(batch,))
        clock.lap("int8 artifact")

        # --- 4. training refused --------------------------------------------
        trainer = Trainer(qcfg, servers["int8"].model, device=device)
        labels = torch.zeros(x[:2].shape[0], *x.shape[-2:], dtype=torch.long, device=device)
        try:
            trainer.train_step(x[:2], labels, torch.Generator().manual_seed(0))
        except ValueError as e:
            refused = str(e)
        else:
            refused = ""
        check("inference-only" in refused, f"the Trainer trained a quantized model: {refused!r}")
        print(f"[quant] Trainer.train_step on the int8 model: refused ({refused})", flush=True)
        del servers, trainer, x, labels
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # --- 5. one GEMM: int8_matmul vs F.linear in bf16, in turns -----------
        m, k, n = gemm_shape
        g = torch.Generator(device=device).manual_seed(3)
        xa = torch.randn(m, k, generator=g, device=device).to(torch.bfloat16)
        w = torch.randn(n, k, generator=g, device=device) * k ** -0.5
        b = torch.randn(n, generator=g, device=device) * 0.02
        w16, b16 = w.to(torch.bfloat16), b.to(torch.bfloat16)
        wq = quantize_symmetric(w)
        xq, _ = quantize_symmetric(xa)
        fns = {"int8_matmul": lambda: int8_matmul(xa, w, b, torch.bfloat16, wq),
               "bf16_linear": lambda: F.linear(xa, w16, b16),
               "quantize_x": lambda: quantize_symmetric(xa),
               "int_mm": lambda: torch._int_mm(xq, wq[0].t())}
        per = {name: [] for name in fns}
        with torch.inference_mode():
            for _ in range(turns):
                for name, fn in fns.items():
                    per[name].append(time_ms(fn, device, gemm_iters))
            ref = F.linear(xa.float(), w, b)
            rel = ((int8_matmul(xa, w, b, torch.float32, wq) - ref).norm() / ref.norm()).item()
        gemm = {name: float(np.mean(v)) for name, v in per.items()}
        ops = 2.0 * m * k * n
        gemm_bounds = {"int8_ops_ms": ops / PEAK_INT8_OPS * 1e3,
                       "bf16_ops_ms": ops / PEAK_BF16_FLOPS * 1e3,
                       "bf16_bytes_ms": 2.0 * (m * k + k * n + m * n) / PEAK_BYTES_PER_S * 1e3}
        check(rel < 0.02, f"int8_matmul vs the float32 product: relative error {rel}")
        print(f"[quant] {smi}: ({m} x {k}) @ ({k} x {n}), ms per call in turns: "
              + ", ".join(f"{name} {ms:.4f} {[round(t, 4) for t in per[name]]}"
                          for name, ms in gemm.items())
              + f"; bounds: int8 operations {gemm_bounds['int8_ops_ms']:.4f} ms, bf16 "
              f"operations {gemm_bounds['bf16_ops_ms']:.4f} ms, bf16 bytes "
              f"{gemm_bounds['bf16_bytes_ms']:.4f} ms; int8 vs float32 product: relative "
              f"error {rel:.3g}", flush=True)
        out["gemm"] = dict(ms=gemm, turns=per, bounds=gemm_bounds, rel_err=rel,
                           shape=[m, k, n])
        del xa, w, b, w16, b16, wq, xq, fns
        clock.lap("GEMM in turns")

        # --- 6. a float32 model: the "xla" route, no kernel ------------------
        fcfg = config(**{"tpu.precision": "f32"})
        f_server = ModelServer(fcfg, device=device)
        check({blk.attn.attn_impl for blk in f_server.model.prithvi_encoder.blocks} == {"xla"},
              "the f32 model's attention is not on the xla route")
        f_raw = raw[:f32_batch]
        reset_counts()
        pred = _server_predict(f_server)(f_raw).cpu()
        counts, xla_calls = read_counts(), prithvi.xla_attn_calls.count
        check(xla_calls == depth and not any(counts.values()),
              f"f32 predict: xla_attn_calls {xla_calls} (expected {depth}), launches {counts}")
        f_cpu = ModelServer(config(**{"tpu.precision": "f32", "device": "cpu"}), device=cpu)
        f_cpu.model.load_state_dict(f_server.model.state_dict())
        out["f32"] = against_cpu(
            logits_of(f_server.model, _server_chips(f_server, f_raw[:cpu_chips], device)).cpu(),
            logits_of(f_cpu.model, _server_chips(f_cpu, f_raw[:cpu_chips], cpu)), F32_LOGIT_TOL,
            "f32")
        out["f32"].update(xla_attn_calls=xla_calls, launches=counts,
                          predicted=list(pred.shape))
        print(f"[quant] f32 crop model at batch {f32_batch}: xla_attn_calls {xla_calls} per "
              f"predict, launches {json.dumps(counts)}; vs the CPU on {cpu_chips} chips: max "
              f"|logit diff| {out['f32']['max_abs_diff']:.6g} (<= {F32_LOGIT_TOL} x "
              f"{out['f32']['scale']:.6g}), argmax agreement "
              f"{out['f32']['agreement_decided']:.6f} of decided pixels", flush=True)
        del f_server, f_cpu
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        clock.lap("f32 model")
        return out
    finally:
        tmp.cleanup()


GRANULE_SIZE = 3660
GRANULE_BLOCK = (1000, 2000, 300)
GRANULE_IDS = {"HLS.L30.T33TUN.2023152T095000.v2.0": "2023-06-01T09:50:00Z",
               "HLS.S30.T33TUN.2023157T100000.v2.0": "2023-06-06T10:00:00Z",
               "HLS.S30.T33TUN.2023162T100000.v2.0": "2023-06-11T10:00:00Z"}
GRANULE_GAP = 1e-3   # decided pixels: the plain logits' top-2 gap at least this
GRANULE_OVERLAP = 16


# The synthetic tile's files, written once per run and read by the granule,
# chip_creator and webapp phases: (size, block, seed) -> (directory, bands,
# fmask, granules).
_TILES: dict = {}


def _write_granule(root: str, size: int, block, seed: int = 8):
    """Three HLS granules of one synthetic MGRS tile: six uint16 band files
    each (values 100..8999; 0 on the nodata block in every band) and an
    Fmask plane, tiled 256 px with the writer's default compression (deflate),
    EPSG 32633 at 30 m, written by 8 threads once per run (later calls read
    the same files); and, in ``root``, the dataset JSON with their local
    hrefs, one entry. Returns the JSON's path, the bands (18, size, size) in
    the opener's order, the Fmask planes (3, size, size), both read-only, and
    the transform."""
    import atexit
    import copy
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
    from instageo_tpu_torch.data.settings import BANDS_SETTINGS

    transform = Affine.from_origin(399960.0, 4600020.0, 30.0, 30.0)
    key = (size, tuple(block), seed)
    if key not in _TILES:
        tile_dir = tempfile.mkdtemp(prefix="chip_smoke_tile_")
        atexit.register(shutil.rmtree, tile_dir, ignore_errors=True)
        rng = np.random.default_rng(seed)
        top, left, side = block
        bands = rng.integers(100, 9000, (6 * len(GRANULE_IDS), size, size), dtype=np.uint16)
        bands[:, top:top + side, left:left + side] = 0
        # Clear, cloud (bit 1), shadow (bit 3), both, water (bit 5).
        fmask = rng.choice(np.asarray([0, 0, 0, 2, 8, 10, 32], np.uint8),
                           (len(GRANULE_IDS), size, size))
        granules, jobs = [], []
        for t, (gid, when) in enumerate(GRANULE_IDS.items()):
            names = (BANDS_SETTINGS.HLS_L30_ASSETS if ".L30." in gid
                     else BANDS_SETTINGS.HLS_ASSETS) + [BANDS_SETTINGS.HLS_MASK_ASSET]
            assets = {}
            for k, name in enumerate(names):
                path = os.path.join(tile_dir, f"{gid}.{name}.tif")
                jobs.append((path, bands[6 * t + k] if k < 6 else fmask[t]))
                assets[name] = {"href": path}
            granules.append({"id": gid, "collection": "HLS" + gid.split(".")[1] + "_2.0",
                             "bbox": [14.999, 41.51, 16.33, 42.51],
                             "properties": {"datetime": when, "eo:cloud_cover": 5},
                             "assets": assets})
        with ThreadPoolExecutor(8) as pool:
            for _ in pool.map(lambda job: write_geotiff(job[0], job[1], transform=transform,
                                                        crs=32633, tiled=True, tile_size=256),
                              jobs):
                pass
        bands.flags.writeable = False
        fmask.flags.writeable = False
        _TILES[key] = (tile_dir, bands, fmask, granules)
    _, bands, fmask, granules = _TILES[key]
    path = os.path.join(root, "hls_dataset.json")
    with open(path, "w") as f:
        json.dump({"T33TUN_2023152": {"granules": copy.deepcopy(granules)}}, f)
    return path, bands, fmask, transform


def top2_gap(model):
    """``model``'s top-2 logit gap as a one-channel regression output, so the
    granule and chip paths carry it as they carry predictions."""
    from torch import nn

    class Top2Gap(nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x, channels_last=True):
            top2 = self.inner(x, channels_last=True).float().topk(2, dim=-1).values
            return (top2[..., 0] - top2[..., 1])[..., None]

    return Top2Gap(model)


def _sliding_inference_timed(argv) -> dict:
    """``run.main(argv)`` in ``mode=sliding_inference`` with the HLS opener
    and the granule writer timed: the granule count (``done``), decode and
    file seconds, the bands opened and ``granule_inference``'s stats."""
    from instageo_tpu_torch.data.sources import hls
    from instageo_tpu_torch.serve import granule
    from instageo_tpu_torch.train import run

    rec = {}
    opener, to_file = hls.open_hls_stac_items, granule.granule_inference_to_file

    def timed_open(*a, **k):
        t0 = time.perf_counter()
        out = opener(*a, **k)
        rec["decode_s"], rec["bands"] = time.perf_counter() - t0, out[0]
        return out

    def timed_file(*a, **k):
        t0 = time.perf_counter()
        out = to_file(*a, **k)
        rec["file_s"], rec["stats"] = time.perf_counter() - t0, k["stats"]
        return out

    with mock.patch.object(hls, "open_hls_stac_items", timed_open), \
            mock.patch.object(granule, "granule_inference_to_file", timed_file):
        rec["done"] = run.main(list(argv))
    return rec


def _granule_fresh_process(build_root: str, mode: str, artifacts: str, argv) -> None:
    """What a fresh interpreter runs for the granule phase's cold runs:
    ``mode=sliding_inference`` as a user starts it, with
    ``INSTAGEO_COMPILE_CACHE_DIR`` = ``build_root``: on an empty directory the
    forward kernel is built there at its first launch; with ``mode``
    "no_nvcc" any call for ``nvcc`` raises, so the library must come from
    there. ``artifacts``: a JSON file of ``_artifact_prepare`` jobs, run
    first (``_artifact_child``), or "-". Prints one JSON line: the granule's
    seconds, the process's seconds from before ``import torch``, the seconds
    each kernel build took, the forward kernel's library path and the
    artifacts' record."""
    t0 = time.perf_counter()
    os.environ["INSTAGEO_COMPILE_CACHE_DIR"] = build_root
    import torch

    from instageo_tpu_torch.ops import _build

    if mode == "no_nvcc":
        def no_nvcc():
            raise RuntimeError("nvcc was asked for: the library was not in the cache")

        _build._nvcc = no_nvcc
    art = None
    if artifacts != "-":
        with open(artifacts) as f:
            art = _artifact_child(json.load(f))
    t_granule = time.perf_counter()
    rec = _sliding_inference_timed(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    stats = rec["stats"]
    print(json.dumps(dict(
        done=rec["done"], decode_s=rec["decode_s"], file_s=rec["file_s"],
        h2d_s=stats["h2d_s"], device_s=stats["device_s"],
        first_batch_s=stats["first_batch_s"], process_s=time.perf_counter() - t0,
        granule_process_s=time.perf_counter() - t_granule, build_s=dict(_build.build_seconds),
        lib=str(_build._lib_path("flash_attn_fwd_sm90")), artifacts=art)), flush=True)


def granule_phase(device, smi: str, size: int = GRANULE_SIZE, block=GRANULE_BLOCK,
                  extra=(), batches=(8, 64), overlap: int = GRANULE_OVERLAP,
                  artifacts=()) -> dict:
    """Whole-granule inference as a user runs it: ``mode=sliding_inference``
    of the run CLI (in-process) on the crop config over the synthetic HLS
    granule (T=3, ``size``² px), random weights from seed 0 in a checkpoint,
    at each of ``batches`` (the yaml's 8, then 64), with the launch counts
    set to 0 just before each run and read just after. Holds: the output
    GeoTIFF (shape, int8, the tile's transform and CRS, classes in
    [0, classes), −1 exactly on the nodata block); the opened bands against
    those written; the stitched canvas against ``make_fused_predict_fn`` on
    the same batch of chips (the last padded with copies of chip 0, as the
    path pads it), bit for bit, at 8 chip windows (the clamped last row and
    column, the corners, the nodata block), where each chip is the last to
    write; the kernel route against the plain attention over the whole
    granule (argmax agreement on pixels whose plain top-2 gap is at least
    GRANULE_GAP); forward launches = depth x batches, none on mma.sync; one
    run with ``overlap``, full coverage and the kernel against the plain
    attention there too. Reports per run the decode, host-to-device,
    device (CUDA events), first-batch and wall seconds of the granule,
    chips/s and peak device memory. These runs share a process that earlier
    phases warmed; on the card two fresh interpreters then run the CLI at
    the first of ``batches`` (``_granule_fresh_process``): one builds the
    forward kernel into an empty directory at its first launch, one loads
    the built library, and both predictions are held against the plain
    attention. ``artifacts``: earlier phases' export artifacts
    (``_artifact_prepare`` jobs), run in the second of those interpreters
    before its granule (off the card, in a fresh interpreter of their own);
    their record is ``out["artifacts"]``. ``extra``: overrides (a CPU
    rehearsal's tiny model). Returns the numbers and the tile's arrays for
    the chip_ops phase."""
    # Each run opens 18 assets and the loader allows 30 a minute per
    # process by default; raise it before the loaders are imported.
    os.environ.setdefault("INSTAGEO_COG_RATELIMIT", "1000")
    import torch

    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.data.settings import DATA_PIPELINE_SETTINGS
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
    from instageo_tpu_torch.serve import granule
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import create_model

    check(DATA_PIPELINE_SETTINGS.COG_DOWNLOAD_RATELIMIT >= 100,
          f"asset loads limited to {DATA_PIPELINE_SETTINGS.COG_DOWNLOAD_RATELIMIT} a minute")
    on_card = device.type == "cuda"
    clock = Clock("granule")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    try:
        json_path, bands, fmask, transform = _write_granule(root, size, block)
        clock.lap(f"wrote {len(GRANULE_IDS)} x 7 files of {size}² px")
        base = [f"--config-name={CROP_CONFIG}", f"root_dir={root}", f"test_filepath={json_path}",
                "model.load_pretrained_weights=False", "mode=sliding_inference", *extra]
        if not on_card:
            base.append("device=cpu")
        cfg = load_config_from_argv(base)
        model = create_model(cfg, seed=0, device=device)
        ckpt = BestCheckpointer(os.path.join(root, "run")).save({"model": model.state_dict()})
        base.append(f"checkpoint_path={ckpt}")
        dl = cfg.dataloader
        depth, classes = len(model.prithvi_encoder.blocks), int(cfg.model.num_classes)
        chip = int(dl.img_size)
        kw = dict(chip_size=chip, temporal_size=int(dl.temporal_dim), bands=list(dl.bands),
                  constant_multiplier=float(dl.constant_multiplier),
                  no_data_value=dl.no_data_value or 0)
        mean, std = list(dl.mean), list(dl.std)
        coords, bounds = granule.chip_grid(size, size, chip)
        n = len(coords)
        top, left, side = block
        nodata = np.zeros((size, size), bool)
        nodata[top:top + side, left:left + side] = True
        owner = np.full((size, size), -1, np.int64)  # the chip that writes each pixel last
        for i, ((x, y), (y0, y1, x0, x1)) in enumerate(zip(coords, bounds)):
            owner[y + y0:y + y1, x + x0:x + x1] = i
        pred_path = os.path.join(root, "predictions", "prediction_T33TUN_2023152.tif")

        def expected_launches(batch: int, chips: int = n) -> dict:
            return {"flash_attn_fwd": depth * -(-chips // batch), "flash_attn_fwd_mma": 0,
                    "flash_attn_bwd": 0, "flash_attn_bwd_mma": 0, "fused_dropout": 0}

        runs, preds = {}, {}
        for batch in batches:
            # --- one run of the CLI: counts from 0, read right after ------
            reset_counts()
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rec = _sliding_inference_timed(base + [f"train.batch_size={batch}"])
            if on_card:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            # -----------------------------------------------------------------
            check(rec["done"] == 1, f"sliding_inference ran {rec['done']} granules")
            if batch == batches[0]:
                check(np.array_equal(rec["bands"], bands),
                      "the opened bands differ from those written")
            with GeoTiffReader(pred_path) as r:
                pred = r.read(1)
                check(r.crs == 32633 and r.transform.to_gdal() == transform.to_gdal(),
                      f"prediction georeferencing {r.crs} {r.transform.to_gdal()}")
            check(pred.shape == (size, size) and pred.dtype == np.int8,
                  f"prediction {pred.shape} {pred.dtype}")
            check(bool((pred[nodata] == -1).all()), "nodata block not -1")
            check(bool(((pred[~nodata] >= 0) & (pred[~nodata] < classes)).all()),
                  "classes outside [0, classes) or -1 outside the nodata block")
            if on_card:
                check(counts == expected_launches(batch),
                      f"batch {batch}: launches {counts}, expected {expected_launches(batch)}")
            stats = rec["stats"]
            granule_s = rec["decode_s"] + rec["file_s"]
            runs[batch] = dict(
                chips=n, batches=stats["batches"], launches=counts, cli_wall_s=wall,
                decode_s=rec["decode_s"], h2d_s=stats["h2d_s"], device_s=stats["device_s"],
                first_batch_s=stats["first_batch_s"],
                d2h_s=stats["d2h_s"], infer_s=stats["seconds"], granule_wall_s=granule_s,
                chips_per_s=n / granule_s,
                device_chips_per_s=n / stats["device_s"] if stats["device_s"] else None,
                peak_device_bytes=torch.cuda.max_memory_allocated() if on_card else None)
            preds[batch] = pred
            print(f"[granule] batch {batch}: {n} chips in {stats['batches']} batches; decode "
                  f"{rec['decode_s']:.3f} s, to the device {stats['h2d_s']:.3f} s, device "
                  f"{stats['device_s']} s (first batch {stats['first_batch_s']:.3f} s), copy "
                  f"back {stats['d2h_s']:.3f} s, granule wall "
                  f"{granule_s:.3f} s ({n / granule_s:.2f} chips/s), CLI wall {wall:.3f} s; "
                  f"peak device memory {runs[batch]['peak_device_bytes']} B; launches "
                  f"{json.dumps(counts)}", flush=True)
            clock.lap(f"sliding_inference at batch {batch}")

        # --- stitching: the canvas = the fused predict on the same batch ---
        predict = make_fused_predict_fn(model, mean, std, temporal_size=kw["temporal_size"],
                                        bands=kw["bands"],
                                        constant_multiplier=kw["constant_multiplier"])
        per_row = int(np.sum(coords[:, 1] == 0))
        rows = n // per_row
        windows = sorted({0, per_row - 1, per_row, (rows // 2) * per_row + per_row // 2,
                          int(owner[top + side // 2, left + side // 2]), (rows - 1) * per_row,
                          (rows - 1) * per_row + per_row // 2, n - 1})
        sel = np.asarray(kw["bands"])
        stitched = {}
        for batch in batches:
            pixels = 0
            for b in sorted({i // batch for i in windows}):
                ids = list(range(b * batch, min(n, (b + 1) * batch)))
                ids += [0] * (batch - len(ids))  # the path's padding: chip 0 at (0, 0)
                raw = np.stack([bands[:, y:y + chip, x:x + chip] for x, y in coords[ids]])
                out = predict(raw).cpu().numpy()
                out[(raw[:, sel] == kw["no_data_value"]).all(axis=1)] = -1
                for i in windows:
                    if i // batch != b:
                        continue
                    x, y = coords[i]
                    last = owner[y:y + chip, x:x + chip] == i
                    got = preds[batch][y:y + chip, x:x + chip][last]
                    check(last.any() and np.array_equal(got, out[i - b * batch][last]),
                          f"batch {batch}: the canvas differs from the fused predict at chip "
                          f"{i} ({x}, {y})")
                    pixels += int(last.sum())
            stitched[batch] = pixels
        print(f"[granule] stitching: chips {windows} of the {rows} x {per_row} grid equal the "
              f"fused predict on their batch bit for bit: " + ", ".join(
                  f"batch {b}: {p} px" for b, p in stitched.items()), flush=True)

        # --- the kernel route against the plain attention -----------------
        big = max(batches)
        with plain_attention(model):
            plain, _ = granule.granule_inference(bands, model, mean, std, batch_size=big, **kw)
            gap, _ = granule.granule_inference(bands, top2_gap(model), mean, std,
                                               batch_size=big, is_reg_task=True, **kw)
        decided = gap >= GRANULE_GAP  # NaN (nodata) is not decided
        agreement = {b: float((p == plain)[decided].mean()) for b, p in preds.items()}
        for b, a in agreement.items():
            check(a >= ARGMAX_AGREEMENT,
                  f"batch {b}: kernel vs plain argmax agreement {a} on decided pixels")
        between = float((preds[batches[0]] == preds[big])[decided].mean())
        print(f"[granule] kernel vs plain attention over the granule: argmax agreement "
              + ", ".join(f"batch {b}: {a:.6f}" for b, a in agreement.items())
              + f" (>= {ARGMAX_AGREEMENT}) on the {float(decided.mean()):.4f} of pixels whose "
              f"plain top-2 gap >= {GRANULE_GAP}; batch {batches[0]} vs {big}: {between:.6f}",
              flush=True)
        clock.lap("stitching and kernel vs plain")

        # --- overlap -------------------------------------------------------
        o_coords, o_bounds = granule.chip_grid(size, size, chip, overlap)
        cover = np.zeros((size, size), np.int32)
        for (x, y), (y0, y1, x0, x1) in zip(o_coords, o_bounds):
            cover[y + y0:y + y1, x + x0:x + x1] += 1
        check(bool((cover >= 1).all()), f"overlap {overlap}: pixels no chip covers")
        reset_counts()
        o_stats = {}
        o_pred, _ = granule.granule_inference(bands, model, mean, std, batch_size=big,
                                              overlap=overlap, stats=o_stats, **kw)
        o_counts = read_counts()
        check(bool((o_pred[nodata] == -1).all()) and bool(
            ((o_pred[~nodata] >= 0) & (o_pred[~nodata] < classes)).all()),
            f"overlap {overlap}: nodata or classes out of place")
        if on_card:
            want = expected_launches(big, len(o_coords))
            check(o_counts == want, f"overlap {overlap}: launches {o_counts}, expected {want}")
        with plain_attention(model):
            o_plain, _ = granule.granule_inference(bands, model, mean, std, batch_size=big,
                                                   overlap=overlap, **kw)
            o_gap, _ = granule.granule_inference(bands, top2_gap(model), mean, std,
                                                 batch_size=big, overlap=overlap,
                                                 is_reg_task=True, **kw)
        o_decided = o_gap >= GRANULE_GAP
        o_agree = float((o_pred == o_plain)[o_decided].mean())
        check(o_agree >= ARGMAX_AGREEMENT,
              f"overlap {overlap}: kernel vs plain argmax agreement {o_agree} on decided pixels")
        print(f"[granule] overlap {overlap}: {len(o_coords)} chips in {o_stats['batches']} "
              f"batches cover every pixel (1..{cover.max()} chips each); device "
              f"{o_stats['device_s']} s; kernel vs plain attention argmax agreement "
              f"{o_agree:.6f} (>= {ARGMAX_AGREEMENT}) on the {float(o_decided.mean()):.4f} of "
              f"pixels whose plain top-2 gap >= {GRANULE_GAP}; launches {json.dumps(o_counts)}",
              flush=True)
        clock.lap(f"overlap {overlap}")

        # --- fresh interpreters: what a user's first and later runs pay ----
        # Both on one INSTAGEO_COMPILE_CACHE_DIR, empty before the first: the
        # first builds the forward kernel there, the second (nvcc barred)
        # must load it from there, as a later process of a user's does.
        # The second also runs the earlier phases' export artifacts first:
        # one fresh interpreter for the three.
        fresh, art_rec = {}, None
        jobs = os.path.join(root, "artifact_jobs.json")
        with open(jobs, "w") as f:
            json.dump(list(artifacts), f)
        if on_card:
            first = batches[0]
            cache = os.path.join(root, "build")
            for name, mode in (("first_build", "build"), ("built", "no_nvcc")):
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-c", "import sys, chip_smoke; "
                     "chip_smoke._granule_fresh_process(sys.argv[1], sys.argv[2], "
                     "sys.argv[3], sys.argv[4:])", cache, mode,
                     jobs if name == "built" and artifacts else "-", *base,
                     f"train.batch_size={first}"],
                    cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                    text=True, timeout=600)
                wall = time.perf_counter() - t0
                check(proc.returncode == 0, f"granule in a fresh interpreter ({name}): exit "
                      f"{proc.returncode}\n{proc.stderr[-3000:]}")
                rec = json.loads(proc.stdout.strip().splitlines()[-1])
                check(rec["done"] == 1, f"fresh interpreter ({name}): {rec['done']} granules")
                with GeoTiffReader(pred_path) as r:
                    f_pred = r.read(1)
                f_agree = float((f_pred == plain)[decided].mean())
                check(bool((f_pred[nodata] == -1).all()) and f_agree >= ARGMAX_AGREEMENT,
                      f"fresh interpreter ({name}): nodata or kernel vs plain {f_agree}")
                check(rec["lib"].startswith(cache) and os.path.exists(rec["lib"])
                      and sorted(rec["build_s"]) == ([] if name == "built"
                                                     else ["flash_attn_fwd_sm90"])
                      and rec["lib"] == fresh.get("first_build", rec)["lib"],
                      f"fresh interpreter ({name}): kernel builds {rec['build_s']}, "
                      f"library {rec['lib']} (the compile cache {cache})")
                rec.update(process_wall_s=wall, agreement=f_agree,
                           granule_wall_s=rec["decode_s"] + rec["file_s"])
                if rec["artifacts"] is not None:
                    art_rec = dict(rec.pop("artifacts"), process_s=wall)
                fresh[name] = rec
                print(f"[granule] a fresh interpreter at batch {first} ({name}): process "
                      f"{wall:.3f} s, decode {rec['decode_s']:.3f} s, to the device "
                      f"{rec['h2d_s']:.3f} s, device {rec['device_s']:.3f} s, of it the first "
                      f"batch {rec['first_batch_s']:.3f} s (kernel builds "
                      f"{json.dumps(rec['build_s'])}), granule wall "
                      f"{rec['granule_wall_s']:.3f} s ({n / rec['granule_wall_s']:.2f} "
                      f"chips/s); kernel vs plain {f_agree:.6f}"
                      + (f"; before it, the earlier phases' {len(artifacts)} export artifacts "
                         f"in {rec['process_s'] - rec['granule_process_s']:.3f} s"
                         if name == "built" and artifacts else ""), flush=True)
            clock.lap("fresh interpreters")
        if artifacts and art_rec is None:
            art_rec = _artifact_fresh(list(artifacts), root)
        del model
        if on_card:
            torch.cuda.empty_cache()
        return dict(runs=runs, stitched_pixels=stitched, agreement=agreement,
                    decided=float(decided.mean()), overlap=dict(
                        chips=len(o_coords), launches=o_counts, device_s=o_stats["device_s"],
                        agreement=o_agree, decided=float(o_decided.mean())),
                    fresh=fresh, bands=bands, fmask=fmask, artifacts=art_rec)
    finally:
        tmp.cleanup()


def chip_ops_phase(device, bands: np.ndarray, fmask: np.ndarray, chip: int = 256,
                   n_points: int = 50_000, dense_points: int = 5_000, seed: int = 9) -> dict:
    """``process_tile_chips`` on the granule's tile: the full ``chip``-px grid
    (14 x 14 chips at 3660 px), Fmask cloud and cloud-shadow masking with
    each strategy, ``window_size`` 1, ``n_points`` labelled points of which
    ``dense_points`` fall in one chip, which then takes a power-of-two
    bucket of its own. The device's results (chips, seg maps, validity)
    must equal the CPU's bit for bit and dtype for dtype, also under
    ``torch.use_deterministic_algorithms(True)``. Reports ms on each."""
    import torch

    from instageo_tpu_torch.ops.chip_ops import process_tile_chips

    side = bands.shape[-1] // chip
    coords = np.asarray([[x, y] for y in range(side) for x in range(side)], np.int32)
    rng = np.random.default_rng(seed)
    dense_at = (side // 3, side // 2)  # (row, col) on the chip grid
    rc = np.concatenate([rng.integers(0, side * chip, (n_points - dense_points, 2)),
                         rng.integers(0, chip, (dense_points, 2)) + np.asarray(dense_at) * chip])
    rc = rc[rng.permutation(len(rc))]
    owner = (rc[:, 0] // chip) * side + rc[:, 1] // chip
    labels = rng.integers(0, 13, len(rc)).astype(np.float32)
    per_chip = np.bincount(owner, minlength=len(coords))
    check(int((per_chip > 512).sum()) == 1, f"{int((per_chip > 512).sum())} dense chips")
    args = (bands, fmask, coords, rc, labels, owner)
    cpu = torch.device("cpu")
    out = {}
    for strategy in ("each", "any"):
        kw = dict(chip_size=chip, no_data_value=0, data_source="HLS",
                  mask_types=("cloud", "cloud_shadow"), masking_strategy=strategy,
                  window_size=1)
        ms = {}
        for name, dev, reps in (("device", device, 2), ("cpu", cpu, 1)):
            for _ in range(reps):  # the device's first call loads its kernels
                t0 = time.perf_counter()
                res = process_tile_chips(*args, device=dev, **kw)
                ms[name] = (time.perf_counter() - t0) * 1e3
            out.setdefault(strategy, {})[name] = res
        for got, ref, what in zip(out[strategy]["device"], out[strategy]["cpu"],
                                  ("chips", "seg maps", "chip validity", "seg validity")):
            check(got.dtype == ref.dtype and np.array_equal(got, ref),
                  f"chip_ops {strategy}: {what} on the device differ from the CPU's "
                  f"({got.dtype} vs {ref.dtype})")
        chips, segs, cv, sv = out[strategy]["cpu"]
        print(f"[chip_ops] {strategy}: {len(coords)} chips of {chip} px ({chips.dtype}), "
              f"{len(rc)} points (one chip of {per_chip.max()}), seg maps {segs.dtype} with "
              f"{int((segs != -1).sum())} labelled px, {int(cv.sum())} chips with data, "
              f"{int(sv.sum())} with labels; device = CPU bit for bit; "
              f"{ms['device']:.1f} ms on {device.type}, {ms['cpu']:.1f} ms on the CPU",
              flush=True)
        out[strategy]["ms"] = ms
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = process_tile_chips(*args, device=device, chip_size=chip, no_data_value=0,
                                 mask_types=("cloud", "cloud_shadow"), window_size=1)
    finally:
        torch.use_deterministic_algorithms(prev)
    for got, ref in zip(det, out["each"]["cpu"]):
        check(np.array_equal(got, ref), "chip_ops under deterministic mode differ")
    print("[chip_ops] under torch.use_deterministic_algorithms(True): equal", flush=True)
    return {s: out[s]["ms"] for s in ("each", "any")}


# The chip creator phase: observations over the granule tile, dated so that
# the three temporal steps (5 days apart, ±2 days) pick the three granules.
OBS_POINTS = 5_000
OBS_DATE = "2023-06-16"
CHIP_CREATOR_FLAGS = ["--data_source=HLS", "--chip_size=224", "--mask_types=cloud",
                      "--min_count=1", "--temporal_step=5", "--num_steps=3",
                      "--temporal_tolerance=2", "--noshift_to_month_start"]
RASTER_FLAGS = ["--is_bbox_feature=true", "--date=2023-06-11", "--data_source=HLS",
                "--chip_size=224", "--num_steps=3", "--temporal_step=5",
                "--temporal_tolerance=2", "--mask_types=cloud"]


def _tree(root: str) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def _same_trees(a: str, b: str, what: str, relative_csv: str = "") -> int:
    """The two output trees hold the same files with the same bytes (the
    CSV ``relative_csv``, whose paths are absolute, compared with each
    tree's root taken out). Returns the file count."""
    ta, tb = _tree(a), _tree(b)
    check(sorted(ta) == sorted(tb), f"{what}: files differ: "
          f"{sorted(set(ta) ^ set(tb))[:5]}")
    for rel in ta:
        x, y = ta[rel], tb[rel]
        if rel == relative_csv:
            x, y = x.replace(a.encode(), b""), y.replace(b.encode(), b"")
        check(x == y, f"{what}: {rel} differs between the card and the CPU")
    return len(ta)


def chip_creator_phase(device, smi: str, size: int = GRANULE_SIZE, block=GRANULE_BLOCK,
                       n_points: int = OBS_POINTS, chip: int = 224, extra=(),
                       raster_px=(1400, 600, 2500, 1500), seed: int = 12,
                       keep: str = "") -> dict:
    """Observations to chips to predictions on the card, through the entry
    points a user calls. On the granule tile (T=3 HLS granules of
    ``size``² px, written again here) with STAC items of them (the search
    answers with them: no network), an observations CSV of ``n_points``
    points from ``seed`` in EPSG:4326 with labels 0/1:

    1. ``python -m instageo_tpu_torch.data.chip_creator`` (``main``, in
       process) with ``CHIP_CREATOR_FLAGS`` on the card, then on the CPU
       (the granules selected and the tile decoded once, by the card run;
       the CPU run's chip math gets copies of the same selections and
       arrays) with the observations as Parquet (``--data_format=parquet``,
       the file written from the CSV's records by ``data/parquet.py``):
       every file equal byte for byte, the Parquet records caches included
       (Parquet input = CSV input); the whole grid of
       ``chip``-px chips written (18 bands, uint16), each chip equal to the tile's pixels in
       the selected granules' order with the cloud bit's pixels 0, each seg
       map's singly-labelled pixels equal to the points' labels; the chip
       creation launches no kernel; wall, decode and ``process_tile_chips``
       seconds (CUDA events on the card), peak device memory;
    2. the card run's manifest through the run CLI's ``mode=chip_inference``
       (crop config, random weights from seed 0 in a checkpoint): one
       prediction per chip, 12 forward launches per chip batch on wgmma,
       none on mma.sync;
    3. ``raster_chip_creator`` with ``--is_bbox_feature=true`` over the bbox of
       the tile's pixels ``raster_px`` (col0, row0, col1, row1), on the card,
       then on the CPU resuming from a copy of the card run's
       ``hls_dataset.json`` and ``filtered_raster_records.parquet`` with the
       STAC search raising: the same files (the manifest's absolute paths
       aside), the grid chips written, no search on resume, wall seconds;
    4. ``tests/torch_fixtures/observations.parquet`` (written by pandas:
       Snappy, dictionaries, a ``time`` column, a null, a ``list<double>``)
       read by ``data/parquet.py`` equal to its expected records.

    ``extra``: run-CLI overrides (a CPU rehearsal's tiny model). ``keep``: a
    directory that gets the card run's output directory (``points``) and the
    observations CSV, for the data_prep phase."""
    os.environ.setdefault("INSTAGEO_COG_RATELIMIT", "1000")
    import copy
    import csv
    import shutil

    import torch

    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.data import chip_creator, pipeline, raster_chip_creator, stac
    from instageo_tpu_torch.data.crs import utm_to_latlon
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.data.parquet import read_table, write_records
    from instageo_tpu_torch.data.settings import DATA_PIPELINE_SETTINGS
    from instageo_tpu_torch.data.sources import hls
    from instageo_tpu_torch.data.table import read_csv
    from instageo_tpu_torch.train import run
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import create_model

    check(DATA_PIPELINE_SETTINGS.COG_DOWNLOAD_RATELIMIT >= 100,
          f"asset loads limited to {DATA_PIPELINE_SETTINGS.COG_DOWNLOAD_RATELIMIT} a minute")
    on_card = device.type == "cuda"
    cpu = torch.device("cpu")
    clock = Clock("chip_creator")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    try:
        json_path, bands, fmask, transform = _write_granule(root, size, block)
        with open(json_path) as f:
            granules = next(iter(json.load(f).values()))["granules"]
        # The items' footprint: the tile's corners in EPSG:4326.
        x0, y0 = transform * (0, 0)
        x1, y1 = transform * (size, size)
        lat, lon = utm_to_latlon(np.asarray([x0, x1, x0, x1]), np.asarray([y0, y0, y1, y1]),
                                 33, False)
        for g in granules:
            g["bbox"] = [float(lon.min()), float(lat.min()), float(lon.max()), float(lat.max())]
        rng = np.random.default_rng(seed)
        px = rng.uniform(0, size, (n_points, 2))
        plat, plon = utm_to_latlon(x0 + px[:, 0] * 30.0, y0 - px[:, 1] * 30.0, 33, False)
        labels = rng.integers(0, 2, n_points)
        obs = os.path.join(root, "observations.csv")
        with open(obs, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "y", "label", "date"])
            w.writerows((repr(float(a)), repr(float(b)), int(c), OBS_DATE)
                        for a, b, c in zip(plon, plat, labels))
        # The CPU run reads the same observations from Parquet.
        obs_parquet = os.path.join(root, "observations.parquet")
        write_records(obs_parquet, read_csv(obs)[0])
        obs_args = {"card": [f"--dataframe_path={obs}"],
                    "cpu": [f"--dataframe_path={obs_parquet}", "--data_format=parquet"]}
        clock.lap(f"wrote the tile and {n_points} observations (CSV and Parquet)")

        rec = {}
        opener, chip_fn = hls.open_hls_stac_items, pipeline.process_tile_chips
        search_fn, writer = hls.add_hls_stac_items, pipeline.write_geotiff

        def timed(fn, key):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                rec.setdefault(key, []).append(time.perf_counter() - t0)
                return out
            return wrapped

        def timed_chips(*a, **k):
            on = torch.device(k["device"]).type == "cuda"
            if on:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = chip_fn(*a, **k)
            if on:
                end.record()
                end.synchronize()
            rec.setdefault("chips_s", []).append(
                start.elapsed_time(end) / 1e3 if on else time.perf_counter() - t0)
            return out

        # The tile is decoded and the granules selected once, by the card
        # run; the CPU run, which holds the chip math on the other device,
        # gets copies of the card run's arrays and selections.
        tiles, selections, point_run = {}, [], {"name": None}

        def selected(*a, **k):
            if point_run["name"] == "cpu":
                rec["selection_reused"] = rec.get("selection_reused", 0) + 1
                return copy.deepcopy(selections[rec["selection_reused"] - 1])
            got = search_fn(*a, **k)
            if point_run["name"] == "card":
                selections.append(copy.deepcopy(got))
            return got

        def opened(tile_dict, *a, **k):
            key = (tuple(g["id"] if isinstance(g, dict) else g.id
                         for g in tile_dict["granules"]), a, tuple(sorted(k.items())))
            if point_run["name"] == "cpu":
                rec["decode_reused"] = rec.get("decode_reused", 0) + 1
                return tuple(v.copy() if isinstance(v, np.ndarray) else v for v in tiles[key])
            got = opener(tile_dict, *a, **k)
            if point_run["name"] == "card":
                tiles[key] = got
            return got

        search = lambda self, **kw: [stac.StacItem.from_dict(copy.deepcopy(g))  # noqa: E731
                                     for g in granules]
        out, runs = {}, {}
        with mock.patch.object(stac.StacClient, "search", search), \
                mock.patch.object(hls, "open_hls_stac_items", timed(opened, "decode_s")), \
                mock.patch.object(pipeline, "process_tile_chips", timed_chips), \
                mock.patch.object(pipeline, "write_geotiff", timed(writer, "write_s")), \
                mock.patch.dict(chip_creator.DATA_SOURCE_CONFIG["HLS"],
                                add_stac_items_func=timed(selected, "stac_s")):
            for name, dev in (("card", device), ("cpu", cpu)):
                out[name] = os.path.join(root, f"points_{name}")
                rec.clear()
                point_run["name"] = name
                # --- chip creation: counts from 0, read right after ---------
                reset_counts()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                chip_creator.main([*obs_args[name], f"--output_directory={out[name]}",
                                   *CHIP_CREATOR_FLAGS, f"--device={dev.type}"])
                wall = time.perf_counter() - t0
                counts = read_counts()
                # ---------------------------------------------------------------
                check(not any(counts.values()), f"chip creation launched {counts}")
                check(len(rec.get("decode_s", [])) == 1 and len(rec.get("chips_s", [])) == 1
                      and rec.get("decode_reused", 0) == (name == "cpu")
                      and rec.get("selection_reused", 0) == (len(selections)
                                                             if name == "cpu" else 0),
                      f"{name}: tile loads {rec}")
                runs[name] = dict(wall_s=wall, stac_s=rec["stac_s"][0],
                                  decode_s=rec["decode_s"][0],
                                  decode_reused=bool(rec.get("decode_reused")),
                                  process_tile_chips_s=rec["chips_s"][0],
                                  write_s=sum(rec["write_s"]),
                                  peak_device_bytes=torch.cuda.max_memory_allocated()
                                  if dev.type == "cuda" else None)
                clock.lap(f"chip_creator --device={dev.type}")
            point_run["name"] = None
            tiles.clear()
            selections.clear()
            files = _same_trees(out["card"], out["cpu"], "chip_creator")
            check(os.path.exists(os.path.join(out["cpu"], chip_creator.RECORDS_CACHE)),
                  f"no {chip_creator.RECORDS_CACHE}")
            clock.lap("compared")

            # --- what came out -------------------------------------------------
            side = size // chip
            with open(os.path.join(out["card"], "hls_dataset.csv"), newline="") as f:
                manifest = list(csv.DictReader(f))
            with open(os.path.join(out["card"], "hls_dataset.json")) as f:
                dataset = json.load(f)
            order = [list(GRANULE_IDS).index(g["id"]) for g in
                     next(iter(dataset.values()))["granules"]]
            check(len(dataset) == 1 and order == [2, 1, 0],
                  f"granule sets {list(dataset)}: each step must pick its granule")
            check(len(manifest) == side * side, f"{len(manifest)} chips of a {side}² grid")
            with open(os.path.join(out["card"], "processed_tiles.json")) as f:
                check(json.load(f) == list(dataset), "processed_tiles.json")
            cloud = (fmask[order] // 2) % 2 == 1  # (T, H, W), the chips' step order
            ref_bands = bands.reshape(3, 6, size, size)[order]
            pcol, prow = np.floor(px[:, 0]).astype(int), np.floor(px[:, 1]).astype(int)
            # A point within 1e-6 px of a pixel edge may land on either side
            # after the trip through EPSG:4326: its cells are not checked.
            edge = (np.minimum(px % 1, 1 - px % 1) < 1e-6).any(axis=1)
            unsure = {(r + dr, c + dc) for r, c in zip(prow[edge], pcol[edge])
                      for dr in (-1, 0, 1) for dc in (-1, 0, 1)}
            probe = [(0, 0), (side - 1, side - 1), (block[1] // chip, block[0] // chip),
                     (side // 2, 3)]
            for cx, cy in probe:
                name = next(r for r in manifest if r["Input"].endswith(f"_{cx}_{cy}.tif"))
                with GeoTiffReader(os.path.join(out["card"], name["Input"])) as r:
                    got = r.read()
                sl = np.s_[cy * chip:(cy + 1) * chip, cx * chip:(cx + 1) * chip]
                want = np.where(cloud[:, None][(slice(None), slice(None)) + sl], 0,
                                ref_bands[(slice(None), slice(None)) + sl]).reshape(18, chip, chip)
                check(got.dtype == np.uint16 and np.array_equal(got, want),
                      f"chip ({cx}, {cy}) differs from the tile's masked pixels")
                with GeoTiffReader(os.path.join(out["card"], name["Label"])) as r:
                    seg = r.read(1)
                inside = (pcol // chip == cx) & (prow // chip == cy)
                cells = {}
                for rr, cc, lab in zip(prow[inside], pcol[inside], labels[inside]):
                    cells.setdefault((rr, cc), set()).add(int(lab))
                single = [((rr - cy * chip, cc - cx * chip), v.pop())
                          for (rr, cc), v in cells.items() if len(v) == 1 and (rr, cc) not in unsure]
                has_data = (got != 0).any(axis=0)
                check(seg.dtype == np.int16 and all(
                    seg[k] == (v if has_data[k] else -1) for k, v in single),
                    f"seg map ({cx}, {cy}) differs from the points' labels")
                check(int((seg != -1).sum()) <= len(cells), f"seg map ({cx}, {cy}) labels "
                      f"{int((seg != -1).sum())} px for {len(cells)} points")
            print(f"[chip_creator] {n_points} points, {size}² px tile, T=3: {len(manifest)} "
                  f"chips of 18x{chip}x{chip} and as many seg maps, {files} files, card (CSV "
                  f"observations) = CPU (Parquet observations) byte for byte, "
                  f"{chip_creator.RECORDS_CACHE} included; chips {probe} = the tile's pixels "
                  f"with the cloud bit 0; launches during chip creation 0", flush=True)
            for name, r in runs.items():
                copied = " (a copy of the card run's)" if r["decode_reused"] else ""
                print(f"[chip_creator] --device={'cuda' if name == 'card' else 'cpu'}: wall "
                      f"{r['wall_s']:.3f} s: STAC search and selection {r['stac_s']:.3f} s"
                      f"{copied}, decode {r['decode_s']:.3f} s{copied}, process_tile_chips "
                      f"{r['process_tile_chips_s']:.3f} s "
                      f"({'CUDA events' if on_card and name == 'card' else 'host clock'}), GeoTIFF writes "
                      f"{r['write_s']:.3f} s; peak device memory {r['peak_device_bytes']} B",
                      flush=True)

            # --- the chain: the manifest through mode=chip_inference -----------
            base = [f"--config-name={CROP_CONFIG}", f"root_dir={out['card']}",
                    f"test_filepath={os.path.join(out['card'], 'hls_dataset.csv')}",
                    "model.load_pretrained_weights=False", "mode=chip_inference", *extra]
            if not on_card:
                base.append("device=cpu")
            cfg = load_config_from_argv(base)
            model = create_model(cfg, seed=0, device=device)
            ckpt = BestCheckpointer(os.path.join(root, "run")).save({"model": model.state_dict()})
            depth, classes = len(model.prithvi_encoder.blocks), int(cfg.model.num_classes)
            batch = int(cfg.train.batch_size)
            del model
            # --- one run of the CLI: counts from 0, read right after ----------
            reset_counts()
            t0 = time.perf_counter()
            n = run.main(base + [f"checkpoint_path={ckpt}"])
            if on_card:
                torch.cuda.synchronize()
            infer_wall = time.perf_counter() - t0
            infer_counts = read_counts()
            # -------------------------------------------------------------------
            preds = sorted(os.listdir(os.path.join(out["card"], "predictions")))
            check(n == len(manifest) == len(preds), f"chip_inference: {n} served, "
                  f"{len(preds)} predictions for {len(manifest)} chips")
            for p in preds[:: max(1, len(preds) // 8)]:
                with GeoTiffReader(os.path.join(out["card"], "predictions", p)) as r:
                    pred = r.read(1)
                check(pred.dtype == np.int8 and bool(((pred >= 0) & (pred < classes)).all()),
                      f"prediction {p}: {pred.dtype}, classes {np.unique(pred)[:8]}")
            want = {"flash_attn_fwd": depth * -(-n // batch), "flash_attn_fwd_mma": 0,
                    "flash_attn_bwd": 0, "flash_attn_bwd_mma": 0, "fused_dropout": 0}
            if on_card:
                check(infer_counts == want, f"chip_inference launches {infer_counts}, "
                      f"expected {want}")
            print(f"[chip_creator] mode=chip_inference over the card run's manifest: {n} "
                  f"predictions in {infer_wall:.3f} s wall ({n / infer_wall:.2f} chips/s) at "
                  f"batch {batch}; launches {json.dumps(infer_counts)} ({depth} per chip "
                  f"batch)", flush=True)
            clock.lap("chip_inference")

            # --- the raster chip creator over a bbox in the tile ---------------
            c0, r0, c1, r1 = raster_px
            bx = x0 + np.asarray([c0, c1, c0, c1]) * 30.0
            by = y0 - np.asarray([r0, r0, r1, r1]) * 30.0
            blat, blon = utm_to_latlon(bx, by, 33, False)
            bbox_path = os.path.join(root, "bounding_boxes.json")
            with open(bbox_path, "w") as f:
                json.dump({"bboxes": [[float(blon.min()), float(blat.min()),
                                       float(blon.max()), float(blat.max())]]}, f)
            # The CPU run resumes from the card run's search results: its
            # dataset JSON and Parquet records, with the search raising.
            raster, searched = {}, []

            def no_search(self, **kw):
                searched.append(kw)
                raise AssertionError("the raster chip creator searched on resume")

            for name, dev in (("card", device), ("cpu", cpu)):
                d = os.path.join(root, f"raster_{name}")
                if name == "cpu":
                    os.makedirs(d)
                    for f in ("hls_dataset.json", raster_chip_creator.RECORDS_CACHE):
                        shutil.copy(os.path.join(raster["card"]["dir"], f), d)
                reset_counts()
                t0 = time.perf_counter()
                with mock.patch.object(stac.StacClient, "search",
                                       no_search if name == "cpu" else search):
                    raster_chip_creator.main([f"--bbox_feature_path={bbox_path}",
                                              f"--output_directory={d}", *RASTER_FLAGS,
                                              f"--device={dev.type}"])
                raster[name] = dict(dir=d, wall_s=time.perf_counter() - t0)
                check(not any(read_counts().values()), "raster chip creation launched kernels")
                clock.lap(f"raster_chip_creator --device={dev.type}")
            check(not searched, f"the raster resume searched {len(searched)} times")
        rfiles = _same_trees(raster["card"]["dir"], raster["cpu"]["dir"], "raster_chip_creator",
                             relative_csv="hls_raster_dataset.csv")
        with open(os.path.join(raster["card"]["dir"], "hls_raster_dataset.csv"),
                  newline="") as f:
            grid = list(csv.DictReader(f))
        check(len(grid) > 0 and all(os.path.exists(g["Input"]) for g in grid),
              f"raster manifest {len(grid)} rows")
        for g in grid[:4]:
            with GeoTiffReader(g["Input"]) as r:
                check((r.count, r.height, r.width) == (18, chip, chip)
                      and r.dtypes[0] == "uint16", f"raster chip {g['Input']}")
        print(f"[chip_creator] raster_chip_creator --is_bbox_feature=true: {len(grid)} grid "
              f"chips of 18x{chip}x{chip}, {rfiles} files, card = CPU (resumed from the card "
              f"run's {raster_chip_creator.RECORDS_CACHE}, no search) byte for byte; wall "
              f"{raster['card']['wall_s']:.3f} s on the card, {raster['cpu']['wall_s']:.3f} s "
              f"on the CPU", flush=True)

        # --- a pandas-written Parquet file, read without pyarrow ---------------
        fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                               "torch_fixtures", "observations")
        t0 = time.perf_counter()
        rows = read_table(fixture + ".parquet")
        fixture_s = time.perf_counter() - t0
        with open(fixture + ".json") as f:
            expected = json.load(f)
        check(json.loads(json.dumps(rows, default=str)) == expected,
              "tests/torch_fixtures/observations.parquet reads as other records than its JSON")
        print(f"[chip_creator] tests/torch_fixtures/observations.parquet (pandas, Snappy, "
              f"dictionaries): {len(rows)} rows of {list(rows[0])} equal to its JSON, read in "
              f"{fixture_s:.4f} s", flush=True)
        if keep:
            os.replace(out["card"], os.path.join(keep, "points"))
            os.replace(obs, os.path.join(keep, "observations.csv"))
        return dict(runs=runs, chips=len(manifest), files=files,
                    chip_inference=dict(chips=n, wall_s=infer_wall, launches=infer_counts,
                                        batch=batch),
                    raster=dict(chips=len(grid), files=rfiles,
                                wall_s={k: v["wall_s"] for k, v in raster.items()}))
    finally:
        tmp.cleanup()


LIMIT_CHIPS = 32  # seg maps the limit cleaning reads (each against every observation)


def data_prep_phase(device, smi: str, kept: str, limit_chips: int = LIMIT_CHIPS) -> dict:
    """The data-preparation tools on the host, as a user runs them after the
    chip creator (``kept``: the chip_creator phase's card output directory
    ``points`` and its ``observations.csv``):

    1. ``python -m instageo_tpu_torch.data.data_cleaner`` (``main``, in
       process) over the chip manifest with ``--drop_chips`` (strategy
       ``all``: a pixel is no-data where every band is 0, as in the tile's
       nodata block; cloud-masked bands are 0 too) and the ``buffer``
       cleaning, then the ``limit`` cleaning over the first
       ``limit_chips`` rows with the observations (their MGRS tile given);
    2. ``python -m instageo_tpu_torch.data.data_splitter`` over the cleaned
       CSV with its defaults (KMeans over the tile centres);
    3. whether ``libopenjp2`` loads here, and the committed JP2 fixture
       decoded equal to its stored array where it does;
    4. whether matplotlib is here; where it is, the regression plot
       written, else the refusal naming it.
    (The compile cache is held by the granule phase's two fresh
    interpreters.)

    Wall seconds for each."""
    import csv

    from instageo_tpu_torch.data import data_cleaner, data_splitter, jp2
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.train import plots

    on_card = device.type == "cuda"
    clock = Clock("data_prep")
    out = {}
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    points = os.path.join(kept, "points")
    try:
        # --- 1. the cleaner ---------------------------------------------------
        with open(os.path.join(points, "hls_dataset.csv"), newline="") as f:
            manifest = list(csv.DictReader(f))
        dataset = os.path.join(root, "dataset.csv")
        with open(dataset, "w", newline="") as f:
            w = csv.DictWriter(f, ["Input", "Label"])
            w.writeheader()
            w.writerows({k: os.path.join(points, r[k]) for k in ("Input", "Label")}
                        for r in manifest)
        cleaned = os.path.join(root, "clean.csv")
        t0 = time.perf_counter()
        data_cleaner.main([f"--chips_dataset_csv={dataset}",
                           f"--output_chips_dataset_csv={cleaned}",
                           "--drop_chips", "--drop_chips_strategy=all", "--no_data_value=0",
                           "--no_data_threshold=0.5",
                           "--clean_seg_maps", "--cleaning_method=buffer", "--window_size=1",
                           f"--seg_map_output_dir={root}/buffered"])
        buffer_s = time.perf_counter() - t0
        with open(cleaned, newline="") as f:
            kept_rows = list(csv.DictReader(f))
        check(0 < len(kept_rows) <= len(manifest), f"cleaner kept {len(kept_rows)} rows of "
              f"{len(manifest)}")
        first = kept_rows[0]["Label"]
        with GeoTiffReader(first) as r:
            grown = int((r.read(1) != -1).sum())
        with GeoTiffReader(os.path.join(points, "seg_maps", os.path.basename(first))) as r:
            labelled = int((r.read(1) != -1).sum())
        check(grown >= labelled > 0, f"buffer: {grown} labelled pixels from {labelled}")

        with open(os.path.join(kept, "observations.csv"), newline="") as f:
            obs = list(csv.DictReader(f))
        tile = manifest[0]["Input"].split("_T", 1)[1][:5]
        obs_csv = os.path.join(root, "observations_tiled.csv")
        with open(obs_csv, "w", newline="") as f:
            w = csv.DictWriter(f, ["x", "y", "date", "mgrs_tile_id"])
            w.writeheader()
            w.writerows({"x": o["x"], "y": o["y"], "date": o["date"], "mgrs_tile_id": tile}
                        for o in obs)
        limit_chips = min(limit_chips, len(manifest))
        subset = os.path.join(root, "subset.csv")
        with open(dataset) as f, open(subset, "w") as g:
            g.writelines(f.readlines()[:limit_chips + 1])
        limited = os.path.join(root, "limited.csv")
        t0 = time.perf_counter()
        data_cleaner.main([f"--chips_dataset_csv={subset}",
                           f"--output_chips_dataset_csv={limited}", "--clean_seg_maps",
                           "--cleaning_method=limit", f"--observation_points_csv={obs_csv}",
                           f"--seg_map_output_dir={root}/limited"])
        limit_s = time.perf_counter() - t0
        with open(limited, newline="") as f:
            limited_rows = list(csv.DictReader(f))
        check(len(limited_rows) == limit_chips, f"limit kept {len(limited_rows)} of {limit_chips}")
        out["cleaner"] = dict(chips=len(manifest), kept=len(kept_rows), buffer_s=buffer_s,
                              limit_chips=limit_chips, limit_s=limit_s, points=len(obs))
        print(f"[data_prep] data_cleaner --drop_chips --cleaning_method=buffer: "
              f"{len(kept_rows)} of {len(manifest)} chips kept in {buffer_s:.3f} s; "
              f"--cleaning_method=limit over {limit_chips} seg maps and {len(obs)} points in "
              f"{limit_s:.3f} s", flush=True)
        clock.lap("cleaner")

        # --- 2. the splitter --------------------------------------------------
        t0 = time.perf_counter()
        data_splitter.main([f"--input_file={cleaned}", f"--output_dir={root}/splits"])
        split_s = time.perf_counter() - t0
        counts = {}
        for name in ("train", "val", "test"):
            with open(os.path.join(root, "splits", f"{name}.csv"), newline="") as f:
                counts[name] = len(list(csv.DictReader(f)))
        check(sum(counts.values()) == len(kept_rows), f"splits {counts} of {len(kept_rows)}")
        out["splitter"] = dict(counts=counts, split_s=split_s)
        print(f"[data_prep] data_splitter (KMeans): {counts} in {split_s:.3f} s", flush=True)
        clock.lap("splitter")

        # --- 3. JPEG 2000 through libopenjp2 ---------------------------------
        fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                "torch_fixtures")
        try:
            jp2.library()
            reason = ""
        except OSError as e:
            reason = str(e)
        if not reason:
            got = jp2.read_jp2(os.path.join(fixtures, "s2_band.jp2"))
            want = np.load(os.path.join(fixtures, "s2_band.npy"))
            check(got.dtype == want.dtype and np.array_equal(got, want),
                  "the JP2 fixture decodes to another array")
        out["libopenjp2"] = dict(loads=not reason, reason=reason)
        print(f"[data_prep] libopenjp2: " + ("loads; the JP2 fixture decodes equal to its "
                                             "stored array" if not reason else
                                             f"does not load here: {reason}"), flush=True)

        # --- 4. matplotlib and the regression plot ----------------------------
        try:
            import matplotlib  # noqa: F401
            present = True
        except ImportError:
            present = False
        plot = os.path.join(root, "regression_test.png")
        if present:
            r = np.random.default_rng(5)
            labels = r.uniform(0, 10, 1000)
            plots.create_regression_plot(labels + r.normal(0, 1, 1000), labels,
                                         {"test_RMSE": 1.0}, plot, "test")
            with open(plot, "rb") as f:
                check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the regression plot is not a PNG")
        else:
            try:
                plots.require_matplotlib()
                refused = ""
            except ImportError as e:
                refused = str(e)
            check("matplotlib" in refused, "no matplotlib, and the plot was not refused")
        out["matplotlib"] = present
        print(f"[data_prep] matplotlib: " + ("present; the regression plot written"
                                             if present else "missing; model.plot_reg_results "
                                             "is refused naming it"), flush=True)
        clock.lap("jp2 and plot")

        return out
    finally:
        tmp.cleanup()


# --- the web platform ----------------------------------------------------------
WEB_BBOX_PX = (600, 600, 2400, 2400)  # col0, row0, col1, row1: holds the nodata block
WEB_MODEL = "prithvi_eo_v2_300"       # the shipped registry's crop_classification, base
WEB_POST = {"model_key": "crop_classification", "date": "2023-06-11", "temporal_step": 5,
            "temporal_tolerance": 2, "parameters": {"mask_types": ["cloud"]}}
WEB_ZOOMS = (10, 11, 12)
WEB_CLIENTS = 8
WEB_TASK_TIMEOUT_S = 480.0
# Read by this script when the web phase's workers and job processes import
# it (as ``__mp_main__``, the spawn start method's name for the parent's
# main module): the STAC items the search answers with, and where each job
# process writes its record.
STAC_ITEMS_ENV = "INSTAGEO_SMOKE_STAC_ITEMS"
JOB_RECORDS_ENV = "INSTAGEO_SMOKE_JOB_RECORDS"


def _install_webapp_hooks() -> None:
    """In a process that the web phase's queue workers spawn: the STAC search
    answers with the phase's items (no network), and each job records, in
    ``$INSTAGEO_SMOKE_JOB_RECORDS/<job id>.json``, when this hook ran, the
    seconds of ``import torch``, of the CUDA context and (the model stage) of
    ``import torch._dynamo``, which the job pays anyway, timed here one
    after the other before it runs, then the job's seconds and the
    process's kernel launches."""
    hook_at = time.time()
    import copy

    from instageo_tpu_torch.data import stac
    from instageo_tpu_torch.webapp import queue

    with open(os.environ[STAC_ITEMS_ENV]) as f:
        items = json.load(f)
    stac.StacClient.search = lambda self, **kw: [stac.StacItem.from_dict(copy.deepcopy(g))
                                                 for g in items]
    run_job = queue.run_job

    def recorded(job, db_path=None):
        func = job["func"].split(":")[1]
        rec = dict(func=func, hook_at=hook_at)
        if func != "process_visualization_preparation_with_task":
            t0 = time.perf_counter()
            import torch
            rec["import_torch_s"] = time.perf_counter() - t0
            if os.environ.get("INSTAGEO_DEVICE", "cuda") == "cuda":
                t0 = time.perf_counter()
                torch.cuda.init()
                torch.empty(1, device="cuda")
                torch.cuda.synchronize()
                rec["cuda_context_s"] = time.perf_counter() - t0
        if func == "process_model_prediction_with_task":
            t0 = time.perf_counter()
            import torch._dynamo  # noqa: F401
            rec["dynamo_import_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = run_job(job, db_path)
        rec.update(job_s=time.perf_counter() - t0, ok=ok)
        if "instageo_tpu_torch.ops.attention" in sys.modules:
            rec["launches"] = read_counts()
        path = os.path.join(os.environ[JOB_RECORDS_ENV], f"{job['job_id']}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
        return ok

    queue.run_job = recorded


if __name__ == "__mp_main__" and os.environ.get(STAC_ITEMS_ENV):
    _install_webapp_hooks()


# The web phase's deployment: the compose file whose services it starts.
COMPOSE_FILE = "instageo_tpu_torch/deploy/docker-compose.yml"
# The web platform's environment names, which a service's own environment
# sets: taken out of what the phase's processes inherit from this one.
WEB_ENV_NAMES = ("DATABASE_URL", "TASKS_DATA_DIR", "MODELS_PATH", "MODELS_REGISTRY_PATH",
                 "AUTH0_DOMAIN", "AUTH0_AUDIENCE", "AUTH0_CLIENT_ID", "API_BASE_URL",
                 "AUTH_DISABLED", "TESTING", "INSTAGEO_DEVICE", "INSTAGEO_NO_WORKERS", "PORT")
# Imported at the start of every process of the deployed topology (the
# backend, the workers and the job processes they spawn, which run no file
# of this repo's as their main module): the phase's hooks where its STAC
# items are named, after any other sitecustomize on the path.
SITECUSTOMIZE = """\
import importlib.machinery
import importlib.util
import os
import sys

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or os.curdir) != _here])
if _spec is not None:
    _other = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_other)
if os.environ.get({stac!r}):
    sys.path.insert(0, {repo!r})
    import chip_smoke
    chip_smoke._install_webapp_hooks()
"""


def _subst(text: str, variables: dict) -> str:
    """Compose's interpolation: ``${NAME}`` and ``${NAME:-default}`` (the
    default where NAME is unset or empty)."""
    return re.sub(r"\$\{(\w+)(?::-([^}]*))?\}",
                  lambda m: variables.get(m.group(1)) or (m.group(2) or ""), text)


def compose_services(path: str, root: str, variables: dict) -> dict:
    """The services of a compose file built from this repository, as this
    machine runs them: name -> ``argv`` (its ``command``, ``python`` this
    interpreter), ``env`` (its ``environment``, interpolated from
    ``variables``, each path under a mount point mapped to the mount's
    source), ``mounts`` (mount point -> directory: a named volume under
    ``root``, a path relative to the file's directory), ``replicas`` and
    ``gpu`` (whether it reserves an NVIDIA device). Read with the port's
    YAML reader."""
    from instageo_tpu_torch.configs.config import loads

    with open(path) as f:
        spec = loads(f.read())
    here = os.path.dirname(os.path.abspath(path))
    out = {}
    for name, svc in spec["services"].items():
        if "build" not in svc:
            continue  # nginx, cloudflared: images of their own
        mounts = {}
        for vol in svc.get("volumes", []):
            src, dst = _subst(vol, variables).split(":")[:2]
            if not src.startswith((".", "/")):
                src = os.path.join(root, src)
            mounts[dst] = os.path.normpath(os.path.join(here, src))
        env = svc.get("environment") or {}
        if isinstance(env, list):
            env = dict(e.split("=", 1) for e in env)
        env = {k: _subst(str(v), variables) for k, v in env.items()}
        for k, v in env.items():
            for dst, src in mounts.items():
                if v == dst or v.startswith(dst + "/"):
                    env[k] = src + v[len(dst):]
        argv = shlex.split(svc["command"])
        check(argv[0] == "python", f"{name}: {svc['command']}")
        deploy = svc.get("deploy") or {}
        devices = deploy.get("resources", {}).get("reservations", {}).get("devices", [])
        out[name] = dict(argv=[sys.executable] + argv[1:], env=env, mounts=mounts,
                         replicas=int(_subst(str(deploy.get("replicas", 1)), variables)),
                         gpu=any(d.get("driver") == "nvidia" for d in devices))
    return out


def _logged_port(proc, log: str, what: str, timeout: float = 60.0) -> int:
    """The port a server started with ``PORT=0`` logs ("Serving on
    http://...:<port>"), read from its log file."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        with open(log, errors="replace") as f:
            for line in f:
                if "Serving on http://" in line:
                    return int(line.rsplit(":", 1)[1])
        check(proc.poll() is None, f"{what} exited {proc.returncode}")
        time.sleep(0.1)
    raise RuntimeError(f"chip_smoke check failed: {what} logged no port in {timeout} s")


def read_png(data: bytes) -> np.ndarray:
    """A PNG file's pixels, (H, W, 4) uint8, for 8-bit RGBA non-interlaced
    images with filter type 0 on every scanline (what `webapp/png.py`
    writes): the signature, every chunk's CRC, the IHDR and the zlib stream
    of the IDAT chunks. Any other filter type fails the check."""
    import struct
    import zlib

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG signature")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(zlib.crc32(kind + body) & 0xFFFFFFFF == crc, f"PNG {kind!r} chunk CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    check(header is not None and header[2:] == (8, 6, 0, 0, 0), f"PNG header {header}")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    check(raw.size == h * (1 + 4 * w), f"PNG data {raw.size} B for {w}x{h}")
    rows = raw.reshape(h, 1 + 4 * w)
    filters = set(rows[:, 0].tolist())
    check(filters == {0}, f"PNG filter types {sorted(filters)}, the writer uses 0 only")
    return rows[:, 1:].reshape(h, w, 4).copy()


def _http(base: str, path: str, body=None, timeout: float = 120.0):
    """(status, content type, body bytes, ms) of one request to the server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method="POST" if data else "GET",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = (r.status, r.headers["Content-Type"], r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers["Content-Type"], e.read())
    return (*out, (time.perf_counter() - t0) * 1e3)


def _get_json(base: str, path: str, status: int = 200):
    code, _, body, _ = _http(base, path)
    check(code == status, f"GET {path}: {code} {body[:300]!r}")
    return json.loads(body)


def _xyz(lon: float, lat: float, z: int):
    return (int((lon + 180) / 360 * 2 ** z),
            int((1 - math.asinh(math.tan(math.radians(lat))) / math.pi) / 2 * 2 ** z))


def webapp_phase(device, smi: str, size: int = GRANULE_SIZE, block=GRANULE_BLOCK,
                 bbox_px=WEB_BBOX_PX, overrides=None, zooms=WEB_ZOOMS) -> dict:
    """The web platform as it is deployed, on the granule tile (written again
    here, its STAC items the search's answer in every process): the
    topology of ``COMPOSE_FILE`` (``compose_services``), each service built
    from the repo started from the file's own ``command`` with the file's
    own environment (its volumes in a directory of this phase, one process
    per replica, each a process group of its own, killed at the end; a
    service without the GPU reservation sees no card): the backend
    (``INSTAGEO_NO_WORKERS=1``) on a free localhost port and each queue's
    workers, an isolated job process per stage, on ``INSTAGEO_DEVICE``
    (``cuda`` on the card), auth off (no Auth0 tenant). The phase's hooks
    reach processes it did not spawn through a ``sitecustomize`` on their
    path (``SITECUSTOMIZE``). This process talks to the backend over HTTP
    only, as the SPA does.

    1. The backend answers ``/api/health`` with no workers of its own, and
       ``/api/models`` with the shipped registry.
    2. ``POST /api/run-model`` of ``crop_classification`` (the shipped
       registry; ``base`` is ``WEB_MODEL``, its config the crop yaml with that
       model, random weights from seed 0) over the tile's pixels ``bbox_px``,
       three steps 5 days apart from 2023-06-11 that pick the three granules;
       ``/api/task/{id}`` polled until ``completed``. Reported: each stage's
       seconds from the task record, each job's seconds and what its process
       paid before the job (``_install_webapp_hooks``), the launches in each
       job process (24 per chip batch in stage 2), peak device memory per
       stage, the wall from the POST.
    3. ``/api/visualize``, then for both layers ``tilejson``, ``preview.png``
       and ``statistics``; every z in ``zooms`` tile over the bbox for both
       layers, fetched twice by ``WEB_CLIENTS`` client threads: each a 256 px
       RGBA PNG (``read_png``); count, p50 and p99 ms, tiles/s.
    4. In this process, stage 2 and 3 through ``queue.drain`` on copies of the
       task's chips, with the kernels (launches counted from 0 just before,
       read just after: 24 x the chip batches on wgmma, none on mma.sync) and
       with the plain attention: the kernel run's predictions COG equals the
       worker-run one bit for bit; kernel and plain argmax agree on at least
       ARGMAX_AGREEMENT of decided pixels (plain top-2 gap at least
       GRANULE_GAP, nodata inputs not decided) and mark the same pixels −1.
    5. ``python -m instageo_tpu_torch.webapp.main`` in a fresh interpreter
       with the backend's environment but ``INSTAGEO_NO_WORKERS`` and with
       ``AUTH_DISABLED=false``: ``/api/health`` with its three workers
       alive, a request without a token answered 401; it stops on SIGTERM.

    ``overrides``: config overrides of the model (a CPU rehearsal's tiny one).
    """
    import csv
    import shutil
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from instageo_tpu_torch.configs.config import load_config, save_config
    from instageo_tpu_torch.data.crs import utm_to_latlon
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import create_model

    on_card = device.type == "cuda"
    clock = Clock("webapp")
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    repo = os.path.dirname(os.path.abspath(__file__))
    saved_env = dict(os.environ)
    topology = []  # (name, log, process): each its own process group
    try:
        # --- the tile, its items, the model in a models directory ------------
        _, bands, _, transform = _write_granule(root, size, block)
        with open(os.path.join(root, "hls_dataset.json")) as f:
            granules = next(iter(json.load(f).values()))["granules"]
        x0, y0 = transform * (0, 0)
        x1, y1 = transform * (size, size)
        lat, lon = utm_to_latlon(np.asarray([x0, x1, x0, x1]), np.asarray([y0, y0, y1, y1]),
                                 33, False)
        for g in granules:
            g["bbox"] = [float(lon.min()), float(lat.min()), float(lon.max()), float(lat.max())]
        items_path = os.path.join(root, "stac_items.json")
        with open(items_path, "w") as f:
            json.dump(granules, f)
        c0, r0, c1, r1 = bbox_px
        blat, blon = utm_to_latlon(x0 + np.asarray([c0, c1, c0, c1]) * 30.0,
                                   y0 - np.asarray([r0, r0, r1, r1]) * 30.0, 33, False)
        bbox = [float(blon.min()), float(blat.min()), float(blon.max()), float(blat.max())]
        run_dir = os.path.join(root, "models", "crop_classification", "base")
        cfg = load_config(CROP_CONFIG, overrides={
            "model.model_name": WEB_MODEL, "model.load_pretrained_weights": False,
            **(overrides or {})})
        save_config(cfg, run_dir)
        model = create_model(cfg, seed=0, device=device)
        BestCheckpointer(run_dir).save({"model": model.state_dict()})
        depth, classes = len(model.prithvi_encoder.blocks), int(cfg.model.num_classes)
        batch, dl = int(cfg.train.batch_size), cfg.dataloader
        del model
        records = os.path.join(root, "job_records")
        os.makedirs(records)
        # The compose file's services as a host runs them: its volumes in this
        # directory, the models directory where the model was saved.
        variables = {"MODELS_DIR": os.path.join(root, "models")}
        if device.type != "cuda":  # the file's default is the card
            variables["INSTAGEO_DEVICE"] = device.type
        services = compose_services(os.path.join(repo, COMPOSE_FILE), root, variables)
        check(sorted(services) == ["backend", "worker-data-processing",
                                   "worker-model-prediction", "worker-visualization"],
              f"services built from the repo: {sorted(services)}")
        for svc in services.values():
            for path in svc["mounts"].values():
                os.makedirs(path, exist_ok=True)  # a volume exists before its container
        hooks = os.path.join(root, "hooks")
        os.makedirs(hooks)
        with open(os.path.join(hooks, "sitecustomize.py"), "w") as f:
            f.write(SITECUSTOMIZE.format(stac=STAC_ITEMS_ENV, repo=repo))
        # What every process of the topology gets beside its service's own
        # environment: the machine's (less the web platform's names, which
        # the file sets), the hooks, the asset-load limit of the other phases.
        host_env = {k: v for k, v in saved_env.items() if k not in WEB_ENV_NAMES}
        host_env.update(PYTHONPATH=os.pathsep.join([hooks, repo]),
                        INSTAGEO_COG_RATELIMIT="1000", **{STAC_ITEMS_ENV: items_path,
                                                          JOB_RECORDS_ENV: records})
        # This process reads the same database and task directory as the
        # backend, and runs stages 2 and 3 on the device (step 4).
        os.environ.clear()
        os.environ.update(host_env)
        os.environ.update(services["backend"]["env"])
        os.environ.update(INSTAGEO_DEVICE=device.type)
        from instageo_tpu_torch.webapp import queue
        from instageo_tpu_torch.webapp.settings import settings
        from instageo_tpu_torch.webapp.tasks import Task
        from instageo_tpu_torch.webapp.tiler import TilerService

        check(settings.DEVICE == device.type and settings.AUTH_DISABLED
              and settings.TASKS_DATA_DIR == services["backend"]["env"]["TASKS_DATA_DIR"],
              f"settings {settings}")
        clock.lap("wrote the tile, its items and the model")

        # --- the deployed topology: the backend, then each queue's workers ------
        t0 = time.perf_counter()
        logs = os.path.join(root, "logs")
        os.makedirs(logs)
        for name, svc in services.items():
            env = dict(host_env, **svc["env"])
            if not svc["gpu"]:
                env["CUDA_VISIBLE_DEVICES"] = ""  # a container without the reservation
            if name == "backend":
                env["PORT"] = "0"  # a free port, logged as "Serving on http://...:<port>"
            for i in range(svc["replicas"]):
                log = os.path.join(logs, f"{name}.{i}.log")
                with open(log, "w") as out:
                    topology.append((f"{name}.{i}", log, subprocess.Popen(
                        svc["argv"], cwd=repo, env=env, stdout=out, stderr=subprocess.STDOUT,
                        start_new_session=True)))
            if name == "backend":
                port = _logged_port(topology[0][2], topology[0][1], "the deployed backend")
                base = f"http://127.0.0.1:{port}"
        health = _get_json(base, "/api/health")
        check(health["status"] == "healthy" and health["workers"]["count"] == 0,
              f"the deployed backend (INSTAGEO_NO_WORKERS=1): health {health}")
        models = [m["model_key"] for m in _get_json(base, "/api/models")["models"]]
        check("crop_classification" in models and len(models) >= 2, f"models {models}")
        server_s = time.perf_counter() - t0
        print(f"[webapp] {COMPOSE_FILE}: " + ", ".join(
            f"{name} x{svc['replicas']} ({'GPU' if svc['gpu'] else 'no GPU'}): "
            + " ".join(svc["argv"][1:]) for name, svc in services.items())
            + f"; up in {server_s:.3f} s", flush=True)
        clock.lap("topology up")

        # --- one task through the three stages ---------------------------------
        post = dict(WEB_POST, bboxes=[bbox])
        t_post = time.time()
        code, _, body, post_ms = _http(base, "/api/run-model", post)
        check(code == 202, f"POST /api/run-model: {code} {body!r}")
        task_id = json.loads(body)["task_id"]
        while True:
            task = _get_json(base, f"/api/task/{task_id}")
            if task["status"] in ("completed", "failed"):
                break
            check(time.time() - t_post < WEB_TASK_TIMEOUT_S,
                  f"task still {task['status']} after {WEB_TASK_TIMEOUT_S} s")
            time.sleep(0.25)
        wall = time.time() - t_post
        check(task["status"] == "completed", f"task failed: {json.dumps(task['stages'])}")
        stages = {s: task["stages"][s]["finished_at"] - task["stages"][s]["started_at"]
                  for s in ("data_processing", "model_prediction", "visualization_preparation")}
        jobs = {j["func"].split(":")[1]: j for j in _get_json(base, "/api/jobs")["jobs"]
                if j["task_id"] == task_id}
        check(len(jobs) == 3 and all(j["status"] == "finished" for j in jobs.values()),
              f"jobs {[(k, j['status']) for k, j in jobs.items()]}")
        parts = {}
        for func, j in jobs.items():
            with open(os.path.join(records, f"{j['job_id']}.json")) as f:
                rec = json.load(f)
            rec["spawn_s"] = rec.pop("hook_at") - j["started_at"]
            rec["peak_device_bytes"] = json.loads(j["result"]).get("peak_device_bytes")
            parts[func] = rec
        task_dir = os.path.join(os.environ["TASKS_DATA_DIR"], task_id)
        with open(os.path.join(task_dir, "hls_raster_dataset.csv"), newline="") as f:
            manifest = [r["Input"] for r in csv.DictReader(f)]
        n = len(manifest)
        check(n > 0 and sorted(manifest) == sorted(
            "chips/" + c for c in os.listdir(os.path.join(task_dir, "chips"))),
            f"manifest of {n} chips")
        check(len(os.listdir(os.path.join(task_dir, "predictions"))) == n,
              "one prediction per chip")
        stage2 = parts["process_model_prediction_with_task"]
        want = {"flash_attn_fwd": depth * -(-n // batch), "flash_attn_fwd_mma": 0,
                "flash_attn_bwd": 0, "flash_attn_bwd_mma": 0, "fused_dropout": 0}
        if on_card:
            check(stage2.get("launches") == want,
                  f"stage 2 in its job process launched {stage2.get('launches')}, expected {want}")
        print(f"[webapp] POST /api/run-model ({post_ms:.1f} ms): {n} grid chips of 18x"
              f"{dl.img_size}x{dl.img_size} over the tile's pixels {bbox_px}, completed in "
              f"{wall:.3f} s wall; stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + "; stage 2's job process launched " + json.dumps(stage2.get("launches"))
              + f" ({depth} per chip batch of {batch})", flush=True)
        for func, rec in parts.items():
            cold = ", ".join(f"{what} {rec[key]:.3f} s" for key, what in (
                ("import_torch_s", "import torch"), ("cuda_context_s", "CUDA context"),
                ("dynamo_import_s", "import torch._dynamo")) if key in rec)
            print(f"[webapp] {func} job process: spawn to job {rec['spawn_s']:.3f} s"
                  f"{', ' + cold if cold else ''}, the job {rec['job_s']:.3f} s; peak device "
                  f"memory {rec['peak_device_bytes']} B", flush=True)
        clock.lap("task")

        # --- what the map reads -----------------------------------------------
        viz = _get_json(base, f"/api/visualize/{task_id}")
        check(sorted(viz["layers"]) == ["chips", "predictions"], f"layers {viz}")
        layers = {}
        for layer in ("chips", "predictions"):
            urls = viz["layers"][layer]
            tj = _get_json(base, urls["tilejson"])
            b = tj["bounds"]
            check(b[0] <= bbox[0] + 0.01 and b[2] >= bbox[2] - 0.01 and b[1] <= bbox[1] + 0.01
                  and b[3] >= bbox[3] - 0.01, f"{layer} tilejson bounds {b} vs the bbox {bbox}")
            code, ctype, png, ms = _http(base, urls["preview"])
            check(code == 200 and ctype == "image/png", f"{layer} preview {code}")
            preview = read_png(png)
            check(max(preview.shape[:2]) <= 512 and (preview[..., 3] > 0).any(),
                  f"{layer} preview {preview.shape}")
            stats = _get_json(base, urls["statistics"])
            if layer == "predictions":
                check(0 <= stats["b1"]["min"] and stats["b1"]["max"] < classes,
                      f"predictions statistics {stats}")
            else:
                check(sorted(stats) == ["b1", "b2", "b3"], f"chips statistics {stats}")
            layers[layer] = dict(bounds=b, preview_shape=list(preview.shape), preview_ms=ms,
                                 statistics=stats)
        tiles = [(layer, z, x, y) for layer in ("chips", "predictions") for z in zooms
                 for x in range(_xyz(bbox[0], 0, z)[0], _xyz(bbox[2], 0, z)[0] + 1)
                 for y in range(_xyz(0, bbox[3], z)[1], _xyz(0, bbox[1], z)[1] + 1)]

        def fetch(t):
            layer, z, x, y = t
            code, ctype, png, ms = _http(base, f"/api/titiler/{task_id}/{layer}/tiles/"
                                               f"{z}/{x}/{y}.png")
            check(code == 200 and ctype == "image/png", f"tile {t}: {code}")
            px = read_png(png)
            check(px.shape == (256, 256, 4), f"tile {t}: {px.shape}")
            return ms, int((px[..., 3] > 0).sum())

        tile_runs = {}
        for name in ("cold", "warm"):
            t0 = time.perf_counter()
            with ThreadPoolExecutor(WEB_CLIENTS) as pool:
                got = list(pool.map(fetch, tiles))
            dt = time.perf_counter() - t0
            ms = np.asarray([g[0] for g in got])
            check(sum(g[1] for g in got) > 0, "every tile transparent")
            tile_runs[name] = dict(tiles=len(tiles), p50_ms=float(np.percentile(ms, 50)),
                                   p99_ms=float(np.percentile(ms, 99)), tiles_per_s=len(tiles) / dt,
                                   seconds=dt)
            print(f"[webapp] map tiles ({name}): {len(tiles)} tiles of z {list(zooms)} over the "
                  f"bbox, both layers, {WEB_CLIENTS} client threads: p50 "
                  f"{tile_runs[name]['p50_ms']:.3f} ms, p99 {tile_runs[name]['p99_ms']:.3f} ms, "
                  f"{tile_runs[name]['tiles_per_s']:.2f} tiles/s; every tile a 256 px RGBA PNG",
                  flush=True)
        # The same tiles rendered in this process, one thread, no HTTP: the
        # render's own share of a request.
        tiler_service = TilerService(settings.TASKS_DATA_DIR)
        tilers = {layer: tiler_service.get_tiler(task_id, layer) for layer in layers}
        render_ms = {}
        for layer, z, x, y in tiles:
            t0 = time.perf_counter()
            tilers[layer].render_tile(z, x, y, mode="classes" if layer == "predictions" else "rgb")
            render_ms.setdefault(layer, []).append((time.perf_counter() - t0) * 1e3)
        tile_runs["render_ms"] = {k: dict(p50=float(np.percentile(v, 50)),
                                          p99=float(np.percentile(v, 99)), total=float(sum(v)))
                                  for k, v in render_ms.items()}
        print(f"[webapp] the same tiles rendered in this process, one thread, no HTTP: " + ", ".join(
            f"{k} p50 {v['p50']:.3f} ms, p99 {v['p99']:.3f} ms"
            for k, v in tile_runs["render_ms"].items())
            + f"; {len(os.sched_getaffinity(0))} CPUs for this process", flush=True)
        clock.lap("map")

        # --- stage 2 in this process: the kernel against the plain attention ---
        from instageo_tpu_torch.train import factory

        inproc_db = os.path.join(root, "inproc.sqlite")
        make_model = factory.create_model

        def plain_model(*a, **k):
            m = make_model(*a, **k)
            for blk in m.prithvi_encoder.blocks:
                blk.attn.attn_impl = "plain"
            return m

        def read_cog(path):
            with GeoTiffReader(path) as r:
                return r.read(1)

        inproc = {}
        for name in ("kernel", "plain"):
            t = Task(bboxes=[bbox], parameters=task["parameters"], model_key=task["model_key"],
                     model_size=task["model_size"], db_path=inproc_db)
            os.makedirs(t.data_dir)
            shutil.copytree(os.path.join(task_dir, "chips"), os.path.join(t.data_dir, "chips"))
            shutil.copy(os.path.join(task_dir, "hls_raster_dataset.csv"), t.data_dir)
            t.save()
            with mock.patch.object(factory, "create_model",
                                   make_model if name == "kernel" else plain_model):
                t.start_model_prediction()
                # --- stages 2 and 3: counts from 0, read right after ------------
                reset_counts()
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                done = queue.drain(db_path=inproc_db)
                if on_card:
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts()
                # -----------------------------------------------------------------
            check(done == 2 and Task.load(t.task_id, inproc_db).status == "completed",
                  f"in-process {name} run: {done} jobs, {Task.load(t.task_id, inproc_db).stages}")
            inproc[name] = dict(seconds=seconds, launches=counts, task_id=t.task_id,
                                pred=read_cog(os.path.join(t.data_dir,
                                                           f"{t.task_id}_predictions.tif")),
                                peak_device_bytes=torch.cuda.max_memory_allocated()
                                if on_card else None)
        if on_card:
            check(inproc["kernel"]["launches"] == want,
                  f"in-process stage 2 launched {inproc['kernel']['launches']}, expected {want}")
        check(not any(inproc["plain"]["launches"].values()),
              f"the plain run launched {inproc['plain']['launches']}")
        worker_pred = read_cog(os.path.join(task_dir, f"{task_id}_predictions.tif"))
        check(np.array_equal(inproc["kernel"]["pred"], worker_pred),
              "the in-process predictions COG differs from the worker-run one")
        # Decided pixels: the plain top-2 gap, chip by chip as stage 2 runs.
        from instageo_tpu_torch.configs.config import merge
        from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
        from instageo_tpu_torch.serve.server import ModelServer

        gcfg = merge(cfg, {"checkpoint_path": os.path.join(run_dir, "instageo_best_checkpoint"),
                           "device": device.type})
        gmodel = ModelServer(gcfg).model
        gap_fn = make_fused_predict_fn(top2_gap(gmodel), list(dl.mean), list(dl.std),
                                       temporal_size=int(dl.temporal_dim), bands=list(dl.bands),
                                       constant_multiplier=float(dl.constant_multiplier),
                                       is_reg_task=True, img_size=int(dl.img_size))
        same = decided = 0
        plain_dir = os.path.join(os.environ["TASKS_DATA_DIR"], inproc["plain"]["task_id"])
        kern_dir = os.path.join(os.environ["TASKS_DATA_DIR"], inproc["kernel"]["task_id"])
        with plain_attention(gmodel):
            for i in range(0, n, batch):
                paths = manifest[i:i + batch]
                raw = []
                for p in paths:
                    with GeoTiffReader(os.path.join(task_dir, p)) as r:
                        raw.append(r.read())
                raw = np.stack(raw)
                gap = gap_fn(raw).float().cpu().numpy()
                ok = (gap >= GRANULE_GAP) & ~(raw == 0).all(axis=1)
                for j, p in enumerate(paths):
                    name = os.path.basename(p).replace("chip", "prediction")
                    k = read_cog(os.path.join(kern_dir, "predictions", name))
                    q = read_cog(os.path.join(plain_dir, "predictions", name))
                    same += int((k == q)[ok[j]].sum())
                    decided += int(ok[j].sum())
        del gmodel
        agreement = same / max(decided, 1)
        kp, pp = inproc["kernel"]["pred"], inproc["plain"]["pred"]
        check(np.array_equal(kp == -1, pp == -1), "kernel and plain mark different pixels -1")
        check(decided > 0 and agreement >= ARGMAX_AGREEMENT,
              f"kernel vs plain argmax agreement {agreement} on {decided} decided pixels")
        nodata_px = int((kp == -1).sum())
        print(f"[webapp] stages 2 and 3 in this process on copies of the task's {n} chips: "
              f"kernel {inproc['kernel']['seconds']:.3f} s, launches "
              f"{json.dumps(inproc['kernel']['launches'])}; plain attention "
              f"{inproc['plain']['seconds']:.3f} s, launches "
              f"{json.dumps(inproc['plain']['launches'])}; the kernel run's predictions COG = "
              f"the worker-run one bit for bit; kernel vs plain argmax agreement "
              f"{agreement:.6f} (>= {ARGMAX_AGREEMENT}) on {decided} decided pixels (plain "
              f"top-2 gap >= {GRANULE_GAP}, nodata inputs out), {nodata_px} px -1 in both; "
              f"peak device memory {inproc['kernel']['peak_device_bytes']} B", flush=True)
        clock.lap("in-process stages, kernel vs plain")

        # --- a fresh interpreter: the backend with its own workers, auth on ----
        # The backend's environment without INSTAGEO_NO_WORKERS: it starts the
        # three queue workers itself; AUTH_DISABLED=false: a request without
        # a token is refused.
        env = dict(host_env, **services["backend"]["env"])
        for k in ("INSTAGEO_NO_WORKERS", STAC_ITEMS_ENV, JOB_RECORDS_ENV):
            env.pop(k)
        env.update(PORT="0", DATABASE_URL=os.path.join(root, "fresh.sqlite"),
                   AUTH_DISABLED="false")
        t0 = time.perf_counter()
        log = os.path.join(logs, "fresh.log")
        with open(log, "w") as out:
            proc = subprocess.Popen([sys.executable, "-m", "instageo_tpu_torch.webapp.main"],
                                    cwd=repo, env=env, stdout=out, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        topology.append(("fresh", log, proc))
        fresh_base = f"http://127.0.0.1:{_logged_port(proc, log, 'webapp.main')}"
        fresh = _get_json(fresh_base, "/api/health")
        first_answer_s = time.perf_counter() - t0
        check(fresh["status"] == "healthy" and fresh["workers"] == {"count": 3, "alive": 3},
              f"python -m instageo_tpu_torch.webapp.main: {fresh}")
        code, _, body, _ = _http(fresh_base, "/api/tasks")
        check(code == 401 and json.loads(body) == {"detail": "Missing bearer token"},
              f"auth on, no token: {code} {body!r}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        with open(log) as f:
            err = f.read()
        check(rc == 0 and "Traceback" not in err, f"webapp.main exit {rc}: {err[-2000:]}")
        print(f"[webapp] python -m instageo_tpu_torch.webapp.main in a fresh interpreter: "
              f"/api/health answered {first_answer_s:.3f} s after the start "
              f"({fresh['workers']['count']} workers alive); with auth on a request without "
              f"a token is answered 401; stopped on SIGTERM, exit 0", flush=True)
        clock.lap("fresh interpreter")
        for name, log, p in topology[:-1]:
            check(p.poll() is None, f"{name} of the deployed topology exited {p.returncode}")
        return dict(chips=n, wall_s=wall, stages_s=stages, jobs=parts, server_s=server_s,
                    layers=layers, tiles=tile_runs, launches=inproc["kernel"]["launches"],
                    worker_launches=stage2.get("launches"),
                    inproc_s={k: v["seconds"] for k, v in inproc.items()},
                    inproc_peak_device_bytes=inproc["kernel"]["peak_device_bytes"],
                    agreement=agreement, decided=decided, fresh_s=first_answer_s,
                    services={k: dict(argv=v["argv"][1:], replicas=v["replicas"], gpu=v["gpu"])
                              for k, v in services.items()})
    except BaseException:
        for name, log, _ in topology:  # what each process said, for the failure
            with open(log, errors="replace") as f:
                print(f"[webapp] {name} log (tail):\n{f.read()[-3000:]}", flush=True)
        raise
    finally:
        for _, _, p in topology:  # each process group, job processes included
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        os.environ.clear()
        os.environ.update(saved_env)
        tmp.cleanup()


PARALLEL_CONFIG = "prithvi600_v5e8"
PARALLEL_STEPS = 8          # two groups of the recipe's steps_per_call: 4
PARALLEL_LOSS_RTOL = 1e-3   # each step's loss vs one process, over more than one rank
PARALLEL_RUN_TIMEOUT_S = 480


def _metrics_log(run_dir: str) -> dict:
    """The run CLI's metrics.jsonl: the epoch record, the complexity record
    and the ranks record, merged."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            out.update(json.loads(line))
    return out


def _recipe_run(argv: list, nproc: int, run_dir: str) -> dict:
    """The run CLI as a user starts it: under ``torch.distributed.run``
    with ``nproc`` processes, or as ``python -m`` when ``nproc`` is 0.
    Returns its wall seconds and its metrics log."""
    cmd = [sys.executable, "-m"]
    if nproc:
        cmd += ["torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}", "-m"]
    cmd += ["instageo_tpu_torch.train.run", *argv, f"run_dir={run_dir}"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.getcwd()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=PARALLEL_RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd[:8])} ... exited {proc.returncode}: "
          f"{proc.stdout[-1500:]} {proc.stderr[-6000:]}")
    lines = [line for line in proc.stderr.splitlines() if "steps_per_call" in line
             or "placement" in line]
    return dict(wall_s=wall, log=_metrics_log(run_dir), notes=lines[-4:],
                last=json.loads(proc.stdout.strip().splitlines()[-1]))


def _remat_check(device, model_kw: dict, cfg: dict, data: dict, batch: int, steps: int):
    """``tpu.remat`` at the crop model's full width, from the same weights,
    inputs and seeds (``steps`` optimizer steps each), against no remat:
    losses and parameters bit for bit, launches per step and peak memory of
    each run."""
    import torch

    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.train.trainer import Trainer

    on_card = device.type == "cuda"
    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    x, y = _crop_batch(batch, t, size, classes, seed=11, data=data)
    runs = {}
    for name, remat in (("plain", False), ("remat", True)):
        model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                                   remat=remat, device=device, seed=0)
        trainer = Trainer(cfg, model, device=device)
        xb, yb = trainer.prepare_batch(x, y, batch)
        gen = torch.Generator().manual_seed(0)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # --- this run's training path: counts from 0, read right after ------
        reset_counts()
        losses = [trainer.train_step(xb, yb, gen) for _ in range(steps)]
        counts = read_counts()
        # ----------------------------------------------------------------------
        runs[name] = dict(
            losses=[float(v) for v in losses], counts=counts,
            params={n: p.detach().clone() for n, p in model.named_parameters()},
            peak_bytes=torch.cuda.max_memory_allocated() if on_card else None)
        del model, trainer
        gc.collect()
    plain, remat = runs["plain"], runs["remat"]
    depth = len([k for k in plain["params"] if k.endswith("attn.qkv.weight")])
    if on_card:
        for name, fwd in (("plain", 1), ("remat", 2)):
            want = {"flash_attn_fwd": fwd * depth * steps, "flash_attn_fwd_mma": 0,
                    "flash_attn_bwd": depth * steps, "flash_attn_bwd_mma": 0}
            got = {k: runs[name]["counts"][k] for k in want}
            check(got == want, f"{name}: launches {got} over {steps} steps, expected {want}")
    difference = _first_difference(remat, plain)
    check(difference is None, f"remat vs no remat: {difference}")
    return dict(launches={k: r["counts"] for k, r in runs.items()},
                launches_per_step={k: {n: v / steps for n, v in r["counts"].items()}
                                   for k, r in runs.items()},
                peak_bytes={k: r["peak_bytes"] for k, r in runs.items()},
                losses={k: r["losses"] for k, r in runs.items()})


def _multi_card_runs(device, smi: str, nproc: int, extra=(), steps: int = 4) -> dict:
    """With ``nproc`` >= 2 cards: the crop yaml at full width under
    ``torch.distributed.run`` as DP over every card, ``tpu.tp=2``,
    ``tpu.pp=2`` and ``tpu.tp=2 tpu.sp=true`` (8 chips per card per step,
    ``steps`` steps), against the same CLI in one process: ms per step,
    the port's collectives per step (rank 0's train epoch), each step's
    loss (each mode within PARALLEL_LOSS_RTOL of one process)."""
    from instageo_tpu_torch.configs.config import load_config_from_argv

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    batch = 8 * nproc
    base = [f"--config-name={CROP_CONFIG}", "mode=train", f"root_dir={root}",
            f"train_filepath={root}/train.csv", f"valid_filepath={root}/val.csv",
            "model.load_pretrained_weights=False", "train.num_epochs=1",
            f"train.batch_size={batch}", *extra]
    if device.type != "cuda":
        base.append("device=cpu")
    cfg = load_config_from_argv(base)
    dl = cfg.dataloader
    runs = {}
    try:
        _write_dataset(root, batch * steps, batch, len(dl.bands), int(dl.img_size),
                       int(cfg.model.num_classes))
        for name, n, more in (("one_process", 0, []), ("dp", nproc, []),
                              ("tp2", nproc, ["tpu.tp=2"]),
                              ("pp2", nproc, ["tpu.pp=2"]),
                              ("tp2_sp", nproc, ["tpu.tp=2", "tpu.sp=true"])):
            run = _recipe_run(base + more, n, os.path.join(root, name))
            log = run["log"]
            r0 = log["ranks"][0]
            runs[name] = dict(
                placement=log["placement"], losses=log["train_step_losses"],
                ms_per_step=log["train_time_s"] * 1e3 / steps,
                collectives_per_step={k: v / steps for k, v in r0["train_collectives"].items()})
    finally:
        tmp.cleanup()
    ref = runs["one_process"]["losses"]
    for name, r in runs.items():
        r["loss_rel_max"] = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref))
        print(f"[parallel] {smi}: crop yaml, {name} ({r['placement']}, "
              f"{nproc if name != 'one_process' else 1} process(es), global batch {batch}): "
              f"{r['ms_per_step']:.3f} ms per step, collectives per step (rank 0) "
              f"{json.dumps(r['collectives_per_step'])}, losses within "
              f"{r['loss_rel_max']:.3g} of one process", flush=True)
    for name, r in runs.items():
        check(r["loss_rel_max"] <= PARALLEL_LOSS_RTOL,
              f"{name} over {nproc} cards vs one process: {r['loss_rel_max']}")
    return runs


def parallel_phase(device, smi: str, model_kw: dict, train_cfg: dict, data: dict,
                   batch: int = 128, n_chips: int = 64, n_val: int = 16, extra=(),
                   nproc: int = 0, remat_batch: int = 8, remat_steps: int = 2) -> dict:
    """``parallel/`` on the card (see the module docstring, phase 14):
    the 600M recipe under ``torch.distributed.run`` with one process per
    visible card against its plain twin, then remat in process. ``extra``:
    more overrides (a tiny model for a CPU rehearsal); ``nproc``: the
    processes (the visible cards by default)."""
    import torch

    from instageo_tpu_torch.configs.config import load_config_from_argv
    from instageo_tpu_torch.models.registry import get_arch

    on_card = device.type == "cuda"
    nproc = nproc or torch.cuda.device_count()
    if on_card:  # the recipe's processes need the card's memory
        gc.collect()
        torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    base = [f"--config-name={PARALLEL_CONFIG}", "mode=train", f"root_dir={root}",
            f"train_filepath={root}/train.csv", f"valid_filepath={root}/val.csv",
            "model.load_pretrained_weights=False", "train.num_epochs=1",
            f"train.batch_size={batch}", f"dataloader.cache_dir={root}/cache", *extra]
    if not on_card:
        base.append("device=cpu")
    cfg = load_config_from_argv(base)
    dl = cfg.dataloader
    size, classes = int(dl.img_size), int(cfg.model.num_classes)
    depth = get_arch(str(cfg.model.model_name), depth=int(cfg.model.depth)).depth
    k = int(cfg.tpu.steps_per_call)
    try:
        t0 = time.perf_counter()
        bands = max(dl.bands) + 1  # the recipe picks 6 of the HLS file's 13
        _write_dataset(root, n_chips, n_val, bands, size, classes - 1)
        # PARALLEL_STEPS global batches: the chips listed again and again.
        with open(os.path.join(root, "train.csv")) as f:
            header, *rows = f.read().splitlines()
        rows = (rows * (-(-PARALLEL_STEPS * batch // len(rows))))[:PARALLEL_STEPS * batch]
        with open(os.path.join(root, "train.csv"), "w") as f:
            f.write("\n".join([header, *rows]) + "\n")
        print(f"[parallel] {n_chips} + {n_val} chips of {bands} bands, {size} px, "
              f"{PARALLEL_STEPS} global batches of {batch} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        recipe = _recipe_run(base, nproc, os.path.join(root, "recipe"))
        twin = _recipe_run(base + ["tpu.fsdp=False", "tpu.zero1=False"], 0,
                           os.path.join(root, "twin"))
    finally:
        tmp.cleanup()
    out = {"nproc": nproc, "batch": batch, "steps_per_call": k}
    for name, run in (("recipe", recipe), ("twin", twin)):
        log = run["log"]
        out[name] = dict(
            placement=log["placement"], losses=log["train_step_losses"], wall_s=run["wall_s"],
            ms_per_step=log["train_time_s"] * 1e3 / PARALLEL_STEPS,
            ranks=[{key: r[key] for key in ("param_bytes", "moment_bytes", "peak_device_bytes")}
                   for r in log["ranks"]],
            train_launches=[r["train_launches"] for r in log["ranks"]],
            launches_per_step=[{k: v / PARALLEL_STEPS for k, v in r["train_launches"].items()}
                               for r in log["ranks"]],
            notes=run["notes"])
        r = out[name]
        print(f"[parallel] {smi}: {name} ({r['placement']}, "
              f"{nproc if name == 'recipe' else 1} process(es)): {batch} global batch, "
              f"{r['ms_per_step']:.3f} ms per step (train epoch wall / {PARALLEL_STEPS}), "
              f"{r['wall_s']:.3f} s run wall; per rank "
              + "; ".join(f"params {q['param_bytes'] / 2**30:.3f} GiB, moments "
                          f"{q['moment_bytes'] / 2**30:.3f} GiB, peak "
                          f"{(q['peak_device_bytes'] or 0) / 2**30:.3f} GiB"
                          for q in r["ranks"])
              + f"; launches per step {json.dumps(r['launches_per_step'][0])}; "
              f"losses {json.dumps(r['losses'])}; {r['notes']}", flush=True)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["recipe"]["losses"], out["twin"]["losses"])]
    out["loss_rel_max"] = max(rel)
    out["bit_equal"] = out["recipe"]["losses"] == out["twin"]["losses"]
    print(f"[parallel] recipe vs twin: each step's loss within {max(rel):.3g} relative "
          f"(<= {PARALLEL_LOSS_RTOL}); bit-equal: {out['bit_equal']}", flush=True)
    for name in ("recipe", "twin"):
        losses = out[name]["losses"]
        check(len(losses) == PARALLEL_STEPS and all(math.isfinite(v) for v in losses),
              f"{name}: step losses {losses}")
        if on_card:
            accum = int(cfg.train.grad_accum)
            drops = 5 if str(cfg.model.head_impl) == "torch" else 4  # the head's Dropouts
            for r, c in enumerate(out[name]["launches_per_step"]):
                check(c["flash_attn_fwd_sm90"] == c["flash_attn_bwd_sm90"] == depth * accum
                      and c["flash_attn_fwd"] == c["flash_attn_bwd"] == 0,
                      f"{name} rank {r}: launches per step {c}, expected {depth * accum} "
                      "forward and backward on the sm90 route")
                check(c["fused_dropout"] == drops * accum,
                      f"{name} rank {r}: {c['fused_dropout']} dropout launches per step")
    check(out["recipe"]["placement"] == ("fsdp" if nproc else "single")
          and out["twin"]["placement"] == "single",
          f"placements {out['recipe']['placement']}, {out['twin']['placement']}")
    if nproc == 1:
        # One rank: the recipe's placement changes no sum, so its losses are
        # the twin's bit for bit.
        check(out["bit_equal"], f"recipe vs plain twin at world 1: step losses differ by {rel}")
    else:
        check(max(rel) <= PARALLEL_LOSS_RTOL,
              f"recipe vs plain twin step losses differ by {rel} (rtol {PARALLEL_LOSS_RTOL})")
    if nproc < 2:
        print(f"[parallel] {nproc} card(s) visible: tensor, pipeline and sequence "
              "parallelism and a data axis of more than one rank need 2 cards; they are "
              "held on the CPU with gloo (tests/test_torch_parallel.py)", flush=True)
    else:
        out["multi"] = _multi_card_runs(device, smi, nproc, extra)
    remat = _remat_check(device, model_kw, train_cfg, data, remat_batch, remat_steps)
    out["remat"] = remat
    print(f"[parallel] {smi}: remat at batch {remat_batch} over {remat_steps} steps: "
          f"losses and parameters bit-equal to no remat; "
          f"launches per step {json.dumps(remat['launches_per_step'])}; peak "
          + ", ".join(f"{k_} {(v or 0) / 2**30:.3f} GiB" for k_, v in remat["peak_bytes"].items()),
          flush=True)
    return out


EXAMPLE_TIMEOUT_S = 420
MULTICHIP_LOSS_ATOL = 1e-3  # each placement's step losses vs data parallelism's


def _example_start(argv: list, env=None):
    """Start a walkthrough as a user runs it, from the repository root, in a
    process group of its own, with ``env`` added to this process's
    environment: (process, start time)."""
    env = {**{k: v for k, v in os.environ.items()
              if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")},
           **(env or {})}
    # As in the granule and chip_creator phases: the pipelines' thread pool
    # can load one tile several times at once (its tile cache checks, then
    # loads), and 30 loads a minute would then stall a run for up to 60 s.
    env.setdefault("INSTAGEO_COG_RATELIMIT", "1000")
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    return proc, time.perf_counter()


def _example_wait(started, what: str, timeout: float = EXAMPLE_TIMEOUT_S) -> tuple:
    """Wait for a walkthrough (its whole process group is killed at
    ``timeout``) and check it exited 0: (stdout, wall s)."""
    proc, t0 = started
    try:
        out, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} failed ({proc.returncode}) after {wall:.1f} s:\n"
          + out[-4000:])
    return out, wall


NOTEBOOK = "instageo_tpu_torch/notebooks/InstaGeo_Demo.ipynb"
NOTEBOOK_RESULTS = "[notebook results] "


def _notebook_script(path: str) -> str:
    """A notebook's code cells, concatenated (what a kernel runs top to
    bottom), and one last statement of this script's: the launch counters
    (``utils/telemetry.py:kernel_launches``), the test metrics, the
    predictions, the artifact and the checkpoint, as one JSON line."""
    with open(path) as f:
        nb = json.load(f)
    code = "\n\n".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code")
    return code + (
        "\n\nimport json as _json\n"
        "from instageo_tpu_torch.utils.telemetry import kernel_launches as _launches\n"
        f"print({NOTEBOOK_RESULTS!r} + _json.dumps(dict(\n"
        "    launches=_launches(), predictions=len(preds), artifact=artifact, checkpoint=ckpt,\n"
        "    test_metrics={k: v for k, v in metrics.items() if isinstance(v, (int, float))})))\n")


def _quickstart_artifact_check(device, root: str, results: dict) -> dict:
    """The quickstart's export artifact, loaded here, against a
    ``ModelServer`` of its checkpoint on one batch of its chips (8):
    class ids on decided pixels (>= ARTIFACT_AGREEMENT)."""
    import torch

    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.serve.export import load_predict
    from instageo_tpu_torch.serve.infer import make_predict_fn
    from instageo_tpu_torch.serve.server import ModelServer

    cfg = load_config("config", os.path.join(root, "run", ".hydra"),
                      overrides={"checkpoint_path": results["checkpoint"],
                                 "device": device.type})
    server = ModelServer(cfg)
    raw = []
    for i in range(8):
        with GeoTiffReader(os.path.join(root, f"chip_{i}.tif")) as r:
            raw.append(r.read())
    x = _server_chips(server, np.stack(raw), device)
    predict, meta = load_predict(results["artifact"])
    got = predict(server.model.state_dict(), x)
    with torch.inference_mode():
        logits = server.model(x, channels_last=True).float()
    top2 = logits.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * logits.abs().max()
    same = got == make_predict_fn(server.model)(x)
    agreement = same[decided].float().mean().item()
    check(meta["device"] == device.type and agreement >= ARTIFACT_AGREEMENT,
          f"the quickstart's artifact vs the server: {agreement} of decided pixels "
          f"({int(decided.sum())}), artifact on {meta['device']}")
    return dict(agreement=agreement, decided=int(decided.sum()), pixels=int(decided.numel()))


def examples_phase(device, smi: str, nproc=None) -> dict:
    """The port's walkthroughs (``instageo_tpu_torch/examples/``), each in
    a fresh interpreter as a user runs it, on ``device``:

    * ``quickstart.py``: synthetic chips, ``mode=train`` (3 epochs of
      ``prithvi_eo_tiny`` at 32 px, batch 8), ``eval``, ``chip_inference``,
      the map, ``mode=export``; its wall seconds, its launches by kernel
      (``quickstart_results.json``: on the card #1 and #3 on the wgmma
      route, none on mma.sync, #6 5 per step: the head's dropouts), finite
      test metrics, and its artifact against a ``ModelServer`` of its
      checkpoint here;
    * ``NOTEBOOK`` (``InstaGeo_Demo.ipynb``, the same work in notebook
      form) beside it: its code cells concatenated and run in one fresh
      interpreter with ``INSTAGEO_DEVICE`` the device, a last statement
      printing the launch counters (``_notebook_script``); held as the
      quickstart is: its wall seconds, the same launches by kernel and
      route, finite test metrics, ``predict.pt2`` against a ``ModelServer``
      of its checkpoint;
    * ``multichip_training.py`` under ``python -m torch.distributed.run
      --standalone --nproc-per-node <nproc>`` (the visible cards): each
      placement's loss at both steps (the second after its own AdamW step)
      within MULTICHIP_LOSS_ATOL of data parallelism's, no attention kernel launched (float32: the "xla"
      route) and #6 5 per step (its float32 dropouts), and the placements a
      world this size cannot hold named;
    * ``raster_chip_creator_demo.py`` with ``--device`` the card and the
      CPU: every file equal byte for byte, with each run's own directory
      taken out of them.

    All five run side by side, each in a process group of its own."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    dev = device.type
    nproc = torch.cuda.device_count() if nproc is None else nproc
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Every walkthrough runs side by side with the others: their results
        # are held, and each one's seconds are its own process's under that
        # load. The quickstart and the notebook do the same work, and each
        # is held to the same launches.
        qs, nbw = os.path.join(tmp, "quickstart"), os.path.join(tmp, "notebook")
        mc = os.path.join(tmp, "multichip")
        rd = [(d, os.path.join(tmp, f"raster_{i}")) for i, d in enumerate((dev, "cpu"))]
        script = os.path.join(tmp, "notebook.py")
        with open(script, "w") as f:
            f.write(_notebook_script(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  NOTEBOOK)))
        started = {"quickstart": _example_start(
            [sys.executable, "-m", "instageo_tpu_torch.examples.quickstart", qs, "--device",
             dev]),
            "notebook": _example_start([sys.executable, script],
                                       env={"INSTAGEO_DEVICE": dev, "DEMO_DIR": nbw}),
            "multichip": _example_start(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(nproc), "-m",
                 "instageo_tpu_torch.examples.multichip_training", mc, "--device", dev])}
        for i, (d, path) in enumerate(rd):
            started[f"raster_{i}"] = _example_start(
                [sys.executable, "-m", "instageo_tpu_torch.examples.raster_chip_creator_demo",
                 path, "--device", d])
        # One thread per walkthrough reads its output and times it to its end.
        with ThreadPoolExecutor(len(started)) as pool:
            done = dict(zip(started, pool.map(lambda kv: _example_wait(kv[1], f"the {kv[0]}"),
                                              started.items())))
        stdout, wall = done["quickstart"]
        check("map.html in a browser" in stdout, "the quickstart printed no map line")
        with open(os.path.join(qs, "quickstart_results.json")) as f:
            results = json.load(f)
        nb_out, nb_wall = done["notebook"]
        check("predict.pt2" in nb_out and f"device: {dev}" in nb_out,
              "the notebook printed no artifact or device line")
        nb_results = json.loads(nb_out.split(NOTEBOOK_RESULTS, 1)[1].splitlines()[0])
        steps = 3 * math.ceil(16 / 8)  # 3 epochs of the 16 chips at batch 8
        check(len(results["train_step_losses"]) * 3 == steps, f"quickstart results {results}")
        for name, res, root, seconds in (("quickstart", results, qs, wall),
                                         ("notebook", nb_results, nbw, nb_wall)):
            launches = res["launches"]
            check(all(math.isfinite(v) for v in res["test_metrics"].values())
                  and res["test_metrics"] and res["predictions"] == 16,
                  f"{name} results {res}")
            # Forwards through the depth-4 encoder: each train step, a
            # validation pass over the chips after each of the 3 epochs, the
            # eval and chip inference passes, and the export's eager call
            # (the complexity count runs on the plain route).
            batches = math.ceil(res["predictions"] / 8)
            forwards = steps + 3 * batches + 2 * batches + 1
            if dev == "cuda":
                check(launches["flash_attn_fwd_sm90"] == 4 * forwards
                      and launches["flash_attn_bwd_sm90"] == 4 * steps
                      and launches["fused_dropout"] == 5 * steps
                      and launches["flash_attn_fwd"] == 0 and launches["flash_attn_bwd"] == 0,
                      f"the {name}'s launches {launches}: #1 4 per forward over {forwards} "
                      f"forwards, #3 4 per step and #6 5 per step (the head's dropouts) over "
                      f"{steps} steps, all on wgmma, none on mma.sync")
            out[name] = dict(wall_s=seconds, launches=launches, steps=steps,
                             test_metrics=res["test_metrics"],
                             artifact=_quickstart_artifact_check(device, root, res))
        out["quickstart"].update(process_wall_s=results["wall_s"],
                                 train_step_losses=results["train_step_losses"])
        for name in ("quickstart", "notebook"):
            print(f"[examples] {name} " + json.dumps({"card": smi, **out[name]}), flush=True)

        stdout, wall = done["multichip"]
        check("multichip walkthrough OK" in stdout, "the multichip walkthrough printed no OK")
        with open(os.path.join(mc, "multichip_results.json")) as f:
            mres = json.load(f)
        placed = mres["placements"]
        dp_losses = placed["data parallel"]["step_losses"]
        gaps = {t: max(abs(a - b) for a, b in zip(p["step_losses"], dp_losses))
                for t, p in placed.items()}
        check(mres["world"] == nproc and all(g <= MULTICHIP_LOSS_ATOL for g in gaps.values())
              and all(len(p["step_losses"]) == 2 for p in placed.values()),
              f"multichip step losses off data parallelism's: {gaps}")
        mc_steps = sum(len(p["step_losses"]) for p in placed.values())
        check(dev != "cuda" or mres["launches"] == {
            "flash_attn_fwd_sm90": 0, "flash_attn_fwd": 0, "flash_attn_bwd_sm90": 0,
            "flash_attn_bwd": 0, "fused_dropout": 5 * mc_steps},
              f"the float32 walkthrough's launches {mres['launches']}: no attention kernel "
              f"(the xla route), #6 5 per step over {mc_steps} steps (the head's dropouts)")
        check(len(placed) + len(mres["skipped"]) == 4, f"placements {list(placed)}")
        out["multichip"] = dict(wall_s=wall, world=mres["world"], gaps=gaps,
                                losses={t: p["step_losses"] for t, p in placed.items()},
                                placements={t: p["qkv_placement"] for t, p in placed.items()},
                                skipped=mres["skipped"], launches=mres["launches"])
        print("[examples] multichip " + json.dumps({"card": smi, **out["multichip"]}),
              flush=True)

        trees = []
        for i, (_, path) in enumerate(rd):
            check("2 chips + 2 seg maps" in done[f"raster_{i}"][0], f"the raster demo {i}: "
                  "no marker")
            # The files name their own directory: compare with it taken out.
            trees.append({k: v.replace(path.encode(), b"<root>")
                          for k, v in _tree(path).items()})
        check(trees[0] == trees[1] and len(trees[1]) > 0,
              "the raster demo's files differ between the card and the CPU: "
              f"{sorted(k for k in trees[1] if trees[0].get(k) != trees[1][k])}")
        out["raster_demo"] = dict(files=len(trees[1]), devices=[d for d, _ in rd])
        print("[examples] raster_chip_creator_demo " + json.dumps(
            {"card": smi, **out["raster_demo"]}), flush=True)
    return out


def _build_native() -> None:
    """Build the native GeoTIFF decoder (``instageo_tpu_torch/native``) and
    say what the machine offers it: zlib's header, zlib's runtime library,
    and whether the decoder loaded, with the reason where it did not."""
    import ctypes.util

    from instageo_tpu_torch import native

    import shutil

    found = shutil.which("g++") is not None and subprocess.run(
        ["g++", "-E", "-x", "c++", "-", "-o", os.devnull], input="#include <zlib.h>\n",
        capture_output=True, text=True).returncode == 0
    print(f"[build] zlib.h for g++: {'found' if found else 'missing'}; "
          f"libz: {ctypes.util.find_library('z') or 'not found'}", flush=True)
    if native.available():
        print(f"[build] native decoder: {native.lib_path()}", flush=True)
    else:
        print(f"[build] native decoder unavailable: {native.unavailable_reason}", flush=True)


def _kernel_row(name: str, source: str, replaces: str, also, row: dict,
                launches: dict, rows: list) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "also_replaces": also, "launches": launches["train"], "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["shape"],
        "device_ms": row.get("device_ms"), "library_device_ms": row.get("library_device_ms"),
    }


def main() -> int:
    # Deterministic cuBLAS for the graph phase's deterministic run; read
    # when CUDA starts.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from instageo_tpu_torch.ops import _build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    # Imported in a child interpreter: this process stays without them.
    probe = subprocess.run([sys.executable, "-c", (
        "import importlib\n"
        "for m in ('pyarrow', 'pandas'):\n"
        "    try:\n"
        "        print(f'{m} {importlib.import_module(m).__version__} imports')\n"
        "    except ImportError as e:\n"
        "        print(f'{m} does not import ({e})')\n")],
        capture_output=True, text=True, timeout=300)
    print("[host] " + "; ".join(probe.stdout.split("\n")[:2]) + " (the port reads and "
          "writes Parquet with instageo_tpu_torch/data/parquet.py either way)", flush=True)

    t0 = time.perf_counter()
    names = _build.sources()
    native_build = threading.Thread(target=_build_native)
    native_build.start()
    _build.build(names)
    native_build.join()
    print(f"[build] {', '.join(n + '.cu' for n in names)} and the native decoder in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "setmaxnreg" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    clock = Clock("main")
    rows = kernel_phase(device, KERNEL_SHAPES)
    bwd_rows = bwd_kernel_phase(device, BWD_SHAPES)
    deterministic_bwd_phase(device)
    drop_rows = dropout_phase(device, DROPOUT_SHAPES)
    clock.lap("kernels")
    crop_cfg, crop_model, crop_train_cfg, crop_data = crop_setup()
    served = slice_phase(device, crop_cfg, crop_model, crop_data)
    clock.lap("slice")
    print(f"[slice] {smi}: chips/s " + ", ".join(
        f"batch {b}: {r:.2f}" for b, r in served["chips_per_s"].items()), flush=True)
    trained = train_phase(device, crop_model, crop_train_cfg, crop_data)
    clock.lap("train")
    print(f"[train] {smi}: " + ", ".join(
        f"batch {b}: {r['ms_per_step']:.3f} ms per step, {r['chips_per_s']:.2f} chips/s"
        for b, r in trained["rates"].items()), flush=True)
    graphed = graph_phase(device, crop_model, crop_train_cfg, crop_data)
    clock.lap("graph")
    print(f"[graph] {smi}: " + ", ".join(
        f"batch {b}: {r['eager']:.3f} ms per step eager, {r['captured']:.3f} captured"
        for b, r in graphed["rates"].items()) + ", eval: {eager:.3f} ms per batch eager, "
        "{captured:.3f} captured".format(**graphed["eval_ms"]), flush=True)
    loaded = loader_phase(device, crop_model, crop_data)
    clock.lap("loader")
    print(f"[loader] {smi}: batch jobs " + ", ".join(
        f"{k} {v:.2f} chips/s" for k, v in loaded["batch_job_chips_per_s"].items()), flush=True)
    ran = run_phase(device)
    clock.lap("run")
    for ok, msg in graphed["checks"]:  # the graph phase's training comparisons
        check(ok, msg)
    print(f"[run] {smi}: " + ", ".join(
        f"mode={m}: {ran['chips_per_s'][m]:.2f} chips/s, {ran['wall_s'][m]:.3f} s wall"
        for m in ran["wall_s"]), flush=True)
    replicated = replica_phase(device, smi)
    clock.lap("replica")
    print(f"[replica] {smi}: " + ", ".join(
        f"{name} {st['wall_s']:.3f} s" for name, st in replicated["stages"].items())
        + f"; mode=replica {replicated['wall_s']:.3f} s wall", flush=True)
    # serve_models' and quant's export artifacts run in the granule phase's
    # second fresh interpreter, before its granule.
    art_dir = tempfile.TemporaryDirectory()
    models = serve_models_phase(device, smi, artifact_dir=art_dir.name)
    clock.lap("serve_models")
    print(f"[serve_models] {smi}: batch 64 " + ", ".join(
        f"{head} head {r['ms']:.3f} ms per predict" for head, r in models["heads"]["timing"].items())
        + "; " + ", ".join(f"gelu {g} {r['ms']:.3f} ms" for g, r in models["gelu"].items()),
        flush=True)
    quantized = quant_phase(device, smi, artifact_dir=art_dir.name)
    clock.lap("quant")
    print(f"[quant] {smi}: batch 64 int8 {quantized['timing']['int8']['ms']:.3f} ms per "
          f"predict, bf16 {quantized['timing']['bf16']['ms']:.3f}; fc1 GEMM "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in quantized["gemm"]["ms"].items()), flush=True)
    granuled = granule_phase(device, smi, artifacts=[models["artifact_job"],
                                                     quantized["artifact_job"]])
    shared = granuled.pop("artifacts")
    models["serving"] = serving_row(smi, models.pop("serving_row"), _artifact_verify(
        models.pop("artifact_job"), shared["artifacts"][0], shared["models_imported"]))
    quantized["artifact"] = quant_artifact_row(_artifact_verify(
        quantized.pop("artifact_job"), shared["artifacts"][1], shared["models_imported"]))
    art_dir.cleanup()
    clock.lap("granule")
    print(f"[granule] {smi}: " + "; ".join(
        f"batch {b}: decode {r['decode_s']:.3f} s, to the device {r['h2d_s']:.3f} s, device "
        f"{r['device_s']:.3f} s (first batch {r['first_batch_s']:.3f} s), granule wall "
        f"{r['granule_wall_s']:.3f} s, {r['chips_per_s']:.2f} chips/s "
        f"({r['device_chips_per_s']:.2f} on the device), peak "
        f"{r['peak_device_bytes'] / 2**30:.3f} GiB" for b, r in granuled["runs"].items())
        + "; fresh interpreters at batch 8: " + "; ".join(
            f"{name}: device {r['device_s']:.3f} s (first batch {r['first_batch_s']:.3f} s), "
            f"granule wall {r['granule_wall_s']:.3f} s, process {r['process_wall_s']:.3f} s"
            for name, r in granuled["fresh"].items()), flush=True)
    chip_ms = chip_ops_phase(device, granuled.pop("bands"), granuled.pop("fmask"))
    clock.lap("chip_ops")
    print(f"[chip_ops] {smi}: process_tile_chips " + ", ".join(
        f"{s} {m['device']:.1f} ms on the card, {m['cpu']:.1f} on the CPU"
        for s, m in chip_ms.items()), flush=True)
    kept = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    created = chip_creator_phase(device, smi, keep=kept.name)
    phase_s = time.perf_counter() - t0
    clock.lap("chip_creator")
    card, host = created["runs"]["card"], created["runs"]["cpu"]
    print(f"[chip_creator] {smi}: phase wall {phase_s:.3f} s; {created['chips']} chips; wall "
          f"{card['wall_s']:.3f} s on the card ({host['wall_s']:.3f} on the CPU), decode "
          f"{card['decode_s']:.3f} s, process_tile_chips "
          f"{card['process_tile_chips_s']:.3f} s on the card "
          f"({host['process_tile_chips_s']:.3f} on the CPU), peak "
          f"{card['peak_device_bytes'] / 2**30:.3f} GiB; chip_inference "
          f"{created['chip_inference']['wall_s']:.3f} s; raster "
          f"{created['raster']['chips']} chips in {created['raster']['wall_s']['card']:.3f} s",
          flush=True)
    prepared = data_prep_phase(device, smi, kept.name)
    kept.cleanup()
    clock.lap("data_prep")
    print(f"[data_prep] {smi}: cleaner {prepared['cleaner']['buffer_s']:.3f} s (drop + buffer, "
          f"{prepared['cleaner']['chips']} chips) + {prepared['cleaner']['limit_s']:.3f} s "
          f"(limit, {prepared['cleaner']['limit_chips']}); splitter "
          f"{prepared['splitter']['split_s']:.3f} s; libopenjp2 "
          f"{'loads' if prepared['libopenjp2']['loads'] else 'missing'}; matplotlib "
          f"{'present' if prepared['matplotlib'] else 'missing'}", flush=True)
    web = webapp_phase(device, smi)
    clock.lap("webapp")
    print(f"[webapp] {smi}: {web['chips']} chips, POST to completed {web['wall_s']:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in web["stages_s"].items()) + "); map tiles "
          + ", ".join(f"{k}: p50 {web['tiles'][k]['p50_ms']:.3f} ms, p99 "
                      f"{web['tiles'][k]['p99_ms']:.3f} ms, {web['tiles'][k]['tiles_per_s']:.2f} "
                      "tiles/s" for k in ("cold", "warm"))
          + f"; in-process stage 2 + 3 {web['inproc_s']['kernel']:.3f} s", flush=True)

    para = parallel_phase(device, smi, crop_model, crop_train_cfg, crop_data)
    clock.lap("parallel")
    walked = examples_phase(device, smi)
    clock.lap("examples")
    print(f"[examples] {smi}: quickstart {walked['quickstart']['wall_s']:.3f} s wall, launches "
          + json.dumps(walked["quickstart"]["launches"]) + "; InstaGeo_Demo.ipynb "
          f"{walked['notebook']['wall_s']:.3f} s wall beside it, launches "
          + json.dumps(walked["notebook"]["launches"]) + "; multichip at world "
          f"{walked['multichip']['world']}: step losses "
          + ", ".join(f"{t} {v[0]:.6f} / {v[1]:.6f}" for t, v in walked["multichip"]["losses"].items())
          + "".join(f"; {t} skipped ({r})" for t, r in walked["multichip"]["skipped"].items())
          + f"; raster demo {walked['raster_demo']['files']} files, card = CPU byte for byte",
          flush=True)

    # Each kernel's row is at the training step's shape (batch 8).
    at = lambda rows, shape: next(r for r in rows if r["shape"] == list(shape))  # noqa: E731
    csrc = "instageo_tpu_torch/ops/csrc/"
    # Each redesigned kernel beside its earlier design ("prev"), timed in
    # turns at the same shapes; the earlier design of the attention kernels
    # stays the route of the other head dims and is launched by neither path.
    prev = lambda rows: [dict(r, ms=r["prev_ms"], device_ms=r["prev_device_ms"],  # noqa: E731
                              max_abs_err=r["prev_max_abs_err"]) for r in rows]
    fwd = at(rows, (8, 12, 589, 64))
    fwd_mma = {"serve": served["other_launches"]["flash_attn_fwd_mma"],
               "train": trained["launches"]["flash_attn_fwd_mma"]}
    wgmma_rows = [r for r in rows if r["route"] == "wgmma"]
    bwd = at(bwd_rows, (8, 12, 589, 64))
    bwd_mma = {"serve": served["other_launches"]["flash_attn_bwd_mma"],
               "train": trained["launches"]["flash_attn_bwd_mma"]}
    bwd_wgmma_rows = [r for r in bwd_rows if r["route"] == "wgmma"]
    drop = at(drop_rows, DROPOUT_SHAPES[-1])
    drop_launches = {"serve": served["other_launches"]["fused_dropout"],
                     "train": trained["launches"]["fused_dropout"]}
    bwd_replaces = ("instageo_tpu/ops/attention.py:260",
                    ["instageo_tpu/ops/attention.py:187", "instageo_tpu/ops/attention.py:390"])
    kernels = [
        _kernel_row("flash_attn_fwd_sm90", csrc + "flash_attn_fwd_sm90.cu",
                    "instageo_tpu/ops/attention.py:225", "instageo_tpu/ops/attention.py:162",
                    fwd, {"serve": served["launches"] - fwd_mma["serve"],
                          "train": trained["launches"]["flash_attn_fwd"] - fwd_mma["train"]},
                    wgmma_rows),
        _kernel_row("flash_attn_fwd", csrc + "flash_attn_fwd.cu",
                    "instageo_tpu/ops/attention.py:225", "instageo_tpu/ops/attention.py:162",
                    prev(wgmma_rows)[wgmma_rows.index(fwd)], fwd_mma, prev(wgmma_rows)),
        _kernel_row("flash_attn_bwd_sm90", csrc + "flash_attn_bwd_sm90.cu", *bwd_replaces,
                    bwd, {"serve": served["other_launches"]["flash_attn_bwd"] - bwd_mma["serve"],
                          "train": trained["launches"]["flash_attn_bwd"] - bwd_mma["train"]},
                    bwd_wgmma_rows),
        _kernel_row("flash_attn_bwd", csrc + "flash_attn_bwd.cu", *bwd_replaces,
                    prev(bwd_wgmma_rows)[bwd_wgmma_rows.index(bwd)], bwd_mma,
                    prev(bwd_wgmma_rows)),
        _kernel_row("fused_dropout", csrc + "dropout.cu", "instageo_tpu/ops/dropout.py:33",
                    None, drop, drop_launches, drop_rows),
    ]
    by_shape = ("shape", "device_ms", "prev_device_ms", "library_device_ms", "ms", "prev_ms",
                "library_ms", "bound_ms", "seed_ptr_ms", "seed_ptr_device_ms",
                "seed_value_turns_ms", "seed_value_turns_device_ms")
    for k, rs in ((kernels[0], wgmma_rows), (kernels[2], bwd_wgmma_rows), (kernels[4], drop_rows)):
        k["by_shape"] = [{key: r.get(key) for key in by_shape + ("inputs", "entry")
                          if key in r} for r in rs]
    # The run CLI's launches, by mode and kernel (the same counters).
    by_route = {"flash_attn_fwd_sm90": lambda c: c["flash_attn_fwd"] - c["flash_attn_fwd_mma"],
                "flash_attn_fwd": lambda c: c["flash_attn_fwd_mma"],
                "flash_attn_bwd_sm90": lambda c: c["flash_attn_bwd"] - c["flash_attn_bwd_mma"],
                "flash_attn_bwd": lambda c: c["flash_attn_bwd_mma"],
                "fused_dropout": lambda c: c["fused_dropout"]}
    graph_by_route = {k["name"]: by_route[k["name"]](graphed["launches"]) for k in kernels}
    for k in kernels:
        k["card"] = smi
        k["launches_by_path"]["graph"] = graph_by_route[k["name"]]
        for mode, c in ran["counts"].items():
            k["launches_by_path"][f"run_{mode}"] = by_route[k["name"]](c)
        route = by_route[k["name"]]
        k["launches_by_path"]["serve_fast_head"] = route(models["heads"]["launches"]["fast"])
        k["launches_by_path"]["train_fast_head"] = route(models["train_step"]["launches"])
        for b, r in granuled["runs"].items():
            k["launches_by_path"][f"granule_batch{b}"] = route(r["launches"])
        k["launches_by_path"][f"granule_overlap{GRANULE_OVERLAP}"] = route(
            granuled["overlap"]["launches"])
        k["launches_by_path"]["chip_creator"] = 0  # checked: chip creation launches none
        k["launches_by_path"]["chip_creator_chip_inference"] = route(
            created["chip_inference"]["launches"])
        for stage, st in replicated["stages"].items():
            k["launches_by_path"][f"replica_{stage}"] = route(st["counts"])
        k["launches_by_path"]["quant_int8_predict"] = route(quantized["launches"]["int8"])
        k["launches_by_path"]["quant_f32_predict"] = route(quantized["f32"]["launches"])
        k["launches_by_path"]["webapp"] = route(web["launches"])
        k["launches_by_path"]["webapp_job_process"] = route(web["worker_launches"])
        for name in ("recipe", "twin"):  # rank 0's train epoch
            k["launches_by_path"][f"parallel_{name}"] = para[name]["train_launches"][0][k["name"]]
        for name in ("plain", "remat"):
            k["launches_by_path"][f"parallel_{name}_crop"] = route(
                para["remat"]["launches"][name])
        k["launches_by_path"]["examples_quickstart"] = walked["quickstart"]["launches"][k["name"]]
        k["launches_by_path"]["examples_notebook"] = walked["notebook"]["launches"][k["name"]]
        k["launches_by_path"]["examples_multichip"] = walked["multichip"]["launches"][k["name"]]
        for variant, row in models["variants"].items():
            k["launches_by_path"][f"serve_{variant}"] = (
                row["fwd_launches_per_predict"] - row["mma_sync_launches"]
                if k["name"] == "flash_attn_fwd_sm90" else
                row["mma_sync_launches"] if k["name"] == "flash_attn_fwd" else 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
