#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, one line each (any failure raises and exits non-zero):

1. device: the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build: every CUDA source under ``instageo_tpu_torch/ops/csrc``, in parallel;
3. kernels: each kernel (attention forward, attention backward, fused
   dropout) against its plain PyTorch version on the shapes the serving and
   training paths give it, with its time, the plain version's, one PyTorch
   library call's (a yardstick only) and the card's bound for the same work;
   each kernel's device time per call from ``torch.profiler`` beside its
   earlier design's at the same shapes, in turns: the attention routes by
   head dim (wgmma for Dh 64 and 80, beside the mma.sync kernels); the
   backward's dq run to run; the dropout's mask equal to the plain Philox
   stream bit for bit (and the earlier 4-element design's);
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
6. one JSON line ``{"kernels": [...]}``;
7. last line: ``{"ok": true, "device": {...}}``.

Each path runs with every launch count set to 0 just before it and read
just after it. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# Card peaks for the bound (H100 SXM data sheet, dense): bf16 tensor-core
# rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# configs/multitemporal_crop_classification.yaml, dataloader section.
CROP_MEAN = [494.905781, 815.239594, 924.335066, 2968.881459, 2634.621962, 1739.579917]
CROP_STD = [284.925432, 357.84876, 575.566823, 896.601013, 951.900334, 921.407808]
CROP_BANDS = list(range(18))
CROP_MODEL = dict(variant="prithvi_eo_v1_100", num_classes=13, temporal_step=3,
                  image_size=224, num_bands=6)

# configs/multitemporal_crop_classification.yaml, train and model sections.
CROP_CLASS_WEIGHTS = [0.386375, 0.661126, 0.548184, 0.640482, 0.876862, 0.925186,
                      3.249462, 1.542289, 2.175141, 2.272419, 3.062762, 3.626097,
                      1.198702]
CROP_TRAIN_CFG = {
    "train": {"learning_rate": 1e-4, "weight_decay": 0.01, "batch_size": 8,
              "num_epochs": 1, "class_weights": CROP_CLASS_WEIGHTS,
              "ignore_index": -1, "scheduler": False},
    "model": {"num_classes": 13, "freeze_backbone": False, "weight_clip_range": None},
}

# (B, H, L, Dh, output layout, inputs): the serving shape at batch 64, also
# as the model passes q/k/v ("qkv": views of one (B, L, 3, H, Dh) projection
# buffer, models/prithvi.py), the training shape at batch 8, the T=1 length
# 197, and the 600M variant's heads-first shapes (Dh=80); other rows take
# contiguous q/k/v.
KERNEL_SHAPES = [
    (64, 12, 589, 64, "merged", "contiguous"),
    (64, 12, 589, 64, "merged", "qkv"),
    (8, 12, 589, 64, "merged", "contiguous"),
    (8, 12, 197, 64, "merged", "contiguous"),
    (16, 16, 513, 80, "heads_first", "contiguous"),
    (4, 16, 1025, 80, "heads_first", "contiguous"),
]
# The forward kernels' symbols, by route, as the profiler names them.
FWD_KERNEL_SYMBOL = {"wgmma": "flash_attn_fwd_sm90_kernel", "mma_sync": "flash_attn_fwd_kernel"}
# The dropout kernels' symbols: the wrapper's (8 elements per thread) and
# the earlier design's (4).
DROPOUT_SYMBOL = ("fused_dropout_kernel", "fused_dropout_x4_kernel")
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
]
# The five dropout inputs of one batch-8 training step of the crop model: the
# four upscaling blocks' ConvTranspose outputs and the head's last dropout.
DROPOUT_SHAPES = [(8, 1152, 28, 28), (8, 576, 56, 56), (8, 288, 112, 112),
                  (8, 144, 224, 224), (8, 144, 224, 224)]
O_TOL = 3e-2    # bf16 output, atol = rtol (the JAX package's bf16 attention test)
LSE_TOL = 1e-3  # float32 row statistics, other summation order
# Backward kernel vs plain: both round dS and P to bf16 at the TPU kernel's
# points but sum in other orders, so single elements can differ by a bf16
# rounding; the whole gradient must agree to 1e-2 of its norm.
BWD_REL_TOL = 1e-2
# The wgmma backward adds dQ's f32 partial sums in an order that changes from
# run to run: a dq element stays within one bf16 step of itself, or, where
# the partial sums cancel, within a few float32 roundings of them, far below
# this share of its row's largest |dq|.
DQ_RUN_TO_RUN_ROW = 2.0 ** -16
KEEP_SIGMAS = 5.0  # dropout keep fraction within 5 binomial sigma of 1 - p
# One bf16 training step with the kernels vs with the plain versions
# (dropout off): other summation orders through 12 bf16 blocks. Gradients:
# ‖Δ‖ ≤ tol·‖plain gradient‖ per parameter. The median parameter differs by
# about 4e-3; the first head stage, which takes the encoder's bf16 output
# through a BatchNorm, by up to 3.4e-2 on an H100 (a wrong stride or a
# wrong wiring would give differences of order 1).
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_BN_REL_TOL = 2e-2
# Kernel vs plain attention through 12 bf16 blocks: the two differ only in
# summation order, so the logits may differ by a few bf16 roundings.
LOGIT_TOL = 0.05         # max |logit diff| / max |logit|
DECIDED_GAP = 0.01       # pixels whose top-2 gap is at least this x max |logit| ...
ARGMAX_AGREEMENT = 0.99  # ... agree at least this often


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


def device_ms(fn, iters: int = 20, warmup: int = 2, match=None, attempts: int = 3) -> float:
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


def _run_to_run(a, b) -> dict:
    """How far two runs' bf16 dq lie apart: the largest |Δ| in bf16 steps of
    the element (2⁻⁷ of its magnitude), how many elements differ by more,
    and the largest |Δ| over its row's largest |dq|."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    step = a.abs().maximum(b.abs()) * 2.0 ** -7
    row = a.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return dict(max_bf16_steps=(diff / step.clamp_min(1e-30)).max().item(),
                over_one_step=int((diff > step).sum()), max_of_row_max=(diff / row).max().item(),
                within=bool((diff <= step.maximum(row * DQ_RUN_TO_RUN_ROW)).all()))


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
    ``bwd_route`` gives; at a wgmma head dim dq run to run within one bf16
    step and dk, dv equal, and the mma.sync design ("prev") checked too and
    timed in turns with the wgmma kernel (new, prev, prev, new), by wrapper
    ms and by device ms per call (all three launches summed); SDPA's
    backward on its own forward, by wrapper ms and device ms."""
    import torch
    import torch.nn.functional as F

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
        row = dict(shape=[b, h, l, d], entry=entry, route=route, rel_err=rel, max_abs_err=err,
                   launches=launches)
        if route == "wgmma" and on_card:
            again = tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)
            row["dq_run_to_run"] = _run_to_run(grads[0], again[0])
            check(row["dq_run_to_run"]["within"]
                  and torch.equal(grads[1], again[1]) and torch.equal(grads[2], again[2]),
                  f"run to run: dq {row['dq_run_to_run']}, or dk/dv differ, at {what}")
            prev = tattn._flash_attention_bwd_cuda(q, k, v, o, do, lse, layout, "mma_sync")
            row["prev_rel_err"] = {f"d{n}": _rel_err(x, r) for n, x, r in zip("qkv", prev, refs)}
            row["prev_max_abs_err"] = max((x.float() - r.float()).abs().max().item()
                                          for x, r in zip(prev, refs))
            check(max(row["prev_rel_err"].values()) <= BWD_REL_TOL,
                  f"the mma.sync backward is off the plain version at {what}")
            del again, prev
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


def dropout_phase(device, shapes, p: float = 0.1, iters: int = 20) -> list:
    """Hold the dropout kernel's mask to the plain Philox stream and its
    output to ``dropout_apply`` on that mask, bit for bit, at ``shapes``;
    check its keep rate, streams and backward. Times the kernel and the
    earlier design ("prev", 4 elements per thread and step) in turns (new,
    prev, prev, new), by wrapper ms and device ms, beside ``F.dropout``."""
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
            prev_out, prev_mask = tdrop._fused_dropout_cuda(x, p, i, "x4")
            check(torch.equal(prev_mask, mask) and torch.equal(prev_out, out),
                  f"the earlier dropout design gives other bits at {shape}")
            del prev_out, prev_mask
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
            row.update(_in_turns(new, lambda: tdrop._fused_dropout_cuda(x, p, i, "x4"), device,
                                 iters, DROPOUT_SYMBOL))
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
    for counter in _counters().values():
        counter.reset()


def read_counts() -> dict:
    return {name: counter.count for name, counter in _counters().items()}


def _write_chips(root: str, n: int, raw: np.ndarray) -> list:
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    paths = []
    for i in range(n):
        path = os.path.join(root, f"tile_{i:03d}_chip.tif")
        transform = Affine.from_origin(300000.0 + 6720.0 * i, 4500000.0, 30.0, 30.0)
        write_geotiff(path, raw[i % len(raw)], transform=transform, crs=32615)
        paths.append(path)
    return paths


def _normalise(raw: np.ndarray, temporal_step: int) -> np.ndarray:
    """Host normalisation of one raw chip (T·C, H, W) -> (C, T, H, W)."""
    c = len(CROP_MEAN)
    x = raw.astype(np.float32).reshape(temporal_step, c, *raw.shape[-2:])
    mean = np.asarray(CROP_MEAN, np.float32)[None, :, None, None]
    std = np.asarray(CROP_STD, np.float32)[None, :, None, None]
    return ((x - mean) / std).transpose(1, 0, 2, 3)


def slice_phase(device, model_kw: dict, n_requests: int = 24, n_threads: int = 8,
                n_files: int = 32, batch: int = 16, throughput_batches=(16, 64),
                throughput_iters: int = 5) -> dict:
    """Serve the model: online requests + a batch run over chip files."""
    import torch

    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.ops import attention as tattn
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.serve.server import ModelServer

    t_build = time.perf_counter()
    model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, device=device, seed=0)
    t_build = time.perf_counter() - t_build
    depth = len(model.prithvi_encoder.blocks)
    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    pre = dict(temporal_size=t, bands=CROP_BANDS[: 6 * t], constant_multiplier=1.0,
               img_size=size)
    server = ModelServer(model, mean=CROP_MEAN, std=CROP_STD, device=device, **pre)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 10000, (8, 6 * t, size, size), dtype=np.uint16)
    tmp = tempfile.TemporaryDirectory()
    try:
        paths = _write_chips(tmp.name, n_files, raw)
        out_dir = os.path.join(tmp.name, "predictions")
        chips = [_normalise(raw[i % len(raw)], t) for i in range(n_requests)]

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
        with torch.inference_mode():
            logits_k = model(x, channels_last=True)
            for blk in model.prithvi_encoder.blocks:
                blk.attn.attn_impl = "plain"
            logits_p = model(x, channels_last=True)
            for blk in model.prithvi_encoder.blocks:
                blk.attn.attn_impl = "kernel"
        check(bool(torch.isfinite(logits_k).all()), "non-finite logits")
        same = logits_k.argmax(-1) == logits_p.argmax(-1)
        agree = same.float().mean().item()
        diff = (logits_k - logits_p).abs().max().item()
        scale = logits_p.abs().max().item()
        top2 = logits_p.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) >= DECIDED_GAP * scale
        agree_decided = same[decided].float().mean().item()
        check(diff <= LOGIT_TOL * scale, f"kernel/plain logits differ by {diff} of {scale}")
        check(agree_decided >= ARGMAX_AGREEMENT,
              f"kernel/plain argmax agreement {agree_decided} on decided pixels")
        print(f"[slice] kernel vs plain attention, batch 4: max |logit diff| {diff:.6g} "
              f"(<= {LOGIT_TOL} x max |logit| {scale:.6g}); argmax agreement {agree:.6f} "
              f"of all pixels, {agree_decided:.6f} (>= {ARGMAX_AGREEMENT}) of the "
              f"{decided.float().mean().item():.4f} whose top-2 gap >= {DECIDED_GAP} x "
              "max |logit|", flush=True)

        # --- throughput: raw uint16 chips in host memory -> int8 classes in
        # host memory, through the fused predict (host clock, synchronised
        # by the copy back) -----------------------------------------------
        predict = make_fused_predict_fn(model, CROP_MEAN, CROP_STD, **pre)
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


def _crop_batch(n: int, temporal_step: int, size: int, classes: int, seed: int):
    """Synthetic crop chips: uint16 raw bands normalised on the host, and
    labels constant over 16-px patches in [0, classes) with a band of -1
    (ignored) rows at the top."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 10000, (n, 6 * temporal_step, size, size), dtype=np.uint16)
    x = np.stack([_normalise(r, temporal_step) for r in raw])
    patches = rng.integers(0, classes, (n, size // 16, size // 16))
    y = np.repeat(np.repeat(patches, 16, axis=1), 16, axis=2).astype(np.int64)
    y[:, :8] = -1
    return x, y


def train_phase(device, model_kw: dict, cfg: dict, fixed_steps: int = 10,
                throughput_batches=(8, 32), throughput_steps: int = 6) -> dict:
    """Train the crop model through ``Trainer`` and check what each part
    gives (see the module docstring, phase 5)."""
    import torch

    from instageo_tpu_torch.models.seg import UpscalingBlock, create_prithvi_seg, train_mode
    from instageo_tpu_torch.train.trainer import Trainer

    t, size, classes = model_kw["temporal_step"], model_kw["image_size"], model_kw["num_classes"]
    batch = cfg["train"]["batch_size"]
    model = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                               device=device, seed=0)
    depth = len(model.prithvi_encoder.blocks)
    trainer = Trainer(cfg, model, device=device)
    x, y = _crop_batch(max(throughput_batches + (3 * batch,)), t, size, classes, seed=1)
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
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain = create_prithvi_seg(**model_kw, dtype=torch.bfloat16, param_dtype=torch.float32,
                               attn_impl="plain", dropout_impl="plain", device=device, seed=0)
    plain.load_state_dict(state)
    model.load_state_dict(state)
    step = {}
    for name, m in (("kernel", model), ("plain", plain)):
        train_mode(m, torch.Generator(), dropout_rate=0.0)
        tr = Trainer(cfg, m, device=device)
        loss = float(tr.train_step(xb, yb, torch.Generator()))
        step[name] = (loss, {n: p.grad for n, p in m.named_parameters()},
                      {n: b for n, b in m.named_buffers() if "running" in n})
    (loss_k, grads_k, bn_k), (loss_p, grads_p, bn_p) = step["kernel"], step["plain"]
    # The bias of a conv that feeds a BatchNorm has an exact gradient of 0
    # (BatchNorm subtracts each channel's batch mean), so both versions give
    # rounding noise there: it is held against its conv weight's gradient.
    scale_of = {f"{name}.2.bias": f"{name}.2.weight" for name, mod in model.named_modules()
                if isinstance(mod, UpscalingBlock)}
    grad_rel = {n: ((grads_k[n].float() - grads_p[n].float()).norm()
                    / grads_p[scale_of.get(n, n)].float().norm().clamp_min(1e-30)).item()
                for n in grads_p}
    bn_rel = {n: _rel_err(bn_k[n], bn_p[n]) for n in bn_p}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]
    print(f"[train] kernel vs plain step (dropout off): loss {loss_k:.6f} vs {loss_p:.6f} "
          f"(rel {loss_rel:.3g} <= {TRAIN_LOSS_REL_TOL}); gradient rel err max "
          f"{worst[0][1]:.4g}, median {float(np.median(list(grad_rel.values()))):.4g} over "
          f"{len(grad_rel)} params (<= {TRAIN_GRAD_REL_TOL}; the {len(scale_of)} conv biases "
          f"ahead of BatchNorm against their weight's gradient; worst {json.dumps(worst)}); "
          f"BN running stats rel err max {max(bn_rel.values()):.4g} (<= {TRAIN_BN_REL_TOL})",
          flush=True)
    check(loss_rel <= TRAIN_LOSS_REL_TOL, f"kernel/plain loss {loss_k} vs {loss_p}")
    check(worst[0][1] <= TRAIN_GRAD_REL_TOL, f"kernel/plain gradients differ: {worst}")
    check(max(bn_rel.values()) <= TRAIN_BN_REL_TOL, f"BN running stats differ: {bn_rel}")
    del plain, step, grads_k, grads_p, state
    train_mode(model, gen, dropout_rate=0.1)
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

    t0 = time.perf_counter()
    names = _build.sources()
    _build.build(names)
    print(f"[build] {', '.join(n + '.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in names:
        for line in _build.build_logs.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "setmaxnreg" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    rows = kernel_phase(device, KERNEL_SHAPES)
    bwd_rows = bwd_kernel_phase(device, BWD_SHAPES)
    drop_rows = dropout_phase(device, DROPOUT_SHAPES)
    served = slice_phase(device, CROP_MODEL)
    print(f"[slice] {smi}: chips/s " + ", ".join(
        f"batch {b}: {r:.2f}" for b, r in served["chips_per_s"].items()), flush=True)
    trained = train_phase(device, CROP_MODEL, CROP_TRAIN_CFG)
    print(f"[train] {smi}: " + ", ".join(
        f"batch {b}: {r['ms_per_step']:.3f} ms per step, {r['chips_per_s']:.2f} chips/s"
        for b, r in trained["rates"].items()), flush=True)

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
                "library_ms", "bound_ms")
    for k, rs in ((kernels[0], wgmma_rows), (kernels[2], bwd_wgmma_rows), (kernels[4], drop_rows)):
        k["by_shape"] = [{key: r.get(key) for key in by_shape + ("inputs", "entry")
                          if key in r} for r in rs]
    for k in kernels:
        k["card"] = smi
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
