#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py      # from the repository root; needs one CUDA card

Phases, one line each (any failure raises and exits non-zero):

1. device: the card, as ``nvidia-smi --query-gpu=name,power.limit`` reports it;
2. build: every CUDA source under ``instageo_tpu_torch/ops/csrc``, in parallel;
3. kernels: each kernel against its plain PyTorch version on the shapes the
   serving path gives it, with its time, the plain version's, one PyTorch
   library call's (a yardstick only) and the card's bound for the same work;
4. slice: Prithvi-V1-100M at full width (T=3, 224 px, 13 classes, bf16,
   random weights from a seed) behind ``ModelServer``: online requests from
   8 threads through the dynamic batcher and one batch run over synthetic
   18-band chip files; the kernel launch count of that run; kernel-vs-plain
   logits on one batch; chips/s at batch 16 and 64;
5. one JSON line ``{"kernels": [...]}``;
6. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
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

# (B, H, L, Dh, output layout): the slice's shape at batch 64 and 8 (L=589
# and the T=1 length 197), and the 600M variant's heads-first shapes (Dh=80).
KERNEL_SHAPES = [
    (64, 12, 589, 64, "merged"),
    (8, 12, 197, 64, "merged"),
    (16, 16, 513, 80, "heads_first"),
    (4, 16, 1025, 80, "heads_first"),
]
O_TOL = 3e-2    # bf16 output, atol = rtol (the JAX package's bf16 attention test)
LSE_TOL = 1e-3  # float32 row statistics, other summation order
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


def attention_bound(b: int, h: int, l: int, d: int):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * 2 + b * h * l * 4  # q, k, v, O bf16; lse f32
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(device, shapes, iters: int = 20) -> list:
    """Hold the attention kernel against its plain version at ``shapes``."""
    import torch
    import torch.nn.functional as F

    from instageo_tpu_torch.ops import attention as tattn

    results = []
    for i, (b, h, l, d, layout) in enumerate(shapes):
        g = torch.Generator(device=device).manual_seed(i)
        q, k, v = (torch.randn((b, h, l, d), generator=g, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        launched = tattn.launches.count
        o, lse = tattn.flash_attention_fwd(q, k, v, layout)
        o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, layout)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        check(torch.allclose(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL),
              f"O off the plain version at {(b, h, l, d, layout)}: max {err}")
        check(lse_err <= LSE_TOL, f"lse off by {lse_err} at {(b, h, l, d)}")
        ms = time_ms(lambda: tattn.flash_attention_fwd(q, k, v, layout), device, iters)
        plain_ms = time_ms(lambda: tattn.flash_attention_fwd_plain(q, k, v, layout),
                           device, max(2, iters // 4))
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), device, iters)
        bound_ms, bound_by = attention_bound(b, h, l, d)
        row = dict(shape=[b, h, l, d], layout=layout, max_abs_err=err,
                   lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                   library_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
                   launches=tattn.launches.count - launched)
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
            try:
                tattn.flash_attention_fwd(x, x, x)
            except exc:
                continue
            raise RuntimeError(f"the kernel wrapper took a {what} input")
        print("[kernels] float32 and Dh=72 inputs on the card raise", flush=True)
    return results


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

        # --- the main path: counts from 0, read right after -------------
        tattn.launches.reset()
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
        print(f"[slice] served {n_requests} online requests from {n_threads} threads in "
              f"{batcher.batches_run} batches ({online_s:.3f} s) and {n_files} chip files "
              f"({run['chips_per_sec']:.2f} chips/s incl. decode+write); "
              f"{launches} attention launches = {depth} x {forwards} forwards; "
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
    return dict(launches=launches, forwards=forwards, agreement=agree,
                max_logit_diff=diff, chips_per_s=rates, build_s=t_build)


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
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    rows = kernel_phase(device, KERNEL_SHAPES)
    got = slice_phase(device, CROP_MODEL)
    print(f"[slice] {smi}: chips/s " + ", ".join(
        f"batch {b}: {r:.2f}" for b, r in got["chips_per_s"].items()), flush=True)

    main_row = rows[0]
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "instageo_tpu_torch/ops/csrc/flash_attn_fwd.cu",
        "replaces": "instageo_tpu/ops/attention.py:225",
        "also_replaces": "instageo_tpu/ops/attention.py:162",
        "launches": got["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "card": smi,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
