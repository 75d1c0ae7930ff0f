#!/usr/bin/env python3
"""Where the PyTorch port's serving forward spends its time, on one CUDA card.

    python3 tools/profile_torch_serve.py [--batch 64] [--iters 3]

Builds Prithvi-V1-100M as the multi-temporal crop config serves it (T=3,
224 px, 13 classes, bf16, random weights from seed 0) and prints, for one
batch of raw uint16 chips:

- CUDA-event times of the fused predict, the encoder alone and the head
  alone (``head`` = the model minus the encoder);
- a ``torch.profiler`` trace of the fused predict: device time by kernel
  class (the port's attention kernel, matmuls, convolutions, other) and the
  top kernels by name, with the device's busy share of the traced wall time.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MEAN = [494.905781, 815.239594, 924.335066, 2968.881459, 2634.621962, 1739.579917]
STD = [284.925432, 357.84876, 575.566823, 896.601013, 951.900334, 921.407808]


def kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attn_fwd" in n:
        return "attention (port kernel)"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "matmul")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other (norm, elementwise, reduce, layout)"


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: CUDA is not available", file=sys.stderr)
        return 2
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn, preprocess_chips

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = create_prithvi_seg("prithvi_eo_v1_100", num_classes=13, temporal_step=3,
                               image_size=224, num_bands=6, dtype=torch.bfloat16,
                               device=dev, seed=0)
    pre = dict(temporal_size=3, bands=list(range(18)), constant_multiplier=1.0,
               img_size=224)
    predict = make_fused_predict_fn(model, MEAN, STD, **pre)
    raw = np.random.default_rng(0).integers(0, 10000, (args.batch, 18, 224, 224),
                                            dtype=np.uint16)
    raw_dev = torch.from_numpy(raw.astype(np.int32)).to(dev)
    mean_t, std_t = (torch.tensor(v, device=dev) for v in (MEAN, STD))
    bands_t = torch.arange(18, device=dev)
    x = preprocess_chips(raw_dev, mean_t, std_t, temporal_size=3, bands=bands_t,
                         img_size=224)
    with torch.inference_mode():
        tokens = model.prithvi_encoder(x)

    def cuda_ms(fn) -> float:
        for _ in range(2):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    with torch.inference_mode():
        t_predict = cuda_ms(lambda: predict(raw_dev))
        t_model = cuda_ms(lambda: model(x, channels_last=True))
        t_encoder = cuda_ms(lambda: model.prithvi_encoder(x))
    del tokens
    times = {"fused_predict_ms": t_predict, "model_ms": t_model, "encoder_ms": t_encoder,
             "head_ms": t_model - t_encoder,
             "preprocess_argmax_ms": t_predict - t_model}
    print(f"[times] {card}, batch {args.batch}: " + json.dumps(times), flush=True)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            predict(raw_dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = dev_us / 1e3 / args.iters
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = sum(by_class.values())
    print(f"[profile] {card}, batch {args.batch}: device busy {busy:.3f} ms of "
          f"{wall_ms / args.iters:.3f} ms wall per call "
          f"({100 * busy * args.iters / wall_ms:.1f}%)", flush=True)
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[profile]   {ms:8.3f} ms  {name[:110]}", flush=True)
    return 0 if busy > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
