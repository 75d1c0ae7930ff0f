#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time, on one CUDA card.

    python3 tools/profile_torch_train.py [--batch 8] [--iters 3]

Builds Prithvi-V1-100M as the multi-temporal crop config trains it (T=3,
224 px, 13 classes, float32 parameters, bf16 compute, AdamW, the config's
class weights, random weights from seed 0) and traces ``--iters`` optimizer
steps on one device batch with ``torch.profiler``. Prints the device time
per step by kernel class (the port's attention forward and backward
kernels, its dropout kernel, matmuls, convolutions, the optimizer, other),
the top kernels by name, and the device's busy share of the traced wall
time.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_attn_fwd" in n:
        return "attention forward (port kernel)"
    if "flash_attn_bwd" in n:
        return "attention backward (port kernel)"
    if "fused_dropout" in n:
        return "dropout (port kernel)"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolution"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "matmul")):
        return "matmul"
    if "adam" in n or "multi_tensor_apply" in n:
        return "optimizer"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other (norm, elementwise, reduce, layout)"


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = create_prithvi_seg(**cs.CROP_MODEL, dtype=torch.bfloat16,
                               param_dtype=torch.float32, device=dev, seed=0)
    trainer = Trainer(cs.CROP_TRAIN_CFG, model, device=dev)
    x, y = cs._crop_batch(args.batch, 3, 224, 13, seed=1)
    xb, yb = trainer.prepare_batch(x, y, args.batch)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        trainer.train_step(xb, yb, gen)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            trainer.train_step(xb, yb, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        # A user annotation (``Optimizer.step#AdamW.step``) spans kernels
        # that are counted on their own.
        if (not dev_us or evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        ms = dev_us / 1e3 / args.iters
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    busy = sum(by_class.values())
    print(f"[profile] {card}, train step at batch {args.batch}: device busy {busy:.3f} ms "
          f"of {wall_ms / args.iters:.3f} ms wall per step "
          f"({100 * busy * args.iters / wall_ms:.1f}%)", flush=True)
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {cls}: {ms:.3f} ms ({100 * ms / busy:.1f}%)", flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"[profile]   {ms:8.3f} ms  {name[:110]}", flush=True)
    # The host side: operators by their own CPU time, and how many calls.
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3 / args.iters
    print(f"[profile] host: {host_ms:.3f} ms of operator CPU time per step", flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"[profile]   host {e.self_cpu_time_total / 1e3 / args.iters:8.3f} ms "
              f"{e.count // args.iters:6d} calls  {e.key[:90]}", flush=True)
    return 0 if busy > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
