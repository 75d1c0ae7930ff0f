#!/usr/bin/env python3
"""What the PyTorch port's first forward in a fresh process pays, on one CUDA card.

    python3 tools/profile_torch_cold_start.py [--batch 8] [--top 12] [--import-dynamo-first]

Builds the crop model as ``mode=sliding_inference`` runs it (Prithvi-V1-100M,
T=3, 224 px, 13 classes, bf16, random weights from seed 0) in this fresh
interpreter and runs the fused predict on one batch of raw uint16 chips
three times, each timed on the host clock (synchronised). The first call
runs under ``torch.profiler`` with CPU activities only, and the host ops
with the largest self time are printed: what a process's first forward
sets up (the port's kernel library, built here if the checkout has none,
cuDNN, cuBLAS, kernel loads). A ``torch.library`` custom op imports
``torch._dynamo`` at its first call (``torch/_compile.py``); with
``--import-dynamo-first`` that import is made and timed before the first
call, apart from it. Prints the card, then one JSON line.

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


def main() -> int:
    t_start = time.perf_counter()
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--import-dynamo-first", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_cold_start: CUDA is not available", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = create_prithvi_seg("prithvi_eo_v1_100", num_classes=13, temporal_step=3,
                               image_size=224, num_bands=6, dtype=torch.bfloat16,
                               device=dev, seed=0).eval()
    torch.cuda.synchronize()
    model_s = time.perf_counter() - t0
    predict = make_fused_predict_fn(model, MEAN, STD, temporal_size=3)
    raw = np.random.default_rng(0).integers(0, 10000, (args.batch, 18, 224, 224),
                                            dtype=np.uint16)
    dynamo_import_s = None
    if args.import_dynamo_first:
        t0 = time.perf_counter()
        import torch._dynamo  # noqa: F401

        dynamo_import_s = time.perf_counter() - t0
    calls = []
    for i in range(3):
        t0 = time.perf_counter()
        if i == 0:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                predict(raw)
                torch.cuda.synchronize()
        else:
            predict(raw)
            torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    top = [dict(op=e.key, calls=e.count, self_s=e.self_cpu_time_total / 1e6)
           for e in ops[:args.top]]
    print(card, flush=True)
    for row in top:
        print(f"[cold] {row['self_s']:9.3f} s self  x{row['calls']:<5d} {row['op']}", flush=True)
    print(json.dumps(dict(card=card, batch=args.batch, context_s=context_s, model_s=model_s,
                          dynamo_import_s=dynamo_import_s, calls_s=calls,
                          triton_imported="triton" in sys.modules,
                          build_s=dict(_build.build_seconds),
                          since_start_s=time.perf_counter() - t_start, top=top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
