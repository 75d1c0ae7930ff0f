#!/usr/bin/env python3
"""The fused dropout's two designs, timed in turns on one CUDA card.

    python3 tools/profile_dropout_designs.py [--iters 20]

The package's kernel (``instageo_tpu_torch/ops/csrc/dropout.cu``, 8
elements per thread and step) against its earlier design (4 elements per
thread, one Philox call each), which lives only here: ``tools/dropout_x4.cu``
is built by ``nvcc`` into the package's build root
(``utils/compile_cache.py:build_root()``) under ``tools/<hash>/``. At each
shape of ``chip_smoke.DROPOUT_SHAPES`` (the five dropout inputs of a batch-8
training step of the crop model) both give the same mask and output, bit for
bit, and are timed in turns (new, prev, prev, new): wrapper ms by CUDA
events and device ms per call by ``torch.profiler``
(``chip_smoke._in_turns``). One JSON line per shape, with the card's name
and power limit.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SOURCE = Path(__file__).resolve().parent / "dropout_x4.cu"
SYMBOLS = ("fused_dropout_kernel", "fused_dropout_x4_kernel")


def build_x4():
    """The earlier design's C entry, built once per source and flags."""
    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.utils.compile_cache import build_root

    digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + SOURCE.read_bytes())
    lib = build_root() / "tools" / digest.hexdigest()[:16] / "libdropout_x4.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True)
        if built.returncode != 0:
            raise RuntimeError(f"{SOURCE.name} does not build:\n{built.stdout}{built.stderr}")
        os.replace(tmp, lib)
    fn = ctypes.CDLL(str(lib)).fused_dropout_x4
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def x4_dropout(fn, x, p: float, seed: int):
    """(out, mask) of the earlier design, launched as the wrapper launches
    the kernel."""
    import torch

    from instageo_tpu_torch.ops import dropout as tdrop
    from instageo_tpu_torch.ops._build import call_on_device

    threshold, scale = tdrop._rate_args(p)
    x = x.contiguous()
    out, mask = torch.empty_like(x), torch.empty_like(x, dtype=torch.bool)
    err = call_on_device(x.device, fn, tdrop._DTYPE_CODES[x.dtype], x.data_ptr(),
                         out.data_ptr(), mask.data_ptr(), x.numel(), threshold, scale,
                         seed % (1 << 64), x.data_ptr() % 16 == 0)
    if err != 0:
        raise RuntimeError(f"fused_dropout_x4 launch failed ({err})")
    return out, mask


def main() -> int:
    import torch

    import chip_smoke as cs
    from instageo_tpu_torch.ops import dropout as tdrop

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--p", type=float, default=0.1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_dropout_designs: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fn = build_x4()
    for i, shape in enumerate(cs.DROPOUT_SHAPES):
        g = torch.Generator(device=dev).manual_seed(200 + i)
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        out, mask = tdrop.fused_dropout_fwd(x, args.p, seed=i)
        prev_out, prev_mask = x4_dropout(fn, x, args.p, i)
        cs.check(torch.equal(prev_mask, mask) and torch.equal(prev_out, out),
                 f"the earlier dropout design gives other bits at {shape}")
        row = cs._in_turns(lambda: tdrop.fused_dropout_fwd(x, args.p, seed=i),
                           lambda: x4_dropout(fn, x, args.p, i), dev, args.iters, SYMBOLS)
        print(json.dumps(dict(shape=list(shape), card=card, equal=True, **row)), flush=True)
        del x, out, mask, prev_out, prev_mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
