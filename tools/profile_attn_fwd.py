#!/usr/bin/env python3
"""Device time of the attention forward's kernels on one CUDA card.

    python3 tools/profile_attn_fwd.py [--iters 20] [--variants]

Prints one JSON line per measurement, each with the card's name and power
limit, all device times from ``torch.profiler`` (``chip_smoke.device_ms``):

- ``shape``: the wgmma kernel (``csrc/flash_attn_fwd_sm90.cu``), the
  mma.sync kernel (``csrc/flash_attn_fwd.cu``) and SDPA at each forward
  shape of ``chip_smoke.KERNEL_SHAPES``, in turns;
- ``tiles``: the wgmma kernel at (320/n, 12, 128·n, 64) for n = 1..5 key
  tiles, the same 3,840 work items each time, so that the time per item
  splits into a fixed part and a part per key tile;
- ``variant`` (with ``--variants``): at each of those shapes (merged
  output), the wgmma kernel built from a copy of its source with one design
  step undone (an IEEE division per output element in place of one
  reciprocal per row; no ping-pong between the consumer warpgroups),
  beside the source as it is, built the same way, and the wrapper's call.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SYMBOL = "flash_attn_fwd_sm90_kernel"
# Design steps undone by a source substitution: (old text, new text).
VARIANTS = {
    "ieee_division": [
        ("const float l = half ? r1l : r0l, inv = 1.f / l;",
         "const float l = half ? r1l : r0l;"),
        ("pack_bf16(oacc[4 * jj + 2 * half] * inv, oacc[4 * jj + 2 * half + 1] * inv)",
         "pack_bf16(oacc[4 * jj + 2 * half] / l, oacc[4 * jj + 2 * half + 1] / l)"),
        ("pack_bf16(onar[4 * jj + 2 * half] * inv, onar[4 * jj + 2 * half + 1] * inv)",
         "pack_bf16(onar[4 * jj + 2 * half] / l, onar[4 * jj + 2 * half + 1] / l)"),
    ],
    "no_pingpong": [
        ("bar_sync(my_turn, kConsumerThreads);", ""),
        ("if (c == 0 || !last_item) bar_arrive(other_turn, kConsumerThreads);", ""),
        ("bar_arrive(other_turn, kConsumerThreads);", ""),
        ("if (c == 1) bar_arrive(1, kConsumerThreads);", ""),
    ],
}


def _variant_entry(name: str, subs, build_dir: str):
    """The C entry of the wgmma kernel built from its source with ``subs``."""
    from instageo_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attn_fwd_sm90.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    os.makedirs(build_dir, exist_ok=True)
    cu, so = os.path.join(build_dir, f"{name}.cu"), os.path.join(build_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", so, cu], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"variant {name} does not build:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(os.path.abspath(so)).flash_attn_fwd_sm90_bf16
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _call_entry(fn, q, k, v):
    """A call of a wgmma C entry on merged output, as the wrapper makes it."""
    import torch

    from instageo_tpu_torch.ops import attention as tattn

    b, h, l, d = q.shape
    out = torch.empty((b, l, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l, 1), dtype=torch.float32, device=q.device)
    desc = tattn._tma_array(*(tattn.tma_description(x) for x in (q, k, v)))

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, h, l, d, ctypes.addressof(desc), l * h * d, d, h * d,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant launch failed ({err})")
    return call, out


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from h100bench import counts
    from instageo_tpu_torch.ops import attention as tattn

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_attn_fwd: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(**row):
        print(json.dumps(dict(row, card=card)), flush=True)

    for i, (b, h, l, d, layout, inputs) in enumerate(cs.KERNEL_SHAPES):
        q, k, v = cs._fwd_inputs(dev, b, h, l, d, inputs, seed=i)
        calls = {
            "wgmma": (lambda: tattn._flash_attention_fwd_cuda(q, k, v, layout, "wgmma"),
                      SYMBOL),
            "mma_sync": (lambda: tattn._flash_attention_fwd_cuda(q, k, v, layout, "mma_sync"),
                         cs.FWD_KERNEL_SYMBOL["mma_sync"]),
            "sdpa": (lambda: F.scaled_dot_product_attention(q, k, v), None),
        }
        times = {name: [] for name in calls}
        for name in ("wgmma", "mma_sync", "sdpa", "sdpa", "mma_sync", "wgmma"):
            fn, match = calls[name]
            times[name].append(cs.device_ms(fn, args.iters, match=match))
        emit(kind="shape", shape=[b, h, l, d], layout=layout, inputs=inputs,
             device_ms={n: sum(t) / len(t) for n, t in times.items()}, turns=times,
             bound_ms=cs.bound(counts.attention_fwd(b, h, l, d))[0])
        del q, k, v

    for n in range(1, 6):
        b = 320 // n
        q, k, v = cs._fwd_inputs(dev, b, 12, 128 * n, 64, "contiguous", seed=n)
        items = b * 12 * n
        ms = cs.device_ms(lambda: tattn.flash_attention_fwd(q, k, v), args.iters, match=SYMBOL)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        emit(kind="tiles", key_tiles=n, shape=[b, 12, 128 * n, 64], items=items,
             device_ms=ms, us_per_item_round=ms * 1e3 / (items / sms))
        del q, k, v

    if args.variants:
        build_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                 "build", "attn_fwd_variants")
        entries = {"as_is": _variant_entry("as_is", [], build_dir)}
        entries.update({name: _variant_entry(name, subs, build_dir)
                        for name, subs in VARIANTS.items()})
        for i, (b, h, l, d, _, inputs) in enumerate(cs.KERNEL_SHAPES):
            q, k, v = cs._fwd_inputs(dev, b, h, l, d, inputs, seed=i)
            o_ref, _ = tattn.flash_attention_fwd_plain(q, k, v)
            calls = {"wrapper": lambda: tattn.flash_attention_fwd(q, k, v)}
            errs = {}
            for name, fn in entries.items():
                calls[name], out = _call_entry(fn, q, k, v)
                calls[name]()
                errs[name] = (out.float() - o_ref.float()).abs().max().item()
            times = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                times[name].append(cs.device_ms(calls[name], args.iters, match=SYMBOL))
            emit(kind="variant", shape=[b, h, l, d], inputs=inputs,
                 device_ms={n: sum(t) / len(t) for n, t in times.items()}, turns=times,
                 max_abs_err=errs)
            del q, k, v, o_ref, calls
    return 0


if __name__ == "__main__":
    sys.exit(main())
