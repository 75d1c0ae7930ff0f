#!/usr/bin/env python3
"""Device time of the attention backward's kernels on one CUDA card.

    python3 tools/profile_attn_bwd.py [--iters 10] [--variants]

Prints one JSON line per measurement, each with the card's name and power
limit, all device times from ``torch.profiler`` (``chip_smoke.device_ms``
and the per-kernel split below):

- ``shape``: at each row of ``chip_smoke.BWD_SHAPES``, the wgmma route
  (``csrc/flash_attn_bwd_sm90.cu``) split into its three launches
  (pre-pass, dK/dV kernel "main", dQ kernel "dq"), the mma.sync route
  (``csrc/flash_attn_bwd.cu``) and SDPA's backward, in turns;
- ``tiles``: the wgmma route at (60/n, 12, 128·n, 64) for n = 1..5, the
  same 720 work items (128-key tiles) each time with 2n q tiles each, so
  that the dK/dV kernel's time per item splits into a fixed part and a
  part per q tile;
- ``tail``: the dK/dV kernel at L = 512 and 513, 1024 and 1025 (Dh 80):
  the cost of a last key tile that holds one key;
- ``variant`` (with ``--variants``): at each Dh 64/80 row, the dK/dV
  kernel built from a copy of its source with one part left out (the S and
  dP products; the dK and dV products; the dK and dV stores; the EX2s),
  beside the source as it is, built the same way. The parts' outputs are
  wrong by construction; only their times are read.

Imports nothing of JAX. Exits non-zero where CUDA is not available.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCE = "flash_attn_bwd_sm90"
MAIN_SYMBOL = "flash_attn_bwd_sm90_kernel"  # the dK/dV kernel
# The C entry's argument types.
ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
# Parts left out by a source substitution: (old text, new text).
VARIANTS = {
    "no_scores_products": [
        ("transposed_scores<D>(sacc, kc, kcn, qs, qs + T::kQWide);", ""),
        ("transposed_scores<D>(pacc, vc, vcn, gs, gs + T::kQWide);", ""),
    ],
    "no_dk_dv_products": [
        ("key_product<D>(dvacc, dvn, pa, gs, gs + T::kQWide);", ""),
        ("key_product<D>(dkacc, dkn, da, qs, qs + T::kQWide);", ""),
    ],
    "no_epilogue": [
        ("      store_tile<D>(dk + item.b * st.dk[0] + item.h * st.dk[1], st.dk[2], dkacc, dkn, sb, "
         "k0, L,\n                    c, t, scale);\n", ""),
        ("      store_tile<D>(dv + item.b * st.dv[0] + item.h * st.dv[1], st.dv[2], dvacc, dvn, sb, "
         "k0, L,\n                    c, t, 1.f);\n", ""),
    ],
    "no_exp2": [("exp2_approx(fmaf(sacc[i], sc, -(e ? l2.y : l2.x)))",
                 "fmaf(sacc[i], sc, -(e ? l2.y : l2.x))")],
}


def kernel_ms(fn, iters: int, warmup: int = 2) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by name, from one
    ``torch.profiler`` trace of ``iters`` calls (a kernel whose events the
    trace lost reads low)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return by_name


def _short(name: str) -> str:
    if "flash_attn_bwd_sm90_prepass" in name:
        return "prepass"
    if "flash_attn_bwd_sm90_dq_kernel" in name:
        return "dq"
    return "main" if MAIN_SYMBOL in name else name


def _variant_entries(variants: dict, build_dir: str) -> dict:
    """The C entry of the wgmma backward built from its source with each
    variant's substitutions, one ``nvcc`` per variant, all started together."""
    from instageo_tpu_torch.ops import _build

    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        with open(_build.CSRC / f"{SOURCE}.cu") as f:
            src = f.read()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            src = src.replace(old, new)
        cu = os.path.join(build_dir, f"{name}.cu")
        so = os.path.join(build_dir, f"lib{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    entries = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{out}")
        fn = ctypes.CDLL(os.path.abspath(so)).flash_attn_bwd_sm90_bf16
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _call_entry(fn, q, k, v, o, do, lse, layout):
    """A call of a wgmma backward C entry, as the wrapper makes it; it
    returns (dq, dk, dv), the same tensors on every call."""
    import torch

    from instageo_tpu_torch.ops import attention as tattn

    shape = tuple(q.shape)
    b, h, l, d = shape
    o4, do4 = (tattn._heads_first(x, shape, layout) for x in (o, do))
    grads = torch.empty((3,) + shape, dtype=do.dtype, device=q.device).unbind(0)
    stats = torch.empty(tattn.bwd_scratch_shape(b, h, l, d), dtype=torch.float32,
                        device=q.device)
    desc = tattn._tma_array(*(tattn.tma_description(x) for x in (q, k, v, do4)))
    strides = tattn._int64_array(tuple(s for x in (o4, do4) + grads for s in x.stride()[:3]))

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o4.data_ptr(), do4.data_ptr(),
                 lse.data_ptr(), *(g.data_ptr() for g in grads), stats.data_ptr(),
                 b, h, l, d, ctypes.addressof(desc), ctypes.addressof(strides),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"variant launch failed ({err})")
        return grads
    return call


def _inputs(dev, b, h, l, d, layout, seed):
    import torch

    from instageo_tpu_torch.ops import attention as tattn

    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, h, l, d), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    o, lse = tattn.flash_attention_fwd(q, k, v, layout)
    do = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v, o, do, lse


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from h100bench import counts
    from instageo_tpu_torch.ops import attention as tattn

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--variants", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_attn_bwd: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def emit(**row):
        print(json.dumps(dict(row, card=card)), flush=True)

    for i, (b, h, l, d, entry) in enumerate(cs.BWD_SHAPES):
        layout = "heads_first" if entry == "heads_first" else "merged"
        q, k, v, o, do, lse = _inputs(dev, b, h, l, d, layout, seed=i)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        do_hf = (do.view(b, l, h, d).permute(0, 2, 1, 3).contiguous()
                 if layout == "merged" else do)
        calls = {
            "wgmma": lambda: tattn._flash_attention_bwd_cuda(q, k, v, o, do, lse, layout, "wgmma"),
            "mma_sync": lambda: tattn._flash_attention_bwd_cuda(q, k, v, o, do, lse, layout,
                                                                "mma_sync"),
            "sdpa": lambda: torch.autograd.grad(out, (qs, ks, vs), do_hf, retain_graph=True),
        }
        turns = {name: [] for name in calls}
        for name in ("wgmma", "mma_sync", "sdpa", "sdpa", "mma_sync", "wgmma"):
            turns[name].append(kernel_ms(calls[name], args.iters))
        mean = {}
        for name, ts in turns.items():
            keys = {key for t in ts for key in t}
            mean[name] = {key: sum(t.get(key, 0.0) for t in ts) / len(ts) for key in keys}
        wgmma = {_short(key): ms for key, ms in mean["wgmma"].items()}
        key_tiles = -(-l // 128)
        emit(kind="shape", shape=[b, h, l, d], entry=entry, items=key_tiles * h * b,
             q_tiles=-(-l // 64), last_key_tile_keys=l - 128 * (key_tiles - 1),
             wgmma_ms=wgmma, wgmma_total_ms=sum(wgmma.values()),
             mma_sync_total_ms=sum(mean["mma_sync"].values()),
             sdpa_total_ms=sum(mean["sdpa"].values()), sdpa_kernels=mean["sdpa"],
             bound_ms=cs.bound(counts.attention_bwd(b, h, l, d))[0])
        del q, k, v, o, do, lse, qs, ks, vs, out, do_hf, calls

    for n in range(1, 6):
        b = 60 // n
        q, k, v, o, do, lse = _inputs(dev, b, 12, 128 * n, 64, "merged", seed=n)
        items = b * 12 * n
        ms = kernel_ms(lambda: tattn.flash_attention_bwd(q, k, v, o, do, lse), args.iters)
        main_ms = sum(t for key, t in ms.items() if _short(key) == "main")
        emit(kind="tiles", q_tiles=2 * n, shape=[b, 12, 128 * n, 64], items=items,
             main_ms=main_ms, us_per_item_round=main_ms * 1e3 / (items / sms))
        del q, k, v, o, do, lse

    # The last key tile at L = 513 and 1025 holds one key: the main kernel at
    # L = 128·k and 128·k + 1, the second with one more item per head (and
    # one more q tile per item).
    for b, l in ((8, 512), (8, 513), (2, 1024), (2, 1025)):
        q, k, v, o, do, lse = _inputs(dev, b, 16, l, 80, "heads_first", seed=l)
        ms = kernel_ms(lambda: tattn.flash_attention_bwd(q, k, v, o, do, lse, "heads_first"),
                       args.iters)
        emit(kind="tail", shape=[b, 16, l, 80], items=b * 16 * -(-l // 128),
             main_ms=sum(t for key, t in ms.items() if _short(key) == "main"))
        del q, k, v, o, do, lse

    if args.variants:
        entries = _variant_entries({"as_is": [], **VARIANTS},
                                   os.path.join(ROOT, "build", "attn_bwd_variants"))
        for i, (b, h, l, d, entry) in enumerate(cs.BWD_SHAPES):
            if entry == "bloq":
                continue
            layout = "heads_first" if entry == "heads_first" else "merged"
            q, k, v, o, do, lse = _inputs(dev, b, h, l, d, layout, seed=i)
            calls = {name: _call_entry(fn, q, k, v, o, do, lse, layout)
                     for name, fn in entries.items()}
            times = {name: [] for name in calls}
            for name in list(calls) + list(calls)[::-1]:
                times[name].append(cs.device_ms(calls[name], args.iters, match=MAIN_SYMBOL))
            emit(kind="variant", shape=[b, h, l, d], entry=entry,
                 main_ms={n: sum(t) / len(t) for n, t in times.items()}, turns=times)
            del q, k, v, o, do, lse, calls

    return 0


if __name__ == "__main__":
    sys.exit(main())
