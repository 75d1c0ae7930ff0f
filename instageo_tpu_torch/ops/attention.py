"""Fused attention forward for the Prithvi ViT: Hopper kernel + plain version.

Counterpart of ``instageo_tpu/ops/attention.py``'s forward kernels. One CUDA
kernel (``csrc/flash_attn_fwd.cu``) replaces both Pallas kernels:

- ``_attn_kernel_blo`` (merged-heads output, entry ``flash_attention_blo``);
- ``_attn_kernel`` (heads-first output, entry ``flash_attention_bhld``).

The layout only changes the output strides the kernel is given. q/k/v are
(B, H, L, Dh) with any strides whose last one is 1, so the model passes
views of its fused qkv projection output without copying them.

``flash_attention_fwd`` is the wrapper: on a CPU tensor it runs
``flash_attention_fwd_plain``; on a CUDA tensor it launches the kernel or
raises. It never falls back. It is forward-only: there is no backward kernel
yet, so it refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Tuple

import torch

LAYOUTS = ("merged", "heads_first")
SUPPORTED_HEAD_DIMS = tuple(range(16, 129, 16))


class _LaunchCounter:
    """Kernel launches since the last reset (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


launches = _LaunchCounter()


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              layout: str = "merged"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's math step by step, in plain PyTorch.

    q/k/v (B, H, L, Dh) -> (O, lse): O merged (B, L, H·Dh) or heads-first
    (B, H, L, Dh) in q's dtype, lse (B, H, L, 1) float32. The products take
    the input values exactly (float32 matmul of the input dtype's values);
    the scale is applied to the float32 scores; P is cast to v's dtype for
    the PV product; the float32 result is divided by the row sum, then cast.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    b, h, l, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (out / denom).to(q.dtype)
    lse = m + torch.log(denom)
    if layout == "merged":
        out = out.permute(0, 2, 1, 3).reshape(b, l, h * d)
    return out, lse


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash_attn_fwd takes bfloat16; {name} is {x.dtype}")
        if x.dim() != 4 or x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}; expected "
                             f"(B, H, L, Dh) equal to q's {tuple(q.shape)}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if x.data_ptr() % 16 or any(
                s % 8 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             "that are multiples of 8 elements")
        if max(s * (n - 1) for s, n in zip(x.stride(), x.shape)) >= 2**31:
            raise ValueError(f"{name} spans more than 2**31 elements")
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("flash_attn_fwd is forward-only; run it under "
                               "torch.no_grad() or torch.inference_mode()")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd takes Dh in {SUPPORTED_HEAD_DIMS}; "
                         f"got {d}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from instageo_tpu_torch.ops import _build

    lib = _build.load("flash_attn_fwd")
    lib.flash_attn_fwd_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p])
    lib.flash_attn_fwd_bf16.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _flash_attention_fwd_cuda(q, k, v, layout):
    _check_cuda_inputs(q, k, v)
    b, h, l, d = q.shape
    if layout == "merged":
        out = torch.empty((b, l, h * d), dtype=q.dtype, device=q.device)
        o_strides = (l * h * d, d, h * d)
    else:
        out = torch.empty((b, h, l, d), dtype=q.dtype, device=q.device)
        o_strides = (h * l * d, l * d, d)
    lse = torch.empty((b, h, l, 1), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, l, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o_strides,
            stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({err})")
    launches.add()
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "merged"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, L, Dh) -> (O, lse), O in ``layout`` (see the plain
    version). CPU tensors take the plain version; CUDA tensors launch the
    Hopper kernel (bf16, Dh a multiple of 16 up to 128) or raise."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd runs on cuda or cpu, not {q.device}")
    return _flash_attention_fwd_cuda(q, k, v, layout)


def flash_attention_blo(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """Heads-first in, merged heads out: (B, H, L, Dh) -> (B, L, H·Dh)."""
    return flash_attention_fwd(q, k, v, "merged")[0]


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                         ) -> torch.Tensor:
    """Heads-first in and out: (B, H, L, Dh) -> (B, H, L, Dh)."""
    return flash_attention_fwd(q, k, v, "heads_first")[0]
