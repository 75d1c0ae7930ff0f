"""Fused dropout: Hopper kernel + plain version.

Counterpart of ``instageo_tpu/ops/dropout.py``. One CUDA kernel
(``csrc/dropout.cu``) replaces the Pallas kernel ``_dropout_kernel``: random
bits, keep mask and scaled output in one pass, with Philox4x32-10 in place
of the TPU's core-local generator. The math is the TPU kernel's
``_mask_and_scale``: keep = bits ≥ min(round(p·2³²), 2³²−1) on uint32
bits; out = x·(1/(1−p)) in float32 where kept, else 0, cast to x's dtype;
the mask is bool. The backward is the plain ``where(mask, g/(1−p), 0)``,
as in JAX.

The stream is a function of (seed, element index) only, so a seed gives
one mask whatever the grid. It is not JAX's stream, nor torch's: tests
compare the keep rate, the scale and the mask's use, not the bits.

``fused_dropout_fwd`` is the wrapper: on a CPU tensor it runs
``fused_dropout_plain`` with a generator seeded from ``seed``; on a CUDA
tensor it launches the kernel (bf16 or float32, any numel) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from instageo_tpu_torch.ops._build import LaunchCounter

IMPLS = ("kernel", "plain")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()


def _check_rate(p: float) -> None:
    if not 0.0 <= p < 1.0:
        # p = 1 would divide the scale by zero, and a p rounding to 2^32
        # would overflow the uint32 threshold; the Dropout module returns
        # zeros for p >= 1 itself.
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")


def threshold(p: float) -> int:
    """The uint32 bit threshold below which an element is dropped."""
    return min(int(round(p * (1 << 32))), (1 << 32) - 1)


def dropout_apply(x: torch.Tensor, mask: torch.Tensor, p: float) -> torch.Tensor:
    """``where(mask, x·(1/(1−p)), 0)`` computed in float32, in x's dtype: the
    forward's output given its mask, and the backward of a gradient."""
    return torch.where(mask, x.float() * (1.0 / (1.0 - p)), 0.0).to(x.dtype)


def fused_dropout_plain(x: torch.Tensor, p: float, generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in plain PyTorch: uint32 bits from ``generator``
    (on x's device) -> (out, mask)."""
    _check_rate(p)
    bits = torch.randint(0, 1 << 32, x.shape, dtype=torch.int64, device=x.device,
                         generator=generator)
    mask = bits >= threshold(p)
    return dropout_apply(x, mask, p), mask


def _plain_from_seed(x: torch.Tensor, p: float, seed: int):
    return fused_dropout_plain(x, p, torch.Generator(device=x.device).manual_seed(seed))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from instageo_tpu_torch.ops import _build

    lib = _build.load("dropout")
    lib.fused_dropout.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_void_p]
    lib.fused_dropout.restype = ctypes.c_int
    lib.fused_dropout_error_string.argtypes = [ctypes.c_int]
    lib.fused_dropout_error_string.restype = ctypes.c_char_p
    return lib


def _fused_dropout_cuda(x: torch.Tensor, p: float, seed: int):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the dropout kernel takes float32 or bfloat16; x is {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    vec = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (x, out, mask))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_dropout(
            _DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), mask.data_ptr(),
            x.numel(), threshold(p), 1.0 / (1.0 - p), seed % (1 << 64), int(vec), stream)
    if err != 0:
        msg = lib.fused_dropout_error_string(err).decode()
        raise RuntimeError(f"fused_dropout launch failed: {msg} ({err})")
    launches.add()
    return out, mask


def fused_dropout_fwd(x: torch.Tensor, p: float, seed: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, mask) of dropout at rate ``p`` with the stream of ``seed``. CPU
    tensors take the plain version (bits from a generator seeded with
    ``seed``); CUDA tensors launch the Hopper kernel or raise."""
    _check_rate(p)
    if x.device.type == "cpu":
        return _plain_from_seed(x, p, seed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dropout runs on cuda or cpu, not {x.device}")
    return _fused_dropout_cuda(x, p, seed)


class FusedDropout(torch.autograd.Function):
    """(x, p, seed, impl) -> (out, mask); the mask is saved for the backward
    and is not differentiable. ``impl="plain"`` always runs the plain
    version (bits from a generator on x's device seeded with ``seed``)."""

    @staticmethod
    def forward(ctx, x, p, seed, impl):
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
        fwd = fused_dropout_fwd if impl == "kernel" else _plain_from_seed
        out, mask = fwd(x, p, seed)
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        ctx.p = p
        return out, mask

    @staticmethod
    def backward(ctx, g, _dmask):
        (mask,) = ctx.saved_tensors
        return dropout_apply(g, mask, ctx.p), None, None, None


def fused_dropout(x: torch.Tensor, p: float, seed: int, impl: str = "kernel"
                  ) -> torch.Tensor:
    """Differentiable dropout of ``x`` at rate ``p`` with the stream of ``seed``."""
    return FusedDropout.apply(x, p, seed, impl)[0]
