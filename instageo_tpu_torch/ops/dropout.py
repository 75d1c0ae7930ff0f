"""Fused dropout: Hopper kernel + plain version.

Counterpart of ``instageo_tpu/ops/dropout.py``. One CUDA kernel
(``csrc/dropout.cu``) replaces the Pallas kernel ``_dropout_kernel``: random
bits, keep mask and scaled output in one pass, with Philox4x32-10 in place
of the TPU's core-local generator. The math is the TPU kernel's
``_mask_and_scale``: keep = bits ≥ min(round(p·2³²), 2³²−1) on uint32
bits; out = x·(1/(1−p)) in float32 where kept, else 0, cast to x's dtype;
the mask is bool. The backward is the plain ``where(mask, g/(1−p), 0)``,
as in JAX.

The stream: element i takes 32-bit word i % 4 of Philox4x32-10(counter =
(i / 4 as (lo, hi), 0, 0), key = seed as (lo, hi)). It is a function of
(seed, element index) only, so a seed gives one mask whatever the grid,
the vector width or the tensor's shape. ``philox_bits`` computes the same
stream in plain PyTorch (int64 arithmetic on uint32 words), so the plain
version (``fused_dropout_seeded_plain``, what a CPU tensor takes) and the
kernel give the same mask for a seed. It is not JAX's stream nor torch's:
tests against JAX compare the keep rate, the scale and the mask's use.

``fused_dropout_fwd`` is the wrapper: on a CPU tensor it runs the plain
version; on a CUDA tensor it launches the kernel (bf16 or float32, any
numel) or raises.

A seed is an int, or a ``(buffer, slot)`` pair: a 1-D int64 tensor on the
input's device and an index into it. The kernel then reads ``buffer[slot]``
from device memory when it runs, so a launch recorded into a CUDA graph
takes whatever seed the host wrote there before each replay; the plain
version reads the same slot. The 64 bits are the seed's either way, and
so is the mask.

An element offset (``offset``, 0 by default) shifts the stream: element i
of x takes the bits of element offset + i. A rank that holds rows r.. of a
batch passes r × (elements per row), and draws the mask those rows get
when the whole batch is one tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from instageo_tpu_torch.ops._build import Kernel, LaunchCounter, call_on_device

IMPLS = ("kernel", "plain")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter()
KERNELS = (Kernel("fused_dropout", "dropout", launches),)

Seed = Union[int, Tuple[torch.Tensor, int]]

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _check_rate(p: float) -> None:
    if not 0.0 <= p < 1.0:
        # p = 1 would divide the scale by zero, and a p rounding to 2^32
        # would overflow the uint32 threshold; the Dropout module returns
        # zeros for p >= 1 itself.
        raise ValueError(f"dropout rate must be in [0, 1), got {p}")


def threshold(p: float) -> int:
    """The uint32 bit threshold below which an element is dropped."""
    return min(int(round(p * (1 << 32))), (1 << 32) - 1)


@functools.lru_cache(maxsize=64)
def _rate_args(p: float) -> Tuple[int, float]:
    """(threshold, scale) of rate ``p``, checked once per rate."""
    _check_rate(p)
    return threshold(p), 1.0 / (1.0 - p)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m·x for uint32 words ``x`` in int64,
    without overflowing int64: x is split into 16-bit halves."""
    a = m * (x & 0xFFFF)          # < 2^48
    b = m * (x >> 16)             # < 2^48
    low = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (low >> 32), low & _M32


def philox4x32_10(counter, key) -> torch.Tensor:
    """Philox4x32-10 of counters (..., 4) under keys (..., 2): uint32 words
    held in int64 tensors; returns (..., 4) words."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return torch.stack((c0, c1, c2, c3), dim=-1)


def philox_bits(n: int, seed: int, device=None, start: int = 0) -> torch.Tensor:
    """The kernel's stream: n uint32 words (int64) for element indices
    start..start+n−1, word i % 4 of Philox4x32-10((i / 4 as (lo, hi), 0, 0),
    seed as (lo, hi))."""
    seed %= 1 << 64
    first = start // 4
    groups = torch.arange(first, (start + n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    counter = torch.stack((groups & _M32, groups >> 32, zero, zero), dim=-1)
    key = torch.tensor([seed & _M32, seed >> 32], dtype=torch.int64, device=device)
    words = philox4x32_10(counter, key.expand(len(groups), 2)).reshape(-1)
    return words[start - 4 * first:][:n]


def dropout_apply(x: torch.Tensor, mask: torch.Tensor, p: float) -> torch.Tensor:
    """``where(mask, x·(1/(1−p)), 0)`` computed in float32, in x's dtype: the
    forward's output given its mask, and the backward of a gradient."""
    return torch.where(mask, x.float() * (1.0 / (1.0 - p)), 0.0).to(x.dtype)


def _seed_slot(seed: Seed, device: torch.device):
    """(buffer, slot) of a device-held seed, checked; None for an int."""
    if isinstance(seed, int):
        return None
    buf, slot = seed
    if (buf.device != device or buf.dtype != torch.int64 or buf.dim() != 1
            or not buf.is_contiguous() or not 0 <= int(slot) < buf.numel()):
        raise ValueError("a seed slot is (1-D contiguous int64 tensor on the input's "
                         f"device, index into it); got {buf.dtype} {tuple(buf.shape)} "
                         f"on {buf.device}, slot {slot}")
    return buf, int(slot)


def fused_dropout_seeded_plain(x: torch.Tensor, p: float, seed: Seed, offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel in plain PyTorch: its Philox stream for ``seed`` from
    element ``offset`` (``philox_bits``; a ``(buffer, slot)`` seed is read
    from the buffer) -> (out, mask), bit for bit what the kernel gives."""
    _check_rate(p)
    held = _seed_slot(seed, x.device)
    if held is not None:
        seed = int(held[0][held[1]])
    bits = philox_bits(x.numel(), seed, x.device, start=int(offset))
    mask = bits.reshape(x.shape) >= threshold(p)
    return dropout_apply(x, mask, p), mask


@functools.lru_cache(maxsize=None)
def _entry():
    """(C entry, error-string function) of the kernel, bound once."""
    from instageo_tpu_torch.ops import _build

    lib = _build.load("dropout")
    fn = lib.fused_dropout
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.fused_dropout_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _fused_dropout_cuda(x: torch.Tensor, p: float, seed: Seed, offset: int = 0):
    """Launch the kernel."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"the dropout kernel takes float32 or bfloat16; x is {x.dtype}")
    bits_threshold, scale = _rate_args(p)
    held = _seed_slot(seed, x.device)
    if not 0 <= offset < 1 << 64:
        raise ValueError(f"dropout element offset {offset} out of range")
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty_like(x, dtype=torch.bool)
    # out and mask are fresh allocations, aligned for any vector.
    vec = x.data_ptr() % 16 == 0
    fn, error_string = _entry()
    seed_args = ((0, held[0].data_ptr(), held[1], offset) if held is not None
                 else (seed % (1 << 64), None, 0, offset))
    err = call_on_device(x.device, fn, code, x.data_ptr(), out.data_ptr(), mask.data_ptr(),
                         x.numel(), bits_threshold, scale, *seed_args, vec)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"fused_dropout launch failed: {msg} ({err})")
    launches.add()
    return out, mask


def supports_fused_dropout(x: torch.Tensor) -> bool:
    """Whether ``fused_dropout_fwd`` launches the kernel for ``x``: a float32
    or bfloat16 tensor on a CUDA device."""
    return x.device.type == "cuda" and x.dtype in _DTYPE_CODES


def fused_dropout_fwd(x: torch.Tensor, p: float, seed: Seed, offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, mask) of dropout at rate ``p`` with the stream of ``seed`` (an
    int or a ``(buffer, slot)`` pair) from element ``offset``. CPU
    tensors take the plain version (the same Philox stream); CUDA tensors
    launch the Hopper kernel or raise."""
    kind = x.device.type
    if kind == "cuda":
        return _fused_dropout_cuda(x, p, seed, offset=offset)
    if kind == "cpu":
        return fused_dropout_seeded_plain(x, p, seed, offset)
    raise ValueError(f"fused_dropout runs on cuda or cpu, not {x.device}")


class FusedDropout(torch.autograd.Function):
    """(x, p, seed, impl, offset) -> (out, mask), ``seed`` an int or a
    ``(buffer, slot)`` pair; the mask is saved for the backward
    and is not differentiable. ``impl="plain"`` always runs the plain
    version (the kernel's Philox stream in plain PyTorch)."""

    @staticmethod
    def forward(ctx, x, p, seed, impl, offset=0):
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
        fwd = fused_dropout_fwd if impl == "kernel" else fused_dropout_seeded_plain
        out, mask = fwd(x, p, seed, offset)
        ctx.save_for_backward(mask)
        ctx.mark_non_differentiable(mask)
        ctx.p = p
        return out, mask

    @staticmethod
    def backward(ctx, g, _dmask):
        (mask,) = ctx.saved_tensors
        return dropout_apply(g, mask, ctx.p), None, None, None, None


def fused_dropout(x: torch.Tensor, p: float, seed: Seed, impl: str = "kernel",
                  offset: int = 0) -> torch.Tensor:
    """Differentiable dropout of ``x`` at rate ``p`` with the stream of
    ``seed`` from element ``offset``."""
    return FusedDropout.apply(x, p, seed, impl, offset)[0]
