"""Fused attention for the Prithvi ViT: Hopper kernels + plain versions.

Counterpart of ``instageo_tpu/ops/attention.py``. CUDA kernels replace its
five Pallas kernels:

- the forward, ``_attn_kernel_blo`` (merged-heads output) and
  ``_attn_kernel`` (heads-first output), takes one of two routes by head
  dim (``fwd_route``): ``csrc/flash_attn_fwd_sm90.cu`` (TMA, wgmma, a
  producer warpgroup and two consumer warpgroups) for Dh in
  ``SM90_HEAD_DIMS``, which are every head dim of the model registry;
  ``csrc/flash_attn_fwd.cu`` (mma.sync) for the other supported ones;
- the backward, ``_attn_bwd_kernel_blo`` (O and dO merged),
  ``_attn_bwd_kernel`` (heads-first) and ``_attn_bwd_kernel_bloq`` (q rows
  in blocks, dk/dv summed over them in float32), takes one of two routes by
  head dim (``bwd_route``): ``csrc/flash_attn_bwd_sm90.cu`` (TMA, wgmma,
  a dK/dV kernel and a dQ kernel) for Dh in ``SM90_HEAD_DIMS``;
  ``csrc/flash_attn_bwd.cu`` (mma.sync, a dK/dV pass and a dQ pass) for the
  other supported ones. Neither adds across thread blocks, so both give the
  same bits on every call and ``torch.use_deterministic_algorithms(True)``
  changes no route.

A layout only changes the strides a kernel is given. q/k/v are (B, H, L, Dh)
with any strides whose last one is 1, so the model passes views of its fused
qkv projection output without copying them.

``flash_attention_fwd`` and ``flash_attention_bwd`` are the wrappers: on a
CPU tensor they run ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain``;
on a CUDA tensor they launch the kernel or raise. They never fall back.
The forward wrapper is also the custom op ``instageo_tpu_torch::flash_attn_fwd``
(``flash_attn_fwd_op``), with a fake version that gives O's and lse's
shapes: ``torch.export`` records the op as one node (a ``ctypes`` launch
cannot be traced), and the exported program runs the same wrapper.
``FlashAttention`` (an autograd Function) joins the wrappers, and the
entries ``flash_attention_blo``, ``flash_attention_bhld`` and
``flash_attention_bloq`` are differentiable through it; where nothing needs
a gradient they call the op directly. The raw ``flash_attention_fwd``
refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from instageo_tpu_torch.ops._build import Kernel, LaunchCounter, call_on_device

LAYOUTS = ("merged", "heads_first")
IMPLS = ("kernel", "plain")
SUPPORTED_HEAD_DIMS = tuple(range(16, 129, 16))
SM90_HEAD_DIMS = (64, 80)  # the TMA + wgmma routes, forward and backward
BWD_TILE_Q = 64            # q rows per tile of the wgmma backward

launches = LaunchCounter()          # forward kernel, either route
fwd_mma_launches = LaunchCounter()  # forward kernel, mma.sync route only
bwd_launches = LaunchCounter()      # backward kernels, either route (one per call)
bwd_mma_launches = LaunchCounter()  # backward kernels, mma.sync route only
# Each route's kernels, named after their sources (csrc/<name>.cu).
FWD_KERNELS = {"wgmma": "flash_attn_fwd_sm90", "mma_sync": "flash_attn_fwd"}
BWD_KERNELS = {"wgmma": "flash_attn_bwd_sm90", "mma_sync": "flash_attn_bwd"}
KERNELS = (
    Kernel("flash_attn_fwd_sm90", "flash_attn_fwd_sm90", launches, less=fwd_mma_launches),
    Kernel("flash_attn_fwd", "flash_attn_fwd", fwd_mma_launches),
    Kernel("flash_attn_bwd_sm90", "flash_attn_bwd_sm90", bwd_launches, less=bwd_mma_launches),
    Kernel("flash_attn_bwd", "flash_attn_bwd", bwd_mma_launches),
)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """The values of ``x`` in float32, or float64 where ``x`` is float64."""
    return x if x.dtype == torch.float64 else x.float()


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              layout: str = "merged"
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's math step by step, in plain PyTorch.

    q/k/v (B, H, L, Dh) -> (O, lse): O merged (B, L, H·Dh) or heads-first
    (B, H, L, Dh) in q's dtype, lse (B, H, L, 1) float32 (float64 for
    float64 inputs). The products take the input values exactly (float32
    matmul of the input dtype's values); the scale is applied to the float32
    scores; P is cast to v's dtype for the PV product; the float32 result is
    divided by the row sum, then cast.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    b, h, l, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scores = torch.matmul(_wide(q), _wide(k).transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(_wide(p.to(v.dtype)), _wide(v))
    out = (out / denom).to(q.dtype)
    lse = m + torch.log(denom)
    if layout == "merged":
        out = out.permute(0, 2, 1, 3).reshape(b, l, h * d)
    return out, lse


def _heads_first(x: torch.Tensor, shape, layout: str) -> torch.Tensor:
    """O or dO in ``layout`` as a (B, H, L, Dh) view."""
    b, h, l, d = shape
    if layout == "merged":
        if tuple(x.shape) != (b, l, h * d):
            raise ValueError(f"merged O/dO must be {(b, l, h * d)}; got {tuple(x.shape)}")
        return x.reshape(b, l, h, d).permute(0, 2, 1, 3)
    if tuple(x.shape) != (b, h, l, d):
        raise ValueError(f"heads-first O/dO must be {(b, h, l, d)}; got {tuple(x.shape)}")
    return x


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                              layout: str = "merged"
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The TPU backward kernels' math step by step, in plain PyTorch
    (``_attn_bwd_kernel_blo``, ``attention.py:281-302``).

    q/k/v (B, H, L, Dh); O and dO in ``layout``; lse (B, H, L, 1) from the
    forward. Returns dq, dk, dv heads-first in dO's dtype: S = q·kᵀ in
    float32, then scaled; P = exp(S − lse); dP = dO·vᵀ and δ = Σ dO∘O in
    float32; dS = P∘(dP − δ) and P cast to q's dtype; dq = scale·(dS·k),
    dk = scale·(dSᵀ·q), dv = Pᵀ·dO, each product in float32.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    shape = tuple(q.shape)
    scale = 1.0 / math.sqrt(shape[-1])
    o4, do4 = (_wide(_heads_first(x, shape, layout)) for x in (o, do))
    qf, kf, vf = _wide(q), _wide(k), _wide(v)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    dp = torch.matmul(do4, vf.transpose(-1, -2))
    delta = (do4 * o4).sum(dim=-1, keepdim=True)
    ds = _wide((p * (dp - delta)).to(q.dtype))
    pq = _wide(p.to(q.dtype))
    dq = (scale * torch.matmul(ds, kf)).to(do.dtype)
    dk = (scale * torch.matmul(ds.transpose(-1, -2), qf)).to(do.dtype)
    dv = torch.matmul(pq.transpose(-1, -2), do4).to(do.dtype)
    return dq, dk, dv


def _check_view(name: str, x: torch.Tensor, device: torch.device, shape) -> None:
    """A (B, H, L, Dh) bf16 view the kernels can read or write."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernels take bfloat16; {name} is {x.dtype}")
    _check_layout(name, tuple(x.shape), x.stride(), tuple(shape))
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned with strides "
                         "that are multiples of 8 elements")


@functools.lru_cache(maxsize=256)
def _check_layout(name: str, shape: tuple, stride: tuple, expected: tuple) -> None:
    """The shape and stride checks of ``_check_view``, once per layout (a
    layout that fails raises every time: ``lru_cache`` keeps no exception)."""
    if len(shape) != 4 or shape != expected:
        raise ValueError(f"{name} has shape {shape}; expected (B, H, L, Dh) = {expected}")
    if stride[-1] != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    if any(s % 8 for s, n in zip(stride[:3], shape[:3]) if n > 1):
        raise ValueError(f"{name} must be 16-byte aligned with strides "
                         "that are multiples of 8 elements")
    if max(s * (n - 1) for s, n in zip(stride, shape)) >= 2**31:
        raise ValueError(f"{name} spans more than 2**31 elements")


def _check_head_dim(d: int) -> None:
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"the attention kernels take Dh in {SUPPORTED_HEAD_DIMS}; "
                         f"got {d}")


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_view(name, x, q.device, q.shape)
        if x.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("flash_attn_fwd is forward-only; differentiate "
                               "through FlashAttention or run it under "
                               "torch.no_grad() or torch.inference_mode()")
    _check_head_dim(q.shape[-1])


def fwd_route(d: int) -> str:
    """The forward kernel that head dim ``d`` takes on the card: ``"wgmma"``
    (``csrc/flash_attn_fwd_sm90.cu``) for Dh in ``SM90_HEAD_DIMS``,
    ``"mma_sync"`` (``csrc/flash_attn_fwd.cu``) for the other supported
    head dims."""
    _check_head_dim(d)
    return "wgmma" if d in SM90_HEAD_DIMS else "mma_sync"


def bwd_route(d: int) -> str:
    """The backward kernels that head dim ``d`` takes on the card: the
    forward's route, ``"wgmma"`` (``csrc/flash_attn_bwd_sm90.cu``) or
    ``"mma_sync"`` (``csrc/flash_attn_bwd.cu``), in every mode. Both are
    deterministic: each sums dq, dk and dv in one thread block's registers
    in a fixed order, with no atomics, so two calls give the same bits with
    or without ``torch.use_deterministic_algorithms(True)``."""
    return fwd_route(d)


def bwd_scratch_shape(b: int, h: int, l: int, d: int) -> tuple:
    """The float32 scratch of one wgmma backward call, its only one:
    (lse·log2 e, δ) per q row, padded to whole 64-row tiles, (2, B, H, Lp).
    dq, dk and dv are summed in registers; no accumulator lies in memory."""
    if d not in SM90_HEAD_DIMS:
        raise ValueError(f"the wgmma backward takes Dh in {SM90_HEAD_DIMS}; got {d}")
    return (2, b, h, -(-l // BWD_TILE_Q) * BWD_TILE_Q)


def tma_boxes(d: int) -> tuple:
    """(first column, columns, swizzle bytes) of each TMA box that loads one
    128-row tile of a Dh-wide operand: columns 0-63 under a 128-byte swizzle
    (wgmma's widest swizzle atom), and for Dh = 80 columns 64-79 under a
    32-byte swizzle."""
    if d not in SM90_HEAD_DIMS:
        raise ValueError(f"the wgmma forward takes Dh in {SM90_HEAD_DIMS}; got {d}")
    return ((0, 64, 128),) + (((64, 16, 32),) if d == 80 else ())


def tma_description(x: torch.Tensor) -> tuple:
    """The 14 fields of a (B, H, L, Dh) operand's tensor maps that
    ``csrc/flash_attn_fwd_sm90.cu`` encodes: dims (Dh, L, H, B), innermost
    first; the byte strides of L, H and B; the number of boxes; each box
    of ``tma_boxes`` as (first column, columns, swizzle bytes), zeros for a
    missing second box. The view is read where it lies: a dim of size 1,
    whose stride is never used, gets Dh's bytes (TMA wants multiples of 16).
    """
    return _tma_fields(tuple(x.shape), x.stride(), x.element_size())


@functools.lru_cache(maxsize=256)
def _tma_fields(shape: tuple, stride: tuple, size: int) -> tuple:
    b, h, l, d = shape
    strides = tuple(s * size if n > 1 else d * size
                    for s, n in zip(stride[2::-1], (l, h, b)))
    boxes = tma_boxes(d)
    fields = [f for box in boxes for f in box] + [0] * 3 * (2 - len(boxes))
    return (d, l, h, b) + strides + (len(boxes),) + tuple(fields)


@functools.lru_cache(maxsize=256)
def _tma_array(*fields: tuple):
    """A C entry's ``desc`` argument: the operands' fields in turn, one
    array per combination of layouts (the data pointers are passed apart)."""
    flat = [f for fs in fields for f in fs]
    return (ctypes.c_longlong * len(flat))(*flat)


@functools.lru_cache(maxsize=256)
def _int64_array(values: tuple):
    """A C entry's int64 array argument (strides), one per distinct tuple."""
    return (ctypes.c_longlong * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _fwd_entry(route: str):
    """(C entry, error-string function) of a forward route, bound once."""
    from instageo_tpu_torch.ops import _build

    if route == "wgmma":
        lib = _build.load("flash_attn_fwd_sm90")
        fn, err = lib.flash_attn_fwd_sm90_bf16, lib.flash_attn_sm90_error_string
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    else:
        lib = _build.load("flash_attn_fwd")
        fn, err = lib.flash_attn_fwd_bf16, lib.flash_attn_error_string
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def _bwd_entry(route: str):
    """(C entry, error-string function) of a backward route, bound once."""
    from instageo_tpu_torch.ops import _build

    if route == "wgmma":
        lib = _build.load("flash_attn_bwd_sm90")
        fn, err = lib.flash_attn_bwd_sm90_bf16, lib.flash_attn_bwd_sm90_error_string
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
    else:
        lib = _build.load("flash_attn_bwd")
        fn, err = lib.flash_attn_bwd_bf16, lib.flash_attn_bwd_error_string
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _flash_attention_fwd_cuda(q, k, v, layout, route):
    """Launch the forward on ``route`` ("wgmma" or "mma_sync"). The wrapper
    passes ``fwd_route(Dh)``; a measurement of the mma.sync design at a
    wgmma head dim passes "mma_sync"."""
    _check_cuda_inputs(q, k, v)
    b, h, l, d = q.shape
    if layout == "merged":
        out = torch.empty((b, l, h * d), dtype=q.dtype, device=q.device)
        o_strides = (l * h * d, d, h * d)
    else:
        out = torch.empty((b, h, l, d), dtype=q.dtype, device=q.device)
        o_strides = (h * l * d, l * d, d)
    lse = torch.empty((b, h, l, 1), dtype=torch.float32, device=q.device)
    fn, error_string = _fwd_entry(route)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    if route == "wgmma":
        desc = _tma_array(tma_description(q), tma_description(k), tma_description(v))
        args = (*ptrs, b, h, l, d, ctypes.addressof(desc), *o_strides)
    else:
        args = (*ptrs, b, h, l, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o_strides)
    err = call_on_device(q.device, fn, *args)
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd ({route}) launch failed: {msg} ({err})")
    launches.add()
    if route == "mma_sync":
        fwd_mma_launches.add()
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        layout: str = "merged"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k/v (B, H, L, Dh) -> (O, lse), O in ``layout`` (see the plain
    version). CPU tensors take the plain version; CUDA tensors launch the
    Hopper kernel of ``fwd_route(Dh)`` (bf16, Dh a multiple of 16 up to
    128) or raise."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_fwd runs on cuda or cpu, not {q.device}")
    return _flash_attention_fwd_cuda(q, k, v, layout, fwd_route(q.shape[-1]))


@torch.library.custom_op("instageo_tpu_torch::flash_attn_fwd", mutates_args=())
def flash_attn_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      layout: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a custom op (the kernel on a CUDA tensor,
    the plain version on a CPU tensor)."""
    return flash_attention_fwd(q, k, v, layout)


@flash_attn_fwd_op.register_fake
def _flash_attn_fwd_fake(q, k, v, layout):
    b, h, l, d = q.shape
    shape = (b, l, h * d) if layout == "merged" else (b, h, l, d)
    lse_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    return q.new_empty(shape), q.new_empty((b, h, l, 1), dtype=lse_dtype)


def _flash_attention_bwd_cuda(q, k, v, o, do, lse, layout, route):
    """Launch the backward on ``route`` ("wgmma" or "mma_sync"). The wrapper
    passes ``bwd_route(Dh)``; a measurement of the mma.sync design at a
    wgmma head dim passes "mma_sync"."""
    shape = tuple(q.shape)
    b, h, l, d = shape
    views = {"q": q, "k": k, "v": v, "O": _heads_first(o, shape, layout),
             "dO": _heads_first(do, shape, layout)}
    for name, x in views.items():
        _check_view(name, x, q.device, shape)
    _check_head_dim(d)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, l, 1) or not lse.is_contiguous()):
        raise ValueError("lse must be the forward's contiguous float32 "
                         f"(B, H, L, 1) = {(b, h, l, 1)} on {q.device}")
    # dq, dk, dv heads-first; the kernels would take any strides (e.g. one
    # (B, L, 3, H, Dh) buffer), the autograd Function wants separate tensors.
    grads = torch.empty((3,) + shape, dtype=do.dtype, device=q.device).unbind(0)
    fn, error_string = _bwd_entry(route)
    if route == "wgmma":
        stats = torch.empty(bwd_scratch_shape(b, h, l, d), dtype=torch.float32,
                            device=q.device)
        o4, do4 = views["O"], views["dO"]
        desc = _tma_array(*(tma_description(x) for x in (q, k, v, do4)))
        strides = _int64_array(tuple(s for x in (o4, do4) + grads for s in x.stride()[:3]))
        err = call_on_device(q.device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o4.data_ptr(), do4.data_ptr(), lse.data_ptr(),
                         *(g.data_ptr() for g in grads), stats.data_ptr(), b, h, l, d,
                         ctypes.addressof(desc), ctypes.addressof(strides))
    else:
        delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
        tensors = list(views.values()) + list(grads)
        strides = _int64_array(tuple(s for x in tensors for s in x.stride()[:3]))
        err = call_on_device(q.device, fn, *(x.data_ptr() for x in views.values()),
                         lse.data_ptr(), *(g.data_ptr() for g in grads), delta.data_ptr(),
                         b, h, l, d, ctypes.addressof(strides))
    if err != 0:
        msg = error_string(err).decode()
        raise RuntimeError(f"flash_attn_bwd ({route}) launch failed: {msg} ({err})")
    bwd_launches.add()
    if route == "mma_sync":
        bwd_mma_launches.add()
    return grads


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        layout: str = "merged"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (heads-first, dO's dtype) of the forward that gave O and
    lse. CPU tensors take the plain version; CUDA tensors launch the Hopper
    kernels of ``bwd_route(Dh)`` (bf16 q/k/v/O/dO, float32 lse, Dh a
    multiple of 16 up to 128) or raise."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of {LAYOUTS}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, layout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd runs on cuda or cpu, not {q.device}")
    return _flash_attention_bwd_cuda(q, k, v, o, do, lse, layout, bwd_route(q.shape[-1]))


class FlashAttention(torch.autograd.Function):
    """(q, k, v, layout, impl) -> (O, lse), differentiable in q, k, v.

    ``impl="kernel"`` runs the wrappers (the Hopper kernels on CUDA tensors,
    the plain versions on CPU tensors); ``"plain"`` always runs the plain
    versions. Both differentiate through the TPU kernels' rounding points.
    lse is not differentiable.
    """

    @staticmethod
    def forward(ctx, q, k, v, layout, impl):
        if impl not in IMPLS:
            raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
        fwd = flash_attn_fwd_op if impl == "kernel" else flash_attention_fwd_plain
        o, lse = fwd(q, k, v, layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.layout, ctx.impl = layout, impl
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if ctx.impl == "kernel" else flash_attention_bwd_plain
        # The incoming gradient may be a broadcast or a strided view.
        dq, dk, dv = bwd(q, k, v, o, do.contiguous(), lse, ctx.layout)
        return dq, dk, dv, None, None


def _attention(q, k, v, layout: str, impl: str) -> torch.Tensor:
    """O of ``FlashAttention``; without a gradient to keep, the forward op
    alone (one node in an exported graph)."""
    if impl == "kernel" and not (torch.is_grad_enabled()
                                 and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attn_fwd_op(q, k, v, layout)[0]
    return FlashAttention.apply(q, k, v, layout, impl)[0]


def flash_attention_blo(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        impl: str = "kernel") -> torch.Tensor:
    """Heads-first in, merged heads out: (B, H, L, Dh) -> (B, L, H·Dh).
    Counterpart of ``flash_attention_blo`` (TPU kernels #1 and #3)."""
    return _attention(q, k, v, "merged", impl)


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "kernel") -> torch.Tensor:
    """Heads-first in and out: (B, H, L, Dh) -> (B, H, L, Dh). Counterpart of
    ``flash_attention_bhld`` (TPU kernels #2 and #4)."""
    return _attention(q, k, v, "heads_first", impl)


def flash_attention_bloq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "kernel") -> torch.Tensor:
    """Counterpart of the q-blocked ``_flash_bloq`` (TPU kernel #5):
    (B, H, L, Dh) -> (B, L, H·Dh).

    On the TPU, blocking the q rows was a separate kernel that padded them
    to whole blocks. On Hopper it is the kernels' ordinary tiling: the
    backward walks every 64-row q tile, sums dk and dv over the tiles in
    float32 and rounds them once, gives rows past L P = 0 so they add
    nothing, and returns dq for the L real rows. So this entry runs the same
    forward and backward as ``flash_attention_blo``.
    """
    return _attention(q, k, v, "merged", impl)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    impl: str = "kernel") -> torch.Tensor:
    """Token-major in and out: (B, L, H, Dh) -> (B, L, H, Dh). Counterpart
    of ``flash_attention`` (TPU kernels #2 and #4): q, k, v enter the kernels
    as heads-first views, and the merged output is (B, L, H, Dh) as it lies."""
    b, l, h, d = q.shape
    return flash_attention_blo(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               impl).view(b, l, h, d)
