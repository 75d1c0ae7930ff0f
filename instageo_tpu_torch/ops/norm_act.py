"""The encoder blocks' LayerNorm in bf16: Hopper kernels + plain versions.

Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which fuses
its float32 casts. The plain versions are the port's float32 round trip:
LayerNorm of ``x.float()`` with float32 weight and bias, rounded back to x's
dtype once, and its backward as autograd takes it (the gradient cast to
float32, the float32 backward, the result rounded to x's dtype). The kernels
(``csrc/norm_act.cu``) read bf16 and write bf16 in one pass, with the same
float32 arithmetic in registers and the same rounding points, so they
differ from the plain versions only by float32 summation order.

The blocks' exact GELU needs no kernel of its own: PyTorch's CUDA GELU
computes a bf16 tensor in float32 and rounds once, forward and backward, so
``F.gelu`` on the bf16 tensor gives the float32 round trip's bits without
its casts (``models/prithvi.py:Mlp``).

``layer_norm`` is what the model calls: a CUDA tensor of any dtype but
float32 takes the kernel (bf16, or the wrapper raises); a CPU tensor or a
float32 one takes the plain version. The kernels' wrappers are custom ops
(``instageo_tpu_torch::ln_rows_fwd``, ``::ln_rows_bwd``) with fake versions
for shapes, and the forward op is differentiable through the backward op:
``torch.export`` records each as one node, and CUDA graph capture and
``torch.utils.checkpoint`` run them as they run any op. On a CPU tensor the
ops run the plain versions.

Each wrapper counts its calls on a ``LaunchCounter`` (graph replays
included): ``ln_launches``, ``ln_bwd_launches`` (one per call: the row
kernel and the column sums).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from instageo_tpu_torch.ops._build import Kernel, LaunchCounter, call_on_device

MAX_WIDTH = 2048  # the row kernels keep a row in one warp's registers

ln_launches = LaunchCounter()        # LayerNorm forward kernel
ln_bwd_launches = LaunchCounter()    # LayerNorm backward (row kernel + column sums)
KERNELS = (Kernel("ln_rows_bf16_fwd", "norm_act", ln_launches),
           Kernel("ln_rows_bf16_bwd", "norm_act", ln_bwd_launches))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def ln_rows_fwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm over x's last dim in float32, rounded to x's dtype: (y, mean,
    rstd), the statistics float32 of shape x.shape[:-1]."""
    y, mean, rstd = torch.native_layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return y.to(x.dtype), mean.reshape(x.shape[:-1]), rstd.reshape(x.shape[:-1])


def ln_rows_bwd_plain(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, weight: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``ln_rows_fwd_plain`` as autograd takes it: (dx in x's
    dtype, dweight, dbias float32)."""
    stats = x.shape[:-1] + (1,)
    dx, dw, db = torch.ops.aten.native_layer_norm_backward(
        dy.float(), x.float(), (x.shape[-1],), mean.reshape(stats), rstd.reshape(stats),
        weight, torch.zeros_like(weight), [True, True, True])
    return dx.to(x.dtype), dw, db


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _entries():
    """The library's C entries, bound once: (ln forward, ln backward, ln
    backward's blocks, error string)."""
    from instageo_tpu_torch.ops import _build

    lib = _build.load("norm_act")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    table = (
        (lib.ln_rows_bf16_forward, [p] * 6 + [ll, i, ctypes.c_float, p]),
        (lib.ln_rows_bf16_backward, [p] * 9 + [ll, i, i, p]),
        (lib.ln_rows_bf16_backward_blocks, [ll, i]),
    )
    for fn, argtypes in table:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = lib.norm_act_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return tuple(fn for fn, _ in table) + (err,)


def _bf16(name: str, x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` as the kernels read it: a bf16 tensor on ``device`` whose last
    dim is contiguous, its rows packed (a copy where they are not), 16-byte
    aligned."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the input on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the norm_act kernels take bfloat16; {name} is {x.dtype}")
    if x.dim() == 0 or x.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return x


def check_width(d: int) -> None:
    """Widths the row kernels take: multiples of 8 up to ``MAX_WIDTH``."""
    if d <= 0 or d % 8 or d > MAX_WIDTH:
        raise ValueError(f"the LayerNorm kernels take widths that are multiples of 8 up to "
                         f"{MAX_WIDTH}; got {d}")


def _param(name: str, p: torch.Tensor, d: int, device: torch.device) -> torch.Tensor:
    """A float32 LayerNorm parameter of ``d`` elements on ``device``, 16-byte
    aligned (a misaligned view, as a sharded parameter's may be, is copied)."""
    if p.device != device or p.dtype != torch.float32 or tuple(p.shape) != (d,):
        raise ValueError(f"{name} must be float32 ({d},) on {device}; got {p.dtype} "
                         f"{tuple(p.shape)} on {p.device}")
    if not p.is_contiguous() or p.data_ptr() % 16:
        p = p.clone(memory_format=torch.contiguous_format)
    return p


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _entries()[-1](err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _ln_rows_fwd_cuda(x, weight, bias, eps):
    x = _bf16("x", x, x.device)
    d = x.shape[-1]
    check_width(d)
    weight, bias = _param("weight", weight, d, x.device), _param("bias", bias, d, x.device)
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    fwd = _entries()[0]
    _raise_on(call_on_device(x.device, fwd, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                             y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), mean.numel(),
                             d, float(eps)), "ln_rows_bf16_fwd")
    ln_launches.add()
    return y, mean, rstd


@functools.lru_cache(maxsize=256)
def _bwd_blocks(rows: int, d: int, device_index: int) -> int:
    """The rows of the backward's partial sums at this shape on this card."""
    with torch.cuda.device(device_index):
        return _entries()[2](rows, d)


def _ln_rows_bwd_cuda(dy, x, mean, rstd, weight):
    dy, x = _bf16("dy", dy, x.device), _bf16("x", x, x.device)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} and x {tuple(x.shape)} differ")
    d = x.shape[-1]
    check_width(d)
    rows = x.numel() // d
    for name, s in (("mean", mean), ("rstd", rstd)):
        if (s.device != x.device or s.dtype != torch.float32 or s.numel() != rows
                or not s.is_contiguous()):
            raise ValueError(f"{name} must be the forward's contiguous float32 statistics, "
                             f"{rows} on {x.device}")
    weight = _param("weight", weight, d, x.device)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    blocks = _bwd_blocks(rows, d, x.device.index if x.device.index is not None
                         else torch.cuda.current_device())
    partial = torch.empty((2, blocks, d), dtype=torch.float32, device=x.device)
    bwd = _entries()[1]
    _raise_on(call_on_device(x.device, bwd, dy.data_ptr(), x.data_ptr(), mean.data_ptr(),
                             rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(),
                             partial.data_ptr(), dw.data_ptr(), db.data_ptr(), rows, d,
                             blocks), "ln_rows_bf16_bwd")
    ln_bwd_launches.add()
    return dx, dw, db


def _route(x: torch.Tensor, plain, cuda, *args):
    """``plain`` on a CPU tensor, ``cuda`` (the kernel or raise) on a CUDA one."""
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"the norm_act ops run on cuda or cpu, not {x.device}")
    return cuda(*args)


# ---------------------------------------------------------------------------
# Custom ops
# ---------------------------------------------------------------------------


@torch.library.custom_op("instageo_tpu_torch::ln_rows_fwd", mutates_args=())
def ln_rows_fwd_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, rstd) of LayerNorm over x's last dim: the kernel on a CUDA
    tensor (bf16, or raise), the plain version on a CPU tensor."""
    return _route(x, ln_rows_fwd_plain, _ln_rows_fwd_cuda, x, weight, bias, eps)


@ln_rows_fwd_op.register_fake
def _ln_rows_fwd_fake(x, weight, bias, eps):
    stats = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return torch.empty_like(x), stats, torch.empty_like(stats)


@torch.library.custom_op("instageo_tpu_torch::ln_rows_bwd", mutates_args=())
def ln_rows_bwd_op(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                   weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dweight, dbias) of ``ln_rows_fwd_op``'s y."""
    return _route(x, ln_rows_bwd_plain, _ln_rows_bwd_cuda, dy, x, mean, rstd, weight)


@ln_rows_bwd_op.register_fake
def _ln_rows_bwd_fake(dy, x, mean, rstd, weight):
    return torch.empty_like(x), torch.empty_like(weight), torch.empty_like(weight)


def _ln_setup(ctx, inputs, output):
    x, weight, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, mean, rstd, weight)


def _ln_backward(ctx, dy, _dmean, _drstd):
    x, mean, rstd, weight = ctx.saved_tensors
    # The incoming gradient may be a broadcast or a strided view.
    dx, dw, db = ln_rows_bwd_op(dy.contiguous(), x, mean, rstd, weight)
    return dx, dw, db, None


ln_rows_fwd_op.register_autograd(_ln_backward, setup_context=_ln_setup)


# ---------------------------------------------------------------------------
# What the model calls
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over x's last dim, statistics and affine in float32, rounded
    once to x's dtype; differentiable. A CUDA tensor not in float32 goes
    through the kernels (bf16, or they raise); a CPU or float32 tensor
    through the plain version."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return ln_rows_fwd_op(x, weight, bias, eps)[0]
    return ln_rows_fwd_plain(x, weight, bias, eps)[0]
