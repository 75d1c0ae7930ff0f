"""Tensor (Megatron) and sequence parallelism of the Prithvi blocks.

Counterpart of ``instageo_tpu/parallel/tp.py`` and of ``Block.sp`` in
``instageo_tpu/models/prithvi.py``. ``tpu.tp`` = t > 1 runs on a (data,
model) mesh (``make_mesh_2d``); each rank of a ``model`` group holds 1/t of
each block's two matmul pairs:

* column-parallel ``qkv`` and ``fc1`` (their output features). The fused
  ``qkv`` weight is (3·D, D) with output rows ordered (3, H, Dh): a rank
  takes ``view(3, H, Dh, D)[:, its heads]``, so that it holds q, k and v
  of H/t whole heads and the attention kernel runs on its own (B, H/t, L,
  Dh) tensors. A contiguous split of the 3·D rows would give rank 0 all of
  q and half of k (the misalignment the JAX package's round-2 layout had);
* row-parallel ``proj`` and ``fc2`` (their input features; biases
  replicated and added after the sum).

The forward is Megatron's: ``copy_to_model`` (identity; all-reduce of the
gradient) before each column-parallel layer and ``reduce_from_model``
(all-reduce; identity gradient) after each row-parallel one: two
all-reduces per block forward. Everything else is replicated.

``tpu.sp`` shards the residual stream between the matmul pairs over the
``model`` group on its token dim: ``gather_tokens`` (all-gather; its
gradient a reduce-scatter) before ``norm → qkv`` and ``norm → fc1``'s
matmul, ``scatter_tokens`` (reduce-scatter; its gradient an all-gather)
after ``proj`` and ``fc2``. L is odd (589, 257), so the token dim is padded
with zero rows to a multiple of t and the pad dropped after each gather:
LayerNorm and the residual see no padding rows.

Parameter names are the single-card model's; ``tp_spec_for_path`` says which
dim of a parameter's view is split over ``model`` (the JAX package's
``PartitionSpec`` of the same leaf, in the torch layout), and
``tp_full_state`` / ``tp_local_state`` convert between a rank's shards and
the full state dict a single-card run saves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from instageo_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    collectives,
    make_mesh_axes,
)


def make_mesh_2d(tp: int):
    """(data, model) mesh over the world, ``model`` of size ``tp``."""
    return make_mesh_axes(MODEL_AXIS, tp)


def has_model_axis(mesh) -> bool:
    return axis_size(mesh, MODEL_AXIS) > 1


def tp_spec_for_path(path: str) -> Tuple[Optional[str], ...]:
    """The split of one parameter over ``model``, as a spec on its view:
    ``qkv.weight`` viewed (3, H, Dh, D), ``qkv.bias`` (3, H, Dh), the others
    as stored ((out, in) weights). ``()`` is replicated."""
    if path.endswith("attn.qkv.weight"):
        return (None, MODEL_AXIS, None, None)
    if path.endswith("attn.qkv.bias"):
        return (None, MODEL_AXIS, None)
    if path.endswith("mlp.fc1.weight"):
        return (MODEL_AXIS, None)
    if path.endswith("mlp.fc1.bias"):
        return (MODEL_AXIS,)
    if path.endswith(("attn.proj.weight", "mlp.fc2.weight")):
        return (None, MODEL_AXIS)
    return ()


def _view(path: str, shape: Tuple[int, ...], heads: int) -> Tuple[int, ...]:
    """The shape ``tp_spec_for_path`` refers to (``heads`` in this tensor)."""
    if path.endswith("attn.qkv.weight"):
        return (3, heads, shape[0] // (3 * heads), shape[1])
    if path.endswith("attn.qkv.bias"):
        return (3, heads, shape[0] // (3 * heads))
    return tuple(shape)


def _split_dim(path: str) -> Optional[int]:
    spec = tp_spec_for_path(path)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def tp_local(path: str, full: torch.Tensor, heads: int, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the full tensor ``full`` (``heads`` whole)."""
    dim = _split_dim(path)
    if dim is None:
        return full
    part = full.reshape(_view(path, tuple(full.shape), heads)).chunk(tp, dim=dim)[rank]
    if "qkv" in path:
        part = part.reshape((-1,) + tuple(full.shape[1:]))
    return part.contiguous()


def tp_full(path: str, local: torch.Tensor, heads_local: int, group) -> torch.Tensor:
    """The full tensor from each rank's shard (an all-gather over ``group``)."""
    dim = _split_dim(path)
    if dim is None:
        return local
    tp = dist.get_world_size(group)
    view = local.reshape(_view(path, tuple(local.shape), heads_local)).contiguous()
    parts = [torch.empty_like(view) for _ in range(tp)]
    dist.all_gather(parts, view, group=group)
    full = torch.cat(parts, dim=dim)
    if "qkv" in path:
        return full.reshape((local.shape[0] * tp,) + tuple(local.shape[1:]))
    return full


# -- the collectives, as autograd Functions ----------------------------------


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    collectives["all_reduce"].add()
    return x


def _all_gather_dim1(x: torch.Tensor, group) -> torch.Tensor:
    """(B, l, D) shards -> (B, t·l, D), ranks in order along dim 1."""
    t = dist.get_world_size(group)
    xt = x.transpose(0, 1).contiguous()
    out = torch.empty((t * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, xt, group=group)
    collectives["all_gather"].add()
    return out.transpose(0, 1)


def _reduce_scatter_dim1(x: torch.Tensor, group) -> torch.Tensor:
    """(B, t·l, D) partial sums -> this rank's (B, l, D) of their sum."""
    t = dist.get_world_size(group)
    xt = x.transpose(0, 1).contiguous()
    out = torch.empty((xt.shape[0] // t,) + tuple(xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    collectives["reduce_scatter"].add()
    return out.transpose(0, 1)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTokens(torch.autograd.Function):
    """All-gather of token shards, the pad dropped; the gradient is summed
    over the group and scattered (``reduce_grad``: the consumers on each
    rank are partial, as a column-parallel layer is) or only sliced (the
    consumers are replicated, as after the last block)."""

    @staticmethod
    def forward(ctx, x, group, length, reduce_grad):
        ctx.group, ctx.reduce_grad, ctx.padded = group, reduce_grad, x.shape[1] * \
            dist.get_world_size(group)
        return _all_gather_dim1(x, group)[:, :length]

    @staticmethod
    def backward(ctx, g):
        g = _pad_tokens(g, ctx.padded)
        if ctx.reduce_grad:
            return _reduce_scatter_dim1(g, ctx.group), None, None, None
        return _token_chunk(g, ctx.group), None, None, None


class _ScatterTokens(torch.autograd.Function):
    """Reduce-scatter of partial sums over tokens (padded to the group);
    the gradient is all-gathered, the pad dropped."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.length = group, x.shape[1]
        t = dist.get_world_size(group)
        return _reduce_scatter_dim1(_pad_tokens(x, -(-x.shape[1] // t) * t), group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim1(g, ctx.group)[:, :ctx.length].contiguous(), None


class _ChunkTokens(torch.autograd.Function):
    """This rank's token chunk of a replicated (B, L, D) stream, padded to
    the group; the gradient is all-gathered (every rank's replicated
    producer gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.length = group, x.shape[1]
        t = dist.get_world_size(group)
        return _token_chunk(_pad_tokens(x, -(-x.shape[1] // t) * t), group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim1(g, ctx.group)[:, :ctx.length].contiguous(), None


def _pad_tokens(x: torch.Tensor, padded: int) -> torch.Tensor:
    if x.shape[1] == padded:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, padded - x.shape[1]))


def _token_chunk(x: torch.Tensor, group) -> torch.Tensor:
    t, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(t, dim=1)[r].contiguous()


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def gather_tokens(x: torch.Tensor, group, length: int, reduce_grad: bool = True) -> torch.Tensor:
    return _GatherTokens.apply(x, group, length, reduce_grad)


def scatter_tokens(x: torch.Tensor, group) -> torch.Tensor:
    return _ScatterTokens.apply(x, group)


def chunk_tokens(x: torch.Tensor, group) -> torch.Tensor:
    return _ChunkTokens.apply(x, group)


# -- placement -----------------------------------------------------------------


@torch.no_grad()
def tp_place(model: nn.Module, mesh, sp: bool = False) -> nn.Module:
    """Give each block of ``model`` (full, equal on every rank) this rank's
    shards and the ``model`` group; ``sp`` also token-shards the residual
    stream. ``tp`` must divide the heads."""
    group = axis_group(mesh, MODEL_AXIS)
    tp, rank = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    encoder = model.prithvi_encoder
    for i, block in enumerate(encoder.blocks):
        heads = block.attn.num_heads
        if heads % tp:
            raise ValueError(f"tpu.tp={tp} must divide the {heads} attention heads")
        for name, param in list(block.named_parameters()):
            path = f"prithvi_encoder.blocks.{i}.{name}"
            if _split_dim(path) is None:
                continue
            owner, leaf = block.get_submodule(name.rsplit(".", 1)[0]), name.rsplit(".", 1)[1]
            setattr(owner, leaf, nn.Parameter(tp_local(path, param.data, heads, rank, tp)))
        block.set_tensor_parallel(group, heads // tp, sp)
    encoder.sp_group = group if sp else None
    return model


def sp_partial_params(model: nn.Module) -> list:
    """The replicated parameters that sequence parallelism applies to this
    rank's tokens only (the norms and the row-parallel biases): their
    gradients are partial sums over the ``model`` group."""
    if getattr(model.prithvi_encoder, "sp_group", None) is None:
        return []
    out = []
    for block in model.prithvi_encoder.blocks:
        out += [*block.norm1.parameters(), *block.norm2.parameters(),
                block.attn.proj.bias, block.mlp.fc2.bias]
    return [p for p in out if p is not None and p.requires_grad]


def tp_full_state(model: nn.Module, state: dict, group) -> dict:
    """The full (single-card) state dict from this rank's ``state``."""
    heads = {f"prithvi_encoder.blocks.{i}.": b.attn.num_heads_local
             for i, b in enumerate(model.prithvi_encoder.blocks)}
    out = {}
    for name, value in state.items():
        prefix = next((p for p in heads if name.startswith(p)), None)
        out[name] = value if prefix is None else tp_full(name, value, heads[prefix], group)
    return out


def tp_local_state(model: nn.Module, full: dict, mesh) -> dict:
    """This rank's shards of a full state dict."""
    tp, rank = axis_size(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS)
    heads = {f"prithvi_encoder.blocks.{i}.": b.attn.num_heads
             for i, b in enumerate(model.prithvi_encoder.blocks)}
    out = {}
    for name, value in full.items():
        prefix = next((p for p in heads if name.startswith(p)), None)
        out[name] = value if prefix is None else tp_local(name, value, heads[prefix], rank, tp)
    return out


def place_state_like_params(params, mesh, zero1: bool, **adamw_kwargs):
    """The AdamW of TP-placed ``params``: each rank's moments mirror its
    shards (AdamW makes them in the parameters' shapes); with ``zero1``
    they are further sharded over the data axis (``mesh.zero1_place``)."""
    from instageo_tpu_torch.parallel.mesh import zero1_place

    params = list(params)
    if zero1 and axis_size(mesh, DATA_AXIS) > 1:
        return zero1_place(params, mesh, **adamw_kwargs)
    return torch.optim.AdamW(params, **adamw_kwargs)
