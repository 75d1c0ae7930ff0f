"""The device mesh of a run, the batch rows of each rank, and ZeRO-1.

Counterpart of ``instageo_tpu/parallel/mesh.py``. A run is one process per
card (``parallel/multihost.py``); its ranks form a ``DeviceMesh`` with the
JAX package's axis names: ``data`` alone; ``(data, model)`` with ``tpu.tp``
> 1 (``parallel/tp.py``); ``(data, pipe)`` with ``tpu.pp`` > 1
(``parallel/pp.py``), the second axis the fast one (rank = data index ·
size + index on it), as the JAX meshes lay them out. ``tpu.mesh`` is
``auto`` (the world) or the world's size. A process outside any group has
no mesh (``None``): every helper then treats it as a world of one.

The global batch is the JAX trainer's: ``train.batch_size`` rows, padded
to a multiple of world size × ``train.grad_accum``; rank r of the data
axis takes its share of each micro-batch (``shard_batch``), which is what
``jax.device_put`` of the batch over the ``data`` axis gives each device.

ZeRO-1 (``tpu.zero1``) shards the AdamW moments over the data axis:
``zero1_place`` wraps AdamW in ``ZeroRedundancyOptimizer``, which gives each
rank the moments of a share of the parameters and broadcasts the updated
parameters. The JAX package shards each moment's dim 0 instead
(``zero1_shardable``); the layout differs, the update does not.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from instageo_tpu_torch.ops._build import HostCounter

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

# Below this many elements a leaf stays replicated under ZeRO-1 and FSDP
# (the JAX package's rule; parallel/fsdp.py).
MIN_SHARD_ELEMS = 1 << 16

# The port's own collectives, counted where they are called (tp.py, pp.py,
# all_reduce_sum, the trainer's gradient sync and global sums,
# multihost.aggregate_metrics; FSDP2's, ZeroRedundancyOptimizer's and the
# broadcasts are not counted here).
collectives = {name: HostCounter() for name in
               ("all_reduce", "all_gather", "reduce_scatter", "p2p")}


def reset_collectives() -> None:
    for counter in collectives.values():
        counter.reset()


def read_collectives() -> dict:
    return {name: counter.count for name, counter in collectives.items()}


def zero1_shardable(x: Any, n_data: int) -> bool:
    """The JAX package's ZeRO-1 predicate: dim 0 divisible by the data axis
    and at least ``MIN_SHARD_ELEMS`` elements."""
    shape = tuple(getattr(x, "shape", ()))
    return len(shape) >= 1 and shape[0] % n_data == 0 and int(np.prod(shape)) >= MIN_SHARD_ELEMS


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh():
    """1-D ``data`` mesh over the world."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def make_mesh_axes(second: str, size: int):
    """(data, ``second``) mesh with ``second`` of ``size`` the fast axis."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % size:
        raise ValueError(f"tpu.{'tp' if second == MODEL_AXIS else 'pp'}={size} must divide "
                         f"the world of {n} processes")
    return init_device_mesh(_device_type(), (n // size, size),
                            mesh_dim_names=(DATA_AXIS, second))


def mesh_from_config(tpu_cfg: Any):
    """The run's mesh from ``tpu.mesh`` (``auto`` or the world's size),
    ``tpu.tp`` and ``tpu.pp``; None in a process outside any group, where
    ``tpu.mesh`` may only be ``auto`` or 1 and tp, pp only 1."""
    tpu_cfg = tpu_cfg or {}
    spec = tpu_cfg.get("mesh", "auto")
    tp, pp = int(tpu_cfg.get("tp", 1)), int(tpu_cfg.get("pp", 1))
    if tp > 1 and pp > 1:
        raise ValueError("tpu.tp and tpu.pp are mutually exclusive")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if spec not in (None, "auto") and int(spec) != world:
        raise ValueError(f"tpu.mesh={spec} but the run has WORLD_SIZE={world} processes "
                         "(start one process per card with torchrun)")
    if not dist.is_initialized():
        if tp > 1 or pp > 1:
            raise ValueError(f"tpu.tp={tp} / tpu.pp={pp} need one process per rank: start "
                             "the run with python -m torch.distributed.run")
        return None
    if tp > 1:
        from instageo_tpu_torch.parallel.tp import make_mesh_2d

        return make_mesh_2d(tp)
    if pp > 1:
        from instageo_tpu_torch.parallel.pp import make_mesh_pp

        return make_mesh_pp(pp)
    return make_mesh()


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis`` that holds this rank (None without it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def axis_ranks(mesh, axis: str) -> list:
    """Global ranks along ``axis`` through this rank, in axis order."""
    return dist.get_process_group_ranks(axis_group(mesh, axis))


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def _rows(x, mesh, accum: int, axis: int):
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return x
    d = axis_rank(mesh, DATA_AXIS)
    shape = tuple(x.shape)
    b = shape[axis]
    if b % (accum * n):
        raise ValueError(f"a batch of {b} rows does not split into {accum} micro-batches "
                         f"over a data axis of {n}")
    per = b // (accum * n)
    split = shape[:axis] + (accum, n, per) + shape[axis + 1:]
    local = x.reshape(split)
    local = local[(slice(None),) * (axis + 1) + (d,)]
    return local.reshape(shape[:axis] + (accum * per,) + shape[axis + 1:])


def shard_batch(batch: Any, mesh, accum: int = 1) -> Any:
    """This rank's rows of a global batch (an array or tensor, or a tuple
    or list of them): of each of ``accum`` micro-batches (consecutive row
    blocks), the share of data index d, concatenated in micro-batch order.
    Without a data axis, the batch as it is."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh, accum) for x in batch)
    return _rows(batch, mesh, accum, 0)


def shard_stacked_batch(batch: Any, mesh) -> Any:
    """``shard_batch`` of ``(k, B, ...)`` stacks: rows on the second axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_stacked_batch(x, mesh) for x in batch)
    return _rows(batch, mesh, 1, 1)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        collectives["all_reduce"].add()
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        collectives["all_reduce"].add()
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``: every rank's result is the sum, and
    the gradient of each rank's input is the sum of the gradients."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def replicate_tree(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every rank takes rank 0's parameters and buffers (one broadcast per
    tensor), so that replicas start equal."""
    if mesh is None or mesh.size() == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


def zero1_place(params, mesh, **adamw_kwargs):
    """AdamW (``torch.optim.AdamW(**adamw_kwargs)``, as ``train/optim.py``
    builds it) whose moments are sharded over the data axis:
    ``ZeroRedundancyOptimizer`` on the data axis's group. Without a data
    axis of more than one rank, the AdamW itself."""
    params = list(params)
    if axis_size(mesh, DATA_AXIS) == 1:
        return torch.optim.AdamW(params, **adamw_kwargs)
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=torch.optim.AdamW,
                                   process_group=axis_group(mesh, DATA_AXIS), **adamw_kwargs)


def pad_batch(arrays: Sequence[np.ndarray], batch_size: int,
              label_fill: float = -100, repeat_inputs: bool = False) -> tuple:
    """Pad (inputs, labels) along the leading dim to ``batch_size``; labels
    get ``label_fill``. ``repeat_inputs`` pads the inputs by cycling the
    real samples instead of with zeros, so that train-mode BatchNorm
    statistics stay on-distribution. Returns (inputs, labels, n_real)."""
    x, y = arrays
    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad_n = batch_size - n
    if repeat_inputs and n > 0:
        x_fill = x[np.arange(pad_n) % n]
    else:
        x_fill = np.zeros((pad_n,) + x.shape[1:], x.dtype)
    x_pad = np.concatenate([x, x_fill], axis=0)
    y_pad = np.concatenate([y, np.full((pad_n,) + y.shape[1:], label_fill, y.dtype)],
                           axis=0)
    return x_pad, y_pad, n
