"""Fully-sharded data parallelism (ZeRO-3) with FSDP2.

Counterpart of ``instageo_tpu/parallel/fsdp.py``. ``tpu.fsdp`` shards the
parameters themselves over the ``data`` axis: ``fsdp_place`` applies
``fully_shard`` to each transformer ``Block`` and then to the whole model
(the root unit holds the patch embedding, the norms and the head). FSDP2
all-gathers a unit's parameters before its forward and its backward and
reduce-scatters its gradients, the ZeRO-3 schedule that GSPMD derives in
the JAX package; the AdamW moments of a sharded parameter are sharded with
it, so ``tpu.zero1`` adds nothing under FSDP.

The placement rule is the JAX package's (``fsdp_spec_for``): a leaf is
sharded on its largest dim that the data axis divides, the first such dim
on a tie, if it has at least ``MIN_SHARD_ELEMS`` elements. FSDP2 has no
replicated placement inside a unit: a leaf the rule leaves replicated takes
FSDP2's default, dim 0 with padding, which is a layout, not a result.
Parameters stay float32 and are cast to the compute dtype where they are
used (``models/prithvi.py:_linear``), as without FSDP.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from torch import nn

from instageo_tpu_torch.parallel.mesh import MIN_SHARD_ELEMS


def fsdp_spec_for(shape: Sequence[int], n_data: int) -> Optional[int]:
    """The dim a leaf of ``shape`` is sharded on over a data axis of
    ``n_data``, or None (replicated): the JAX rule."""
    shape = tuple(int(s) for s in shape)
    if not shape or int(np.prod(shape)) < MIN_SHARD_ELEMS:
        return None
    for d in sorted(range(len(shape)), key=lambda d: (-shape[d], d)):
        if shape[d] % n_data == 0:
            return d
    return None


def fsdp_place(model: nn.Module, mesh) -> nn.Module:
    """``fully_shard`` every encoder block, then the model, over the data
    axis of ``mesh``, each parameter on its ``fsdp_spec_for`` dim."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size()  # a 1-D data mesh: FSDP excludes tp and pp

    def placement(param: nn.Parameter):
        dim = fsdp_spec_for(param.shape, n)
        return None if dim is None else Shard(dim)

    for block in model.prithvi_encoder.blocks:
        fully_shard(block, mesh=mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    return model
