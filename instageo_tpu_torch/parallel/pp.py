"""Pipeline parallelism of the Prithvi blocks (GPipe over point-to-point).

Counterpart of ``instageo_tpu/parallel/pp.py``. ``tpu.pp`` = S > 1 runs on
a (data, pipe) mesh (``make_mesh_pp``): the ``depth`` blocks are cut into S
contiguous stages of depth/S, stage s on pipe rank s, and each rank's
batch share is cut into ``tpu.pp_microbatches`` = M micro-batches that
stream through the stages in the GPipe schedule: stage s takes
micro-batch j from stage s−1 (``recv``), runs its blocks and hands the
result to stage s+1 (``send``), in micro-batch order, so stage s works on
j while stage s+1 works on j−1. The last stage's outputs are broadcast to
the pipe group, and every stage runs the patch embedding, the final norm
and the head on the same rows, as the JAX package's stages do; only stage
0's embedding output enters the pipeline.

``pipeline_blocks`` is differentiable: its backward runs the reverse
schedule (the gradient of micro-batch j from stage s+1, the stage's
backward, the input gradient to stage s−1, last micro-batch first), and
broadcasts stage 0's input gradient, so every stage's embedding gets the
gradient. One hand-off per stage boundary per micro-batch, each way; the
JAX schedule's ``ppermute`` runs every one of its M+S−1 ticks, carrying
drained garbage in the fill and drain ticks, which this schedule does not
send.

A stage's blocks train on their own rank only (``pp_place``): every rank
keeps the whole model, the other stages' blocks frozen, and
``sync_stages`` broadcasts each block from its stage before a full state
dict is read.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch import nn

from instageo_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    axis_group,
    axis_rank,
    axis_ranks,
    axis_size,
    collectives,
    make_mesh_axes,
)


def make_mesh_pp(pp: int):
    """(data, pipe) mesh over the world, ``pipe`` of size ``pp``."""
    return make_mesh_axes(PIPE_AXIS, pp)


def has_pipe_axis(mesh) -> bool:
    return axis_size(mesh, PIPE_AXIS) > 1


class Pipeline:
    """This rank's place in the pipe group: its stage, the stages' global
    ranks, the blocks it runs and the micro-batch count."""

    def __init__(self, mesh, depth: int, microbatches: int) -> None:
        self.group = axis_group(mesh, PIPE_AXIS)
        self.ranks = axis_ranks(mesh, PIPE_AXIS)
        self.stages = len(self.ranks)
        self.stage = axis_rank(mesh, PIPE_AXIS)
        if depth % self.stages:
            raise ValueError(f"depth {depth} not divisible by pp={self.stages}")
        per = depth // self.stages
        self.blocks = range(self.stage * per, (self.stage + 1) * per)
        self.owner = [i // per for i in range(depth)]
        self.microbatches = int(microbatches)


def pp_specs(model: nn.Module) -> dict:
    """Parameter name -> ``"pipe"`` for the blocks (one stage holds each),
    None for the rest (every stage)."""
    return {name: PIPE_AXIS if name.startswith("prithvi_encoder.blocks.") else None
            for name, _ in model.named_parameters()}


def pp_place(model: nn.Module, mesh, microbatches: int) -> nn.Module:
    """Route the encoder's blocks through the pipeline of ``mesh``; the
    blocks of other stages stop taking gradients here."""
    encoder = model.prithvi_encoder
    pipe = Pipeline(mesh, len(encoder.blocks), microbatches)
    for i, block in enumerate(encoder.blocks):
        block.requires_grad_(i in pipe.blocks)
    encoder.pipeline = pipe
    return model


@torch.no_grad()
def sync_stages(model: nn.Module) -> None:
    """Every rank takes each block's parameters from its stage."""
    pipe = model.prithvi_encoder.pipeline
    for i, block in enumerate(model.prithvi_encoder.blocks):
        for p in block.parameters():
            dist.broadcast(p.data, src=pipe.ranks[pipe.owner[i]], group=pipe.group)


def _send(x: torch.Tensor, pipe: Pipeline, stage: int) -> None:
    dist.send(x.contiguous(), dst=pipe.ranks[stage], group=pipe.group)
    collectives["p2p"].add()


def _recv(like: torch.Tensor, pipe: Pipeline, stage: int) -> torch.Tensor:
    buf = torch.empty_like(like)
    dist.recv(buf, src=pipe.ranks[stage], group=pipe.group)
    return buf


def _schedule(blocks: List[nn.Module], tokens: torch.Tensor, pipe: Pipeline, record: bool):
    """The forward schedule; ``record`` keeps each micro-batch's graph
    (input leaf, output) for the backward. Returns (outputs, saved)."""
    s, last = pipe.stage, pipe.stages - 1
    micro = tokens.chunk(pipe.microbatches)
    saved, outs = [], []
    for j in range(pipe.microbatches):
        x = micro[j].detach() if s == 0 else _recv(micro[j], pipe, s - 1)
        if record:
            x.requires_grad_(True)
        with torch.set_grad_enabled(record):
            y = x
            for i in pipe.blocks:
                y = blocks[i](y)
        if s < last:
            _send(y.detach(), pipe, s + 1)
        else:
            outs.append(y.detach())
        saved.append((x, y))
    out = torch.cat(outs) if s == last else torch.empty_like(tokens)
    dist.broadcast(out, src=pipe.ranks[last], group=pipe.group)
    return out, (saved if record else None)


class _PipelineBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, blocks, pipe):
        out, saved = _schedule(blocks, tokens, pipe, record=True)
        ctx.saved, ctx.pipe = saved, pipe
        return out

    @staticmethod
    def backward(ctx, g):
        pipe, s, last = ctx.pipe, ctx.pipe.stage, ctx.pipe.stages - 1
        g_micro = g.chunk(pipe.microbatches)
        grads = [None] * pipe.microbatches
        for j in reversed(range(pipe.microbatches)):
            x, y = ctx.saved[j]
            gy = g_micro[j] if s == last else _recv(y, pipe, s + 1)
            torch.autograd.backward(y, gy)
            if s > 0:
                _send(x.grad, pipe, s - 1)
            else:
                grads[j] = x.grad
        ctx.saved = None
        g_in = torch.cat(grads) if s == 0 else torch.empty_like(g)
        dist.broadcast(g_in, src=pipe.ranks[0], group=pipe.group)
        return g_in, None, None


def pipeline_blocks(blocks, tokens: torch.Tensor, pipe: Pipeline) -> torch.Tensor:
    """Run ``blocks`` over ``tokens`` (B, L, D) as the GPipe pipeline of
    ``pipe``; B must split into the micro-batches. Returns (B, L, D) on
    every stage: the blocks applied in order, as on one rank."""
    if tokens.shape[0] % pipe.microbatches:
        raise ValueError(f"per-rank batch {tokens.shape[0]} not divisible by "
                         f"pp_microbatches={pipe.microbatches}")
    if torch.is_grad_enabled() and tokens.requires_grad:
        return _PipelineBlocks.apply(tokens, list(blocks), pipe)
    return _schedule(list(blocks), tokens, pipe, record=False)[0]
