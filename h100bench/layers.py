"""What a cell's traced stretch did, worked out from its configuration and
traffic: the shapes of the attention and dropout calls, the model's FLOPs
per chip. The per-layer readers take their counts from here."""

from __future__ import annotations

import functools
import json
from typing import Dict, Tuple

from h100bench.common import reference_module


def micro_batch(ctx) -> int:
    """Chips per forward: the traffic's batch over the configuration's
    ``grad_accum`` in training."""
    batch = int(ctx.traffic["batch"])
    if ctx.traffic["kind"].startswith("train"):
        return batch // int(ctx.config["program"]["train"].get("grad_accum", 1))
    return batch


def attention_shape(ctx) -> Tuple[int, int, int, int]:
    """(B, H, L, Dh) of each attention call."""
    m = ctx.config["model"]
    ref = reference_module(ctx.config)
    return (micro_batch(ctx), m["num_heads"], ref.tokens(m), m["embed_dim"] // m["num_heads"])


def dropout_numel_per_call(ctx) -> float:
    """Mean elements per dropout call of one forward."""
    ref = reference_module(ctx.config)
    shapes = ref.dropout_shapes(ctx.config["model"], micro_batch(ctx))
    total = 0
    for s in shapes:
        n = 1
        for d in s:
            n *= d
        total += n
    return total / len(shapes)


def flops_per_chip(ctx) -> float:
    """Forward FLOPs of one chip, counted over the plain reference."""
    return _flops(json.dumps(ctx.config["model"], sort_keys=True), ctx.config["reference"])


@functools.lru_cache(maxsize=8)
def _flops(model_json: str, reference: str) -> float:
    return reference_module({"reference": reference}).flops_per_chip(json.loads(model_json))


def training(ctx) -> bool:
    return ctx.traffic["kind"].startswith("train")


def units(summary: Dict, key: str) -> float:
    return float(summary.get("units", {}).get(key, 0))
