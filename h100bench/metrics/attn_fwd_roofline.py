"""Kernel #1, the attention forward (``flash_attn_fwd*`` kernels): the sum
of each call's bound (``counts.attention_fwd`` at the cell's shape; calls
from the program's launch counter) over the kernels' device time."""

from h100bench import counts, layers, tracing


def read(summary, ctx, name):
    calls = layers.units(summary, "attn_fwd_calls")
    seconds = tracing.class_seconds(summary, "attn_fwd")
    if calls <= 0 or seconds <= 0.0:
        return None
    bound = counts.bound_s(*counts.attention_fwd(*layers.attention_shape(ctx)))
    return counts.share_pct(calls * bound, seconds)
