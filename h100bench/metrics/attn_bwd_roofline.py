"""Kernel #3, the attention backward (the ``flash_attn_bwd*`` launches of a
call summed): the sum of each call's bound (``counts.attention_bwd``;
calls from the program's counter) over their device time."""

from h100bench import counts, layers, tracing


def read(summary, ctx, name):
    calls = layers.units(summary, "attn_bwd_calls")
    seconds = tracing.class_seconds(summary, "attn_bwd")
    if calls <= 0 or seconds <= 0.0:
        return None
    bound = counts.bound_s(*counts.attention_bwd(*layers.attention_shape(ctx)))
    return counts.share_pct(calls * bound, seconds)
