"""Kernel #6, the head's dropout (``fused_dropout*``): 4 bytes per bf16
element (x read, the output written) over the calls the program counted,
against the kernels' device time."""

from h100bench import counts, layers, tracing


def read(summary, ctx, name):
    calls = layers.units(summary, "dropout_calls")
    seconds = tracing.class_seconds(summary, "dropout")
    if calls <= 0 or seconds <= 0.0:
        return None
    numel = calls * layers.dropout_numel_per_call(ctx)
    return counts.share_pct(counts.bound_s(*counts.dropout(numel)), seconds)
