"""The head's convolutions (cuDNN's kernels for its ConvTranspose2d and
Conv2d layers, the ``convolution`` class): the sum of each call's bound
(the plain reference's ``head_convs`` at the cell's batch: its FLOPs at the
bf16 peak or its bytes at the HBM rate, the larger) over the traced
stretch's requests, against the class's device time."""

from h100bench import counts, layers, tracing
from h100bench.common import reference_module


def read(summary, ctx, name):
    requests = layers.units(summary, "requests")
    seconds = tracing.class_seconds(summary, "convolution")
    if requests <= 0 or seconds <= 0.0:
        return None
    calls = reference_module(ctx.config).head_convs(ctx.config["model"], layers.micro_batch(ctx))
    bound = sum(counts.bound_s(flops, nbytes) for flops, nbytes in calls)
    return counts.share_pct(requests * bound, seconds)
