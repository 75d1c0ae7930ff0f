"""``train/optim.py``'s AdamW: device time of the optimizer's kernels per
optimizer step of the traced stretch."""

from h100bench import layers, tracing


def read(summary, ctx, name):
    steps = layers.units(summary, "steps")
    seconds = tracing.class_seconds(summary, "optimizer")
    if steps <= 0 or seconds <= 0.0:
        return None
    return 1e3 * seconds / steps
