"""The encoder's and the head's work outside matrix products: device time
of the kernels that are not matmuls, convolutions, the port's own kernels,
copies or the optimizer, per chip of the traced stretch."""

from h100bench import layers, tracing


def read(summary, ctx, name):
    chips = layers.units(summary, "chips")
    if chips <= 0 or summary["busy_s"] <= 0.0:
        return None
    return 1e3 * tracing.class_seconds(summary, "other") / chips
