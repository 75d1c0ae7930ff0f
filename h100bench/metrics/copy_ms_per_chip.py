"""Staging: device time of the copies between host and device (the
server's raw upload and the predictions' copy back; the trainer's group
staging), per chip of the traced stretch."""

from h100bench import layers, tracing


def read(summary, ctx, name):
    chips = layers.units(summary, "chips")
    seconds = tracing.transfer_seconds(summary)
    if chips <= 0 or seconds <= 0.0:
        return None
    return 1e3 * seconds / chips
