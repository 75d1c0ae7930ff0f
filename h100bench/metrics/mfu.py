"""The whole step's share of the card's bf16 peak: the model's FLOPs per
chip (counted over the plain reference's forward; training counts three
forwards: the forward, and the backward's two products per forward product)
times the chips done in the traced stretch, over its length on the device,
over 989 TFLOP/s."""

from h100bench import counts, layers


def read(summary, ctx, name):
    chips = layers.units(summary, "chips")
    if chips <= 0 or summary["window_s"] <= 0.0:
        return None
    mult = 3.0 if layers.training(ctx) else 1.0
    rate = mult * layers.flops_per_chip(ctx) * chips / summary["window_s"]
    return 100.0 * rate / counts.PEAK_BF16_FLOPS
