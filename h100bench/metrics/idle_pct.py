"""Device idle: the share of the traced stretch in which no kernel, memcpy
or memset ran (``tracing.summarize``)."""


def read(summary, ctx, name):
    if summary["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
