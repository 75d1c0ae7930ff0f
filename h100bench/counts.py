"""The yardstick: published peaks of one H100, and the operations and bytes
that a kernel's work needs, counted from its shapes.

Peaks: NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity), which
assume the card's full 700 W power limit; a run prints the card's limit
beside every share of a peak.

A kernel's bound is the least time the card could take for its work: the
larger of its operations at the bf16 tensor-core rate and its bytes at the
HBM rate. Each input is counted as read once and each output as written
once, whatever a kernel reads again.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12     # FLOP/s, dense bf16 / fp16 tensor cores
PEAK_BYTES_PER_S = 3.35e12   # HBM3, bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """Seconds the card needs at least for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def attention_fwd(b: int, h: int, l: int, d: int):
    """(FLOPs, bytes) of one attention forward over (B, H, L, Dh): two
    L x L x Dh products; q, k, v read and O written in bf16, the float32
    log-sum-exp written."""
    flops = 4.0 * b * h * l * l * d
    nbytes = 4.0 * b * h * l * d * 2 + 4.0 * b * h * l
    return flops, nbytes


def attention_bwd(b: int, h: int, l: int, d: int):
    """(FLOPs, bytes) of one attention backward: five L x L x Dh products
    (S, dP, dQ, dK, dV); q, k, v, O, dO read and dQ, dK, dV written in
    bf16, the float32 log-sum-exp read."""
    flops = 10.0 * b * h * l * l * d
    nbytes = 16.0 * b * h * l * d + 4.0 * b * h * l
    return flops, nbytes


def dropout(numel: int, itemsize: int = 2):
    """(FLOPs, bytes) of dropout over ``numel`` elements: x read once and
    the output written once. The keep mask is not counted: storing it is
    a choice of an implementation (one that regenerates it in the backward
    does the same work without it)."""
    return 0.0, 2.0 * itemsize * numel


def share_pct(bound_seconds: float, device_seconds: float):
    """100 × bound ÷ measured device time; None where nothing ran."""
    if device_seconds <= 0.0 or bound_seconds <= 0.0:
        return None
    return 100.0 * bound_seconds / device_seconds
