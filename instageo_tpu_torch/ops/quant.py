"""Dynamic int8 (W8A8) matmuls for inference serving (``tpu.quant: int8``).

Counterpart of ``instageo_tpu/ops/quant.py``:

- **weights**: symmetric int8 per output channel (scale = max|w|/127 over
  each row of a (N, D) ``nn.Linear`` weight, which is each column of the
  JAX (D, N) kernel);
- **activations**: dynamic symmetric int8 per token along the contraction
  axis (scale = max|x|/127 per row), no calibration state;
- **accumulation**: int32 (``torch._int_mm``), rescaled in float32 by the
  outer product of the two scale vectors, the float32 bias added, then cast
  to the compute dtype.

The JAX package computes the product with ``lax.dot_general`` outside any
Pallas kernel and leaves the quantize passes to XLA fusion, so here the
product is the library's int8 GEMM and the passes are plain torch ops; no
kernel of this repository is involved. On a CUDA tensor ``_int_mm`` takes
M > 16 rows and K, N multiples of 8 (every Prithvi width does: M = B·L ≥
197, D ∈ {768, 1024, 1280}); another shape raises, it is not run in bf16.

Inference only: rounding has a zero gradient, so the trainer refuses
``tpu.quant`` at its training entry points (``Trainer._reject_quant_training``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

_EPS = 1e-8
QUANTS = ("none", "int8")


def quantize_symmetric(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim``: ``(q, scale)`` with ``q``
    int8 in [-127, 127] and ``scale`` float32 shaped like ``x`` with ``dim``
    reduced to 1, such that ``q * scale ≈ x`` (round half to even)."""
    # abs and max are exact in x's dtype; the divisions promote to float32
    # and divide by tensors (a CUDA division by a Python scalar multiplies
    # by its rounded reciprocal, which is not the CPU's or JAX's value).
    amax = x.abs().amax(dim=dim, keepdim=True).float()
    scale = amax.clamp_min(_EPS) / torch.full_like(amax, 127.0)
    q = (x / scale).round_().clamp_(-127.0, 127.0).to(torch.int8)
    return q, scale


def _check_int_mm(m: int, k: int, n: int) -> None:
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(
            f"int8_matmul on the card takes M > 16 rows and K, N multiples of 8 "
            f"(torch._int_mm); got M={m}, K={k}, N={n}")


def int8_matmul(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32,
                weight_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` with dynamic W8A8 quantization.

    ``x`` is (..., K), ``weight`` the (N, K) float32 ``nn.Linear`` weight;
    ``weight_q``, where given, is ``quantize_symmetric(weight)`` computed
    earlier. Returns (..., N) in ``dtype``."""
    k = x.shape[-1]
    n = weight.shape[0]
    x2 = x.reshape(-1, k)
    if x2.is_cuda:
        _check_int_mm(x2.shape[0], k, n)
    xq, xs = quantize_symmetric(x2, dim=-1)            # (M, K), (M, 1)
    wq, ws = weight_q if weight_q is not None else quantize_symmetric(weight, dim=-1)
    acc = torch._int_mm(xq, wq.t())                    # (M, N) int32
    out = (acc * xs).mul_(ws.t())                      # float32: (M, N) * (M, 1) * (1, N)
    if bias is not None:
        # The float32 sum rounded once to dtype, in one pass.
        out = torch.add(out, bias.float(), out=torch.empty_like(out, dtype=dtype))
    return out.to(dtype).reshape(*x.shape[:-1], n)


class QuantLinear(nn.Module):
    """``nn.Linear(in_features, out_features)`` with an int8 forward.

    Its parameters (``weight`` (N, K), ``bias`` (N,), float32) and state-dict
    keys are those of ``nn.Linear``, so the weight bridge and checkpoints do
    not change (the JAX ``QuantDense`` keeps ``nn.Dense``'s tree likewise).
    It is not an ``nn.Linear``: casting a model's matmul weights to the
    compute dtype leaves its float32 weight alone. The quantized weight is
    computed once per loaded weight (its storage and version) in eager
    calls; a traced call (``torch.export``) quantizes in the graph."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        self._cache: Optional[tuple] = None

    def _weight_q(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        w = self.weight
        if type(w) not in (nn.Parameter, torch.Tensor):  # a fake or functional tensor
            return None
        key = (w.data_ptr(), w._version, w.device)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, quantize_symmetric(w, dim=-1))
        return self._cache[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.weight, self.bias, self.dtype, self._weight_q())

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, int8"
