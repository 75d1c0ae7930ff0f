"""PyTorch/CUDA port of ``instageo_tpu`` for NVIDIA Hopper (H100).

The JAX package ``instageo_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``serve/``, ``data/``) and imports nothing of
it. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The Pallas TPU kernels on the ported path are hand-written CUDA kernels
under ``ops/csrc/``, built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

__all__ = [
    "configs",
    "data",
    "models",
    "ops",
    "parallel",
    "serve",
    "train",
    "utils",
    "webapp",
]
