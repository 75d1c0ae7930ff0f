"""The port's operations: the hand-written CUDA kernels (``csrc/``) with
their wrappers and plain versions, and the chip, preprocessing and int8
operations around them.

Each kernel module (``KERNEL_MODULES``) declares the kernels it launches in
``KERNELS`` (``_build.Kernel``: a name, its source, its launch counters);
``kernels()`` gathers them into the one table of the port's kernels, which
``launch_counts()`` reads.
"""

from __future__ import annotations

import importlib
from typing import Dict

KERNEL_MODULES = ("attention", "dropout", "norm_act")


def kernels() -> Dict:
    """Every hand-written kernel's ``Kernel``, by name, in the modules'
    order. Importing the modules registers their custom ops."""
    return {k.name: k for module in KERNEL_MODULES
            for k in importlib.import_module(f"{__name__}.{module}").KERNELS}


def launch_counts(field: str = "total") -> Dict[str, int]:
    """Each kernel's launches in this process (``Kernel.read(field)``), by
    name; a LayerNorm backward counts once for its two kernels."""
    return {name: k.read(field) for name, k in kernels().items()}
