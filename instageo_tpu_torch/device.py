"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` by default.

    Raises when a CUDA device is asked for (or defaulted to) and CUDA is not
    available: an entry point never carries on on the CPU unless told to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
