"""Model server: a resident model that answers online and batch requests.

Counterpart of ``instageo_tpu/serve/server.py:ModelServer``. The server is
in-process: the model is loaded once onto the device and requests reach it
through a dynamic micro-batcher (online, one chip each) or a batch run over
chip files. Until the training factory and the config loader are ported,
the constructor takes a built model, its state dict and the preprocessing
settings instead of a config.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import torch
from torch import nn

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.serve.batching import DynamicBatcher
from instageo_tpu_torch.serve.infer import chip_inference_from_paths, make_predict_fn

log = logging.getLogger(__name__)


class ModelServer:
    """Serves one model on one device.

    ``mean``/``std``/``bands``/``temporal_size``/``constant_multiplier``/
    ``img_size`` are the dataloader settings the batch path preprocesses raw
    chips with (a config's ``dataloader`` section).
    """

    def __init__(
        self,
        model: nn.Module,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        *,
        mean: Sequence[float],
        std: Sequence[float],
        temporal_size: int = 1,
        bands: Optional[Sequence[int]] = None,
        constant_multiplier: float = 1.0,
        img_size: Optional[int] = None,
        is_reg_task: bool = False,
        device: Union[str, torch.device, None] = None,
    ) -> None:
        self.device = resolve_device(device)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.model = model.to(self.device).eval()
        self.preprocess = dict(mean=list(mean), std=list(std),
                               temporal_size=temporal_size, bands=bands,
                               constant_multiplier=constant_multiplier,
                               img_size=img_size)
        self.is_reg_task = is_reg_task
        self._lock = threading.Lock()
        self._batcher: Optional[DynamicBatcher] = None
        self._batcher_cfg = None
        self.start_time = time.time()
        self.requests_served = 0
        log.info("ModelServer ready on %s", self.device)

    def online_batcher(self, max_batch: int = 64, max_wait_ms: float = 5.0
                       ) -> DynamicBatcher:
        """Dynamic micro-batcher for online requests: ``submit`` one
        preprocessed (C, T, H, W) chip, get a future of its prediction."""
        with self._lock:
            cfg = (max_batch, max_wait_ms)
            if self._batcher is not None and self._batcher_cfg != cfg:
                self._batcher.close()  # new knobs replace the old batcher
                self._batcher = None
            if self._batcher is None:
                predict = make_predict_fn(self.model, is_reg_task=self.is_reg_task)
                self._batcher = DynamicBatcher(
                    lambda x: predict(x).cpu().numpy(),
                    max_batch=max_batch, max_wait_ms=max_wait_ms)
                self._batcher_cfg = cfg
            return self._batcher

    def chip_inference_from_paths(self, chip_paths: List[str], out_dir: str,
                                  batch_size: int = 64) -> Dict[str, Any]:
        """Raw chip files -> prediction GeoTIFFs in ``out_dir``."""
        n, dt = chip_inference_from_paths(
            chip_paths, out_dir, self.model, is_reg_task=self.is_reg_task,
            batch_size=batch_size, **self.preprocess)
        with self._lock:
            self.requests_served += 1
        return {"num_chips": n, "inference_time": dt,
                "chips_per_sec": n / dt if dt else 0.0}

    def close(self) -> None:
        """Stop the batcher's worker thread."""
        with self._lock:
            if self._batcher is not None:
                self._batcher.close()
                self._batcher = None

    def health_check(self) -> Dict[str, Any]:
        return {
            "status": "healthy",
            "uptime_s": time.time() - self.start_time,
            "requests_served": self.requests_served,
            "device": self.get_device_info(),
        }

    def get_device_info(self) -> Dict[str, Any]:
        if self.device.type == "cuda":
            return {
                "platform": "gpu",
                "device": str(self.device),
                "device_kind": torch.cuda.get_device_name(self.device),
                "num_devices": torch.cuda.device_count(),
            }
        return {"platform": self.device.type, "device": str(self.device),
                "device_kind": self.device.type, "num_devices": 1}
