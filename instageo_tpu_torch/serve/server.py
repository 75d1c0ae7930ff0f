"""Model server: a resident model that answers evaluation, batch and online
requests.

Counterpart of ``instageo_tpu/serve/server.py:ModelServer``. The server is
in-process: the model a config describes is built once through
``train/factory.py:create_model`` (the config's ``checkpoint_path``, else its
pretrained encoder, else a fresh init) onto the device, and requests reach it
as a test-set evaluation, a batch run over a loader or chip files, online
single chips through a dynamic micro-batcher, or an export of the serving
forward. The batch path preprocesses raw chips with the config's
``dataloader`` settings.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.serve.batching import DynamicBatcher
from instageo_tpu_torch.serve.infer import (
    chip_inference,
    chip_inference_from_paths,
    make_predict_fn,
)

log = logging.getLogger(__name__)


def place_for_serving(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """The JAX server's placement on a mesh: tensor-parallel shards when
    ``tpu.tp`` > 1, else replicated (rank 0's weights on every rank)."""
    from instageo_tpu_torch.parallel.mesh import replicate_tree
    from instageo_tpu_torch.parallel.tp import has_model_axis, tp_place

    if mesh is None:
        return model
    replicate_tree(model, mesh)
    if has_model_axis(mesh):
        tp_place(model, mesh)
        model.placement = "tp"
    else:
        model.placement = "dp"
    return model


def serving_shard(mesh) -> Tuple[Tuple[int, int], bool]:
    """((share, of shares) of each batch's rows, whether this rank writes):
    a share per rank of a replicated model, a share per data index under
    tensor parallelism, written by the first rank of its ``model`` group."""
    from instageo_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_rank, axis_size

    if mesh is None:
        return (0, 1), True
    if axis_size(mesh, MODEL_AXIS) > 1:
        return ((axis_rank(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)),
                axis_rank(mesh, MODEL_AXIS) == 0)
    return (mesh.get_rank(), mesh.size()), True


class ModelServer:
    """Loads the model of ``cfg`` and serves it on one device: ``cuda``
    unless ``device`` (or the config's top-level ``device``) asks for the
    CPU. Under ``torchrun`` (a process group) it serves on the run's mesh
    (``parallel/mesh.py:mesh_from_config``): ``place_for_serving``, and each
    rank predicts its share of each batch (``serving_shard``). Reference
    surface: model_server.py:48-154."""

    def __init__(self, cfg: Any, device=None) -> None:
        from instageo_tpu_torch.parallel.mesh import mesh_from_config
        from instageo_tpu_torch.train.factory import create_model

        self.cfg = cfg
        self.device = resolve_device(device if device is not None else cfg.get("device"))
        self.mesh = mesh_from_config(cfg.get("tpu"))
        self.model = place_for_serving(create_model(cfg, device=self.device).eval(), self.mesh)
        self.shard, self.writes = serving_shard(self.mesh)
        dl = cfg.dataloader
        self.is_reg_task = bool(cfg.get("is_reg_task", False))
        self.preprocess = dict(
            mean=list(dl.mean), std=list(dl.std),
            temporal_size=int(dl.get("temporal_dim", 1)), bands=dl.get("bands"),
            constant_multiplier=float(dl.get("constant_multiplier", 1.0)),
            img_size=int(dl.get("img_size", 224)))
        self._lock = threading.Lock()
        self._trainer = None
        self._batcher: Optional[DynamicBatcher] = None
        self._batcher_cfg = None
        self.start_time = time.time()
        self.requests_served = 0
        log.info("ModelServer ready on %s", self.device)

    @property
    def uses_coords(self) -> bool:
        """Whether the model takes each chip's time and location coords (a
        ``_tl`` variant): its fused predict
        (``ops/preprocess.py:make_fused_predict_fn``) then wants them, and
        warns once when called without them."""
        return self.model.uses_coords

    def _served(self) -> None:
        with self._lock:
            self.requests_served += 1

    def evaluate(self, dataloader_factory, batch_size: Optional[int] = None
                 ) -> Dict[str, float]:
        """Test-set metrics over ``dataloader_factory()``'s batches
        (``Trainer.test``; reference model_server.py:72-89)."""
        from instageo_tpu_torch.train.trainer import Trainer

        if self._trainer is None:
            self._trainer = Trainer(self.cfg, self.model, device=self.device, mesh=self.mesh)
        t0 = time.time()
        metrics = self._trainer.test(dataloader_factory, batch_size)
        metrics["inference_time"] = time.time() - t0
        self._served()
        return metrics

    def chip_inference(self, dataloader: Iterable, out_dir: str) -> Dict[str, Any]:
        """Prediction GeoTIFFs for an ``infer_collate`` loader's chips, with
        threaded writes (reference :91-127)."""
        n, dt = chip_inference(dataloader, out_dir, self.model, is_reg_task=self.is_reg_task,
                               shard=self.shard, write=self.writes)
        self._served()
        return {"num_chips": n, "inference_time": dt, "chips_per_sec": n / dt if dt else 0.0}

    def chip_inference_from_paths(self, chip_paths: List[str], out_dir: str,
                                  batch_size: int = 64) -> Dict[str, Any]:
        """Raw chip files -> prediction GeoTIFFs in ``out_dir``, preprocessed
        on the device."""
        n, dt = chip_inference_from_paths(
            chip_paths, out_dir, self.model, is_reg_task=self.is_reg_task,
            batch_size=batch_size, **self.preprocess)
        self._served()
        return {"num_chips": n, "inference_time": dt, "chips_per_sec": n / dt if dt else 0.0}

    def online_batcher(self, max_batch: int = 64, max_wait_ms: float = 5.0
                       ) -> DynamicBatcher:
        """Dynamic micro-batcher for online requests: ``submit`` one
        preprocessed (C, T, H, W) chip, get a future of its prediction.
        Other knobs than the running batcher's close it and start a new one."""
        with self._lock:
            cfg = (max_batch, max_wait_ms)
            if self._batcher is not None and self._batcher_cfg != cfg:
                self._batcher.close()
                self._batcher = None
            if self._batcher is None:
                predict = make_predict_fn(self.model, is_reg_task=self.is_reg_task)
                self._batcher = DynamicBatcher(
                    lambda x: predict(x).cpu().numpy(),
                    max_batch=max_batch, max_wait_ms=max_wait_ms)
                self._batcher_cfg = cfg
            return self._batcher

    def export_artifact(self, path: str, *, batch_size: Optional[int] = None,
                        probabilities: bool = False) -> str:
        """The serving forward as a ``torch.export`` artifact on this
        server's device (``serve/export.py``): weights as an argument, a
        symbolic batch unless pinned, shaped from the dataloader config."""
        from instageo_tpu_torch.serve.export import export_predict

        return export_predict(
            self.model, path, num_bands=int(self.model.arch.in_chans),
            img_size=self.preprocess["img_size"],
            temporal_dim=self.preprocess["temporal_size"], is_reg_task=self.is_reg_task,
            probabilities=probabilities, batch_size=batch_size)

    def close(self) -> None:
        """Stop the batcher's worker thread (it holds the model)."""
        with self._lock:
            if self._batcher is not None:
                self._batcher.close()
                self._batcher = None

    def health_check(self) -> Dict[str, Any]:
        """Reference model_server.py:129-141."""
        return {
            "status": "healthy",
            "uptime_s": time.time() - self.start_time,
            "requests_served": self.requests_served,
            "device": self.get_device_info(),
        }

    def get_device_info(self) -> Dict[str, Any]:
        """The card's name and count (reference model_server.py:143-154)."""
        if self.device.type == "cuda":
            return {
                "platform": "gpu",
                "device": str(self.device),
                "device_kind": torch.cuda.get_device_name(self.device),
                "num_devices": torch.cuda.device_count(),
            }
        return {"platform": self.device.type, "device": str(self.device),
                "device_kind": self.device.type, "num_devices": 1}
