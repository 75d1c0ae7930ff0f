"""Evaluation and inference pipeline over one config.

Counterpart of ``instageo_tpu/serve/pipeline.py`` (the reference
``RayEvaluationPipeline``, ``instageo/model/inference_pipeline.py``): config
validation, loader construction, server start-up, evaluation or chip
inference, and cleanup, with the server in this process on the card.

The JAX pipeline starts by turning on XLA's persistent compilation cache
(``utils/compile_cache.py``). Its port's counterpart, a settable build root
for the CUDA libraries, waits for ROADMAP item 12; the kernels are cached by
source hash under ``build/`` meanwhile (``ops/_build.py``).
"""

from __future__ import annotations

import logging
import os
from functools import partial
from typing import Any, Dict, Optional

from instageo_tpu_torch.configs.config import ConfigDict, load_config, merge
from instageo_tpu_torch.serve.server import ModelServer

log = logging.getLogger(__name__)

REQUIRED_KEYS = ("root_dir", "test_filepath", "checkpoint_path")


def dict_to_chip_inference_config(d: Dict[str, Any]) -> ConfigDict:
    """The default config with ``d`` merged over it (reference
    config_dataclasses.py:153-181)."""
    return merge(load_config("config"), d)


class EvaluationPipeline:
    """Reference ``RayEvaluationPipeline`` surface (:135-373). The server
    runs on the config's top-level ``device`` (``cuda`` when it is unset)."""

    def __init__(self, cfg: ConfigDict) -> None:
        self.cfg = cfg
        self.server: Optional[ModelServer] = None
        self._validate()

    def _validate(self) -> None:
        missing = [k for k in REQUIRED_KEYS if not self.cfg.get(k)]
        if missing:
            raise ValueError(f"Missing required config values: {missing}")
        if not os.path.exists(str(self.cfg.checkpoint_path)):
            raise FileNotFoundError(f"checkpoint_path {self.cfg.checkpoint_path} does not exist")

    def start_evaluation_pipeline(self) -> ModelServer:
        """Load the model onto the device (reference :236-278)."""
        if self.server is None:
            self.server = ModelServer(self.cfg)
        return self.server

    def _loader(self, preprocess_func, collate_fn, include_filenames: bool = False):
        from instageo_tpu_torch.data.dataloader import create_dataloader
        from instageo_tpu_torch.train.run import _make_dataset

        cfg, server = self.cfg, self.start_evaluation_pipeline()
        ds = _make_dataset(str(cfg.test_filepath), cfg, preprocess_func,
                           include_filenames=include_filenames)
        return create_dataloader(
            ds, int(cfg.train.get("batch_size", 8)), collate_fn=collate_fn,
            num_workers=int(cfg.dataloader.get("num_workers", 1)),
            worker_mode=str(cfg.dataloader.get("worker_mode", "thread")),
            prefetch_depth=int((cfg.get("tpu") or {}).get("prefetch_depth", 2)),
            device=server.device)

    def _infer_loader(self):
        """The chips of ``test_filepath`` as the run CLI's ``chip_inference``
        reads them: normalised, centre-cropped to ``img_size`` (the same
        window every run; ``save_prediction`` anchors the raster at it)."""
        from instageo_tpu_torch.data.dataloader import infer_collate
        from instageo_tpu_torch.train.run import _train_preprocess

        pre = partial(_train_preprocess(self.cfg, augment=False), crop="center")
        return self._loader(pre, infer_collate, include_filenames=True)

    def evaluate(self) -> Dict[str, float]:
        """Sliding-window test evaluation (reference :289-299): the test
        crops of each chip through ``ModelServer.evaluate``."""
        from instageo_tpu_torch.data.dataloader import eval_collate, process_test

        cfg = self.cfg
        img_size = int(cfg.test.get("img_size", 224))
        crop_size = int(cfg.test.get("crop_size", 224))
        stride = int(cfg.test.get("stride", 224))
        pre = partial(process_test, mean=list(cfg.dataloader.mean),
                      std=list(cfg.dataloader.std),
                      temporal_size=int(cfg.dataloader.get("temporal_dim", 1)),
                      img_size=img_size, crop_size=crop_size, stride=stride)
        loader = self._loader(pre, eval_collate)
        # The eval batch is the loader's batch times each image's crops.
        crops = max(1, (img_size - crop_size) // stride + 1) ** 2
        return self.server.evaluate(lambda: iter(loader),
                                    int(cfg.train.get("batch_size", 8)) * crops)

    def chip_inference(self, out_dir: Optional[str] = None) -> Dict[str, Any]:
        """Batched chip inference (reference :301-308) into ``out_dir``
        (``<root_dir>/predictions`` by default).

        By default the fused path: raw chips to the device, preprocessed
        there (``ModelServer.chip_inference_from_paths`` over the loader's
        QA-scanned file list, centre-cropped to ``img_size``); with
        ``tpu.fused_infer: false`` the host-preprocessed loader path."""
        server = self.start_evaluation_pipeline()
        out = out_dir or os.path.join(str(self.cfg.root_dir), "predictions")
        loader = self._infer_loader()
        if bool((self.cfg.get("tpu") or {}).get("fused_infer", True)):
            paths = [p for p, _ in loader.dataset.file_paths]
            return server.chip_inference_from_paths(
                paths, out, batch_size=int(self.cfg.train.get("batch_size", 8)))
        return server.chip_inference(iter(loader), out)

    def cleanup(self) -> None:
        """Release the server (reference :319-336 shuts Ray down), closing
        its batcher first: the batcher's thread holds the model."""
        if self.server is not None:
            self.server.close()
        self.server = None
