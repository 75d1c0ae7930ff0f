"""Task orchestration: the 3-stage state machine + stage worker functions.

The port's own copy of ``instageo_tpu/webapp/tasks.py`` (reference
``instageo/new_apps/backend/app/tasks.py``): a task moves through
``data_processing → model_prediction → visualization_preparation →
completed`` (or ``failed``), each stage running as a queued job on its own
queue, with its state in sqlite. The stages run on ``settings.DEVICE``
(``INSTAGEO_DEVICE``, ``cuda`` by default): the raster chip creator's
``--device`` in stage 1, the model's device in stage 2. Without a card and
with ``cuda`` asked for, a stage fails its task; it never runs on the CPU.
"""

from __future__ import annotations

import logging
import os
import sys
import time
import uuid
from typing import Any, Dict, List, Optional

from instageo_tpu_torch.webapp import db, queue
from instageo_tpu_torch.webapp.settings import settings

log = logging.getLogger(__name__)


class TaskStatus:
    """Reference TaskStatus (tasks.py:31-39)."""

    PENDING = "pending"
    DATA_PROCESSING = "data_processing"
    MODEL_PREDICTION = "model_prediction"
    VISUALIZATION_PREPARATION = "visualization_preparation"
    COMPLETED = "completed"
    FAILED = "failed"


STAGES = ("data_processing", "model_prediction", "visualization_preparation")


class Task:
    """Task record + stage transitions (reference Task, tasks.py:100-404)."""

    def __init__(self, task_id: Optional[str] = None,
                 bboxes: Optional[List] = None,
                 parameters: Optional[Dict] = None,
                 user_sub: str = "", model_key: str = "",
                 model_size: str = "", db_path: Optional[str] = None) -> None:
        self.task_id = task_id or uuid.uuid4().hex
        self.bboxes = bboxes or []
        self.parameters = parameters or {}
        self.user_sub = user_sub
        self.model_key = model_key
        self.model_size = model_size
        self.status = TaskStatus.PENDING
        self.stages: Dict[str, Dict] = {
            s: {"status": "pending", "started_at": None, "finished_at": None,
                "error": None} for s in STAGES}
        self.error: Optional[str] = None
        self.created_at = time.time()
        self.db_path = db_path

    # -- persistence -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id,
            "user_sub": self.user_sub,
            "status": self.status,
            "bboxes": self.bboxes,
            "parameters": self.parameters,
            "stages": self.stages,
            "model_key": self.model_key,
            "model_size": self.model_size,
            "error": self.error,
            "created_at": self.created_at,
        }

    def save(self) -> None:
        try:
            db.save_task(self.to_dict(), self.db_path)
        except Exception as e:  # dead-letter store (reference redis_client)
            db.dead_letter(self.to_dict(), str(e), self.db_path)

    @classmethod
    def load(cls, task_id: str, db_path: Optional[str] = None) -> Optional["Task"]:
        rec = db.load_task(task_id, db_path)
        if rec is None:
            return None
        t = cls(task_id=rec["task_id"], bboxes=rec.get("bboxes"),
                parameters=rec.get("parameters"),
                user_sub=rec.get("user_sub") or "",
                model_key=rec.get("model_key") or "",
                model_size=rec.get("model_size") or "", db_path=db_path)
        t.status = rec["status"]
        t.stages = rec.get("stages") or t.stages
        t.error = rec.get("error")
        t.created_at = rec.get("created_at", t.created_at)
        return t

    # -- directories ---------------------------------------------------------

    @property
    def data_dir(self) -> str:
        return os.path.join(settings.TASKS_DATA_DIR, self.task_id)

    # -- stage transitions ----------------------------------------------------

    def _start_stage(self, stage: str, status: str) -> None:
        self.status = status
        self.stages[stage]["status"] = "running"
        self.stages[stage]["started_at"] = time.time()
        self.save()

    def complete_stage(self, stage: str, result: Optional[Dict] = None) -> None:
        self.stages[stage]["status"] = "completed"
        self.stages[stage]["finished_at"] = time.time()
        if result is not None:
            # Persist the stage result on the task (the reference stores
            # stage results in the task hash; the frontend reads e.g.
            # stages.visualization_preparation.result.segmentation_stats).
            self.stages[stage]["result"] = result
        self.save()

    def fail(self, stage: str, error: str) -> None:
        """Per-stage failed-state propagation (reference tasks.py:313-361)."""
        self.status = TaskStatus.FAILED
        self.stages[stage]["status"] = "failed"
        self.stages[stage]["error"] = error
        self.stages[stage]["finished_at"] = time.time()
        self.error = error
        self.save()

    def complete(self) -> None:
        self.status = TaskStatus.COMPLETED
        self.save()

    # -- queue wiring ---------------------------------------------------------

    def start_data_processing(self) -> str:
        self._start_stage("data_processing", TaskStatus.DATA_PROCESSING)
        return queue.enqueue(
            queue.QUEUE_DATA_PROCESSING,
            "instageo_tpu_torch.webapp.tasks:process_data_extraction_with_task",
            {"task_id": self.task_id, "db_path": self.db_path},
            task_id=self.task_id, db_path=self.db_path)

    def start_model_prediction(self) -> str:
        self._start_stage("model_prediction", TaskStatus.MODEL_PREDICTION)
        return queue.enqueue(
            queue.QUEUE_MODEL_PREDICTION,
            "instageo_tpu_torch.webapp.tasks:process_model_prediction_with_task",
            {"task_id": self.task_id, "db_path": self.db_path},
            task_id=self.task_id, db_path=self.db_path)

    def start_visualization_preparation(self) -> str:
        self._start_stage("visualization_preparation",
                          TaskStatus.VISUALIZATION_PREPARATION)
        return queue.enqueue(
            queue.QUEUE_VISUALIZATION,
            "instageo_tpu_torch.webapp.tasks:process_visualization_preparation_with_task",
            {"task_id": self.task_id, "db_path": self.db_path},
            task_id=self.task_id, db_path=self.db_path)


# ---------------------------------------------------------------------------
# Stage worker functions (run on queue workers)
# ---------------------------------------------------------------------------


def _peak_device_bytes() -> Optional[int]:
    """The most device memory this process has held, where it used the card
    (each stage job runs in a process of its own); ``None`` otherwise."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.max_memory_allocated())


def process_data_extraction_with_task(task_id: str,
                                      db_path: Optional[str] = None) -> Dict:
    """Stage 1: bboxes -> chips (reference tasks.py:482-570)."""
    task = Task.load(task_id, db_path)
    if task is None:
        raise ValueError(f"Unknown task {task_id}")
    try:
        from instageo_tpu_torch.webapp.data_processor import DataProcessor

        processor = DataProcessor(task.data_dir, task.parameters)
        result = processor.extract_data_from_bboxes(task.bboxes)
        if result.get("chip_count", 0) == 0:
            raise RuntimeError("No chips were produced for the given bboxes")
        task.complete_stage("data_processing")
        task.start_model_prediction()
        return {**result, "peak_device_bytes": _peak_device_bytes()}
    except Exception as e:
        task.fail("data_processing", str(e))
        raise


def process_model_prediction_with_task(task_id: str,
                                       db_path: Optional[str] = None) -> Dict:
    """Stage 2: chips -> predictions (reference tasks.py:573-673)."""
    task = Task.load(task_id, db_path)
    if task is None:
        raise ValueError(f"Unknown task {task_id}")
    try:
        from instageo_tpu_torch.configs.config import merge
        from instageo_tpu_torch.serve.pipeline import EvaluationPipeline
        from instageo_tpu_torch.serve.registry import ModelRegistry
        from instageo_tpu_torch.webapp.data_processor import DataProcessor

        registry = ModelRegistry()
        cfg = registry.get_model_config(task.model_key, task.model_size)
        ckpt = registry.get_checkpoint_path(task.model_key, task.model_size)
        processor = DataProcessor(task.data_dir, task.parameters)
        cfg = merge(cfg, {
            "root_dir": processor.data_path,
            "test_filepath": processor.dataset_csv,
            "checkpoint_path": ckpt,
            "device": settings.DEVICE,
        })
        pipeline = EvaluationPipeline(cfg)
        result = pipeline.chip_inference(
            os.path.join(processor.data_path, "predictions"))
        pipeline.cleanup()
        task.complete_stage("model_prediction")
        task.start_visualization_preparation()
        return {**result, "peak_device_bytes": _peak_device_bytes()}
    except Exception as e:
        task.fail("model_prediction", str(e))
        raise


def process_visualization_preparation_with_task(
        task_id: str, db_path: Optional[str] = None) -> Dict:
    """Stage 3: COG merge + seg stats (reference tasks.py:676-733)."""
    task = Task.load(task_id, db_path)
    if task is None:
        raise ValueError(f"Unknown task {task_id}")
    try:
        from instageo_tpu_torch.webapp.cog import COGConverter

        converter = COGConverter(task.data_dir)
        result = converter.merge_task_files_to_cog(task_id)
        stats = converter.compute_seg_stats(result.get("predictions_cog"))
        task.complete_stage("visualization_preparation",
                            result={"segmentation_stats": stats})
        task.complete()
        return {**result, "seg_stats": stats}
    except Exception as e:
        task.fail("visualization_preparation", str(e))
        raise
