"""Experiment logging: local JSONL tracker with optional Neptune backend.

The port's copy of ``instageo_tpu/utils/experiment_logger.py``: metrics
stream to ``<run_dir>/metrics.jsonl`` (always) and to Neptune when a
``neptune.project`` is configured, an API token is set and the ``neptune``
package is importable. Git metadata from the ``VCS_*`` environment
variables is attached to the run.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

log = logging.getLogger(__name__)

VCS_ENV_KEYS = ("VCS_REPOSITORY", "VCS_BRANCH", "VCS_COMMIT_SHA", "VCS_COMMIT_MSG")


def set_neptune_api_token() -> Optional[str]:
    """Per-user token resolution: NEPTUNE_API_TOKEN_<USER>, else NEPTUNE_API_TOKEN."""
    user = os.environ.get("USER", "").upper().replace("-", "_")
    for key in (f"NEPTUNE_API_TOKEN_{user}", "NEPTUNE_API_TOKEN"):
        token = os.environ.get(key)
        if token:
            os.environ["NEPTUNE_API_TOKEN"] = token
            return token
    return None


class ExperimentLogger:
    """Local-first experiment tracker."""

    def __init__(self, run_dir: str, project: Optional[str] = None,
                 name: str = "instageo-run") -> None:
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self.meta = {
            "name": name,
            "project": project,
            "started": time.time(),
            **{k.lower(): v for k, v in os.environ.items() if k in VCS_ENV_KEYS},
        }
        with open(os.path.join(run_dir, "run_meta.json"), "w") as f:
            json.dump(self.meta, f, indent=2)
        self._neptune = self._maybe_neptune(project, name)

    def _maybe_neptune(self, project, name):
        if not project or not set_neptune_api_token():
            return None
        try:
            import neptune  # type: ignore

            run = neptune.init_run(project=project, name=name)
            for k, v in self.meta.items():
                run[f"meta/{k}"] = str(v)
            return run
        except Exception as e:  # pragma: no cover - optional dependency
            log.warning("Neptune unavailable: %s", e)
            return None

    def log_metrics(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        record = {"_ts": time.time(), "_step": step,
                  **{k: v for k, v in metrics.items()
                     if isinstance(v, (int, float, str, list, dict))}}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._neptune is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._neptune[f"metrics/{k}"].append(v, step=step)

    def log_config(self, cfg: Any) -> None:
        text = cfg.to_yaml() if hasattr(cfg, "to_yaml") else json.dumps(cfg)
        with open(os.path.join(self.run_dir, "logged_config.yaml"), "w") as f:
            f.write(text)
        if self._neptune is not None:
            self._neptune["config"] = text

    def stop(self) -> None:
        if self._neptune is not None:
            self._neptune.stop()


def init_experiment_logger(cfg: Any, run_dir: str) -> ExperimentLogger:
    """The run's logger, with Neptune when ``cfg.neptune.project`` is set."""
    project = None
    neptune_cfg = cfg.get("neptune") if hasattr(cfg, "get") else None
    if neptune_cfg:
        project = neptune_cfg.get("project")
    return ExperimentLogger(run_dir, project=project)
