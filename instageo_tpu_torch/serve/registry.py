"""Model registry: a YAML catalog of deployable fine-tuned models.

Counterpart of ``instageo_tpu/serve/registry.py``, with the same schema and
surface: a ``models_registry.yaml`` (env ``MODELS_REGISTRY_PATH``) maps
model keys to metadata per size, and each model's training config is read
from ``{MODELS_PATH}/{key}/{size}/.hydra/config.yaml``. YAML is read with
the port's own reader (``configs/config.py:loads``) and ``ModelInfo`` is a
dataclass that checks its fields' types, as the JAX package's pydantic
model does.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from instageo_tpu_torch.configs.config import ConfigDict, loads

DEFAULT_REGISTRY_PATH = os.path.join(os.path.dirname(__file__), "models_registry.yaml")


def _as_int(name: str, value: Any) -> int:
    """An int field's value: an int, a whole float or an integer string (as
    pydantic's lax mode takes them)."""
    if isinstance(value, bool):
        raise ValueError(f"ModelInfo.{name}: expected an int, got {value!r}")
    if isinstance(value, int):
        return value
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, str):
        try:
            return int(value.strip())
        except ValueError:
            pass
    raise ValueError(f"ModelInfo.{name}: expected an int, got {value!r}")


@dataclass
class ModelInfo:
    """Registry/API schema (reference configs/config_dataclasses.py:11-26)."""

    name: str
    model_key: str
    description: str = ""
    data_source: str = "HLS"
    chip_size: int = 224
    num_steps: int = 1
    temporal_step: int = 30
    temporal_tolerance: int = 5
    # size name -> per-size overrides (model_name, gcs_folder, ...), as
    # stored in models_registry.yaml and read by get_model_metadata_for_size
    sizes: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    default_size: str = "base"
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if f.type == "str" and not isinstance(value, str):
                raise ValueError(f"ModelInfo.{f.name}: expected a str, got {value!r}")
            if f.type == "int":
                setattr(self, f.name, _as_int(f.name, value))
            if f.type.startswith("Dict"):
                if not isinstance(value, dict):
                    raise ValueError(f"ModelInfo.{f.name}: expected a mapping, got {value!r}")
                setattr(self, f.name, dict(value))


class ModelRegistry:
    """Reference ``ModelRegistry`` surface (model_registry.py:17-91)."""

    def __init__(self, registry_path: Optional[str] = None,
                 models_path: Optional[str] = None) -> None:
        self.registry_path = (registry_path or os.environ.get("MODELS_REGISTRY_PATH")
                              or DEFAULT_REGISTRY_PATH)
        self.models_path = models_path or os.environ.get("MODELS_PATH", "models")
        self._registry: Optional[Dict[str, Any]] = None

    def _load(self) -> Dict[str, Any]:
        if self._registry is None:
            if os.path.exists(self.registry_path):
                with open(self.registry_path) as f:
                    self._registry = loads(f.read()) or {}
            else:
                self._registry = {}
        return self._registry

    def get_available_models(self) -> List[Dict[str, Any]]:
        """All models with their metadata (reference :17-40)."""
        return [{"model_key": key, **spec}
                for key, spec in self._load().get("models", {}).items()]

    def get_model_metadata(self, model_key: str) -> Dict[str, Any]:
        models = self._load().get("models", {})
        if model_key not in models:
            raise KeyError(f"Unknown model {model_key!r}")
        return {"model_key": model_key, **models[model_key]}

    def get_model_metadata_for_size(self, model_key: str,
                                    size: Optional[str] = None) -> Dict[str, Any]:
        """Metadata with the per-size overrides applied (reference :34-60)."""
        meta = dict(self.get_model_metadata(model_key))
        sizes = meta.pop("sizes", {}) or {}
        size = size or meta.get("default_size") or (next(iter(sizes)) if sizes else None)
        if size and isinstance(sizes, dict) and size in sizes:
            meta.update(sizes[size] or {})
        meta["size"] = size
        return meta

    def get_model_config(self, model_key: str, size: str) -> ConfigDict:
        """The model's training config (reference :69-80)."""
        path = os.path.join(self.models_path, model_key, size, ".hydra", "config.yaml")
        with open(path) as f:
            return ConfigDict.wrap(loads(f.read()))

    def get_checkpoint_path(self, model_key: str, size: str) -> str:
        """The model's best-checkpoint path (reference tasks.py:605-619).

        Raises FileNotFoundError at the lookup, where the cause is clear,
        instead of handing callers a path that fails deep inside checkpoint
        loading."""
        base = os.path.join(self.models_path, model_key, size)
        for name in ("instageo_best_checkpoint", "instageo_best_checkpoint.ckpt"):
            p = os.path.join(base, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"No checkpoint for model {model_key!r} size {size!r} under {base} "
            "(expected instageo_best_checkpoint[.ckpt]; set MODELS_PATH)")
