"""Typed config dataclasses mirroring the YAML schema.

The port's copy of ``instageo_tpu/configs/config_dataclasses.py``
(reference: ``instageo/model/configs/config_dataclasses.py``): programmatic
(serving/backend) counterparts of the YAML groups, plus the
``dict_to_chip_inference_config`` assembly helper over the port's own
config files.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from instageo_tpu_torch.configs.config import ConfigDict, load_config, merge
from instageo_tpu_torch.serve.registry import ModelInfo  # noqa: F401  (re-export)


class ModelEnum(str, Enum):
    prithvi_eo_tiny = "prithvi_eo_tiny"
    prithvi_eo_v1_100 = "prithvi_eo_v1_100"
    prithvi_eo_v2_100 = "prithvi_eo_v2_100"
    prithvi_eo_v2_300 = "prithvi_eo_v2_300"
    prithvi_eo_v2_300_tl = "prithvi_eo_v2_300_tl"
    prithvi_eo_v2_600 = "prithvi_eo_v2_600"
    prithvi_eo_v2_600_tl = "prithvi_eo_v2_600_tl"


class DataSourceEnum(str, Enum):
    HLS = "HLS"
    S2 = "S2"
    S1 = "S1"


@dataclass
class DataLoaderConfig:
    bands: List[int] = field(default_factory=lambda: [1, 2, 3, 8, 11, 12])
    mean: List[float] = field(default_factory=list)
    std: List[float] = field(default_factory=list)
    img_size: int = 224
    temporal_dim: int = 1
    replace_label: Optional[List[int]] = None
    reduce_to_zero: bool = False
    no_data_value: Optional[int] = -9999
    constant_multiplier: float = 1.0
    max_pixel_value: float = 10000.0
    num_workers: int = 1


@dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    num_epochs: int = 10
    batch_size: int = 8
    class_weights: List[float] = field(default_factory=lambda: [1, 1])
    ignore_index: int = -100
    weight_decay: float = 0.01
    scheduler: bool = False
    distillation: bool = False
    teacher_ckpt_path: Optional[str] = None


@dataclass
class ModelConfig:
    model_name: str = "prithvi_eo_v1_100"
    freeze_backbone: bool = False
    load_pretrained_weights: bool = True
    num_classes: int = 2
    use_log_scale: bool = False
    plot_reg_results: bool = False
    include_ee_metric: bool = False
    weight_clip_range: Optional[List[float]] = None
    depth: int = -1
    # Explicit per-frame input channels. Normally derived from the
    # dataloader config (train/factory.py model_channels); set this when
    # the derivation is ambiguous — e.g. an in-memory (B, C, T, H, W)
    # dataset whose per-frame C happens to equal temporal_dim*len(mean).
    num_channels: Optional[int] = None


@dataclass
class TestConfig:
    img_size: int = 224
    crop_size: int = 224
    stride: int = 224
    mask_cloud: bool = False


@dataclass
class AppConfig:
    root_dir: Optional[str] = None
    train_filepath: Optional[str] = None
    valid_filepath: Optional[str] = None
    test_filepath: Optional[str] = None
    checkpoint_path: Optional[str] = None
    mode: str = "train"
    is_reg_task: bool = False
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    test: TestConfig = field(default_factory=TestConfig)


@dataclass
class ChipInferenceConfig(AppConfig):
    mode: str = "chip_inference"


def dict_to_chip_inference_config(d: Dict[str, Any]) -> ConfigDict:
    """Assemble a serving config from registry metadata + overrides.

    Reference ``dict_to_chip_inference_config``
    (configs/config_dataclasses.py:153-181): merges the provided dict over
    the default config and pins the mode.
    """
    base = load_config("config")
    cfg = merge(base, d)
    cfg["mode"] = "chip_inference"
    return cfg
