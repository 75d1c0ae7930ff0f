"""``mode=replica`` of the port's run CLI, as ``tests/model_tests/test_replica_mode.py``
drives the JAX one: stats → train → val/test eval → report on synthetic
chips from a fresh init (``replica.require_pretrained=False``), the
pretrained gate, the missing test split, and ``_write_report``'s text
against the JAX package's on one fixed report (equal byte for byte).
"""

import copy
import json
import os

import numpy as np
import pytest

from instageo_tpu.train import replica as jax_replica
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.train import replica
from instageo_tpu_torch.train.run import main as run_main


@pytest.fixture(scope="module")
def chip_dir(tmp_path_factory):
    """8 separable chips (6 bands, 32 px) and labels, as the JAX test's."""
    root = tmp_path_factory.mktemp("replica_chips")
    rng = np.random.default_rng(3)
    lines = ["Input,Label"]
    for i in range(8):
        arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
        sign = rng.choice([0, 1], size=(2, 2))
        lab = np.repeat(np.repeat(sign, 16, axis=0), 16, axis=1).astype(np.int16)
        arr[0] = np.where(lab > 0, 8000, 1000)
        tr = Affine.from_origin(499980 + i * 960, 4100040, 30, 30)
        write_geotiff(str(root / f"chip_{i}.tif"), arr, transform=tr, crs=32633, nodata=0)
        write_geotiff(str(root / f"seg_map_{i}.tif"), lab[None], transform=tr, crs=32633,
                      nodata=-1)
        lines.append(f"chip_{i}.tif,seg_map_{i}.tif")
    (root / "train.csv").write_text("\n".join(lines) + "\n")
    return root


def _overrides(root, run_dir):
    return [
        "device=cpu",
        f"root_dir={root}",
        f"train_filepath={root / 'train.csv'}",
        f"valid_filepath={root / 'train.csv'}",
        f"test_filepath={root / 'train.csv'}",
        f"run_dir={run_dir}",
        "model.model_name=prithvi_eo_tiny",
        "model.depth=2",
        "model.load_pretrained_weights=False",
        "dataloader.img_size=32",
        "dataloader.bands=[0,1,2,3,4,5]",
        "dataloader.no_data_value=0",
        "dataloader.num_workers=0",
        "dataloader.mean=[5000,5000,5000,5000,5000,5000]",
        "dataloader.std=[3000,3000,3000,3000,3000,3000]",
        "train.ignore_index=-1",
        "train.batch_size=8",
        "train.num_epochs=2",
        "train.learning_rate=0.002",
        "test.img_size=32", "test.crop_size=32", "test.stride=32",
        "tpu.precision=f32",
        "replica.task=sen1floods11",
        "replica.require_pretrained=False",
    ]


def test_replica_end_to_end(chip_dir, tmp_path):
    run_dir = tmp_path / "replica"
    report = run_main(["mode=replica", "replica.apply_stats=True"]
                      + _overrides(chip_dir, run_dir))

    assert report["task"] == "sen1floods11"
    assert report["hardware"] == "cpu:cpu x1"
    stats = report["dataset_stats"]
    assert len(stats["mean"]) == 6 and len(stats["class_weights"]) == 2
    assert os.path.exists(report["checkpoint"])
    assert set(report["stages"]) == {"stats_s", "train_s", "eval_val_s", "eval_test_s"}
    for split in ("val", "test"):
        m = report["metrics"][split]
        assert set(m) == {"mIoU", "Acc", "mF1", "ROC-AUC"}
        assert 0.0 <= m["Acc"] <= 100.0
        assert (run_dir / f"eval_{split}.json").exists()
    assert report["reference"]["source"] == "reference README.md:31"
    assert report["deltas"]["mIoU"] == pytest.approx(report["metrics"]["test"]["mIoU"] - 88.53)
    # One decoded-chip cache served the stages.
    assert os.listdir(run_dir / "chip_cache")

    # apply_stats fed the computed stats into the trained config.
    trained = (run_dir / ".hydra" / "config.yaml").read_text()
    assert f"{stats['mean'][0]:.6f}"[:8] in trained or str(stats["mean"][0])[:8] in trained

    with open(run_dir / "report.json") as f:
        assert json.load(f)["metrics"]["test"]["Acc"] == pytest.approx(
            report["metrics"]["test"]["Acc"])
    md = (run_dir / "REPORT.md").read_text()
    assert "| Flood mapping (Sen1Floods11) |" in md
    assert "InstaGeo-Baseline" in md and "88.53" in md
    assert "delta (test − reference)" in md

    # The test split's metrics are a direct mode=eval of the best checkpoint.
    direct = run_main(["--config-path", str(run_dir / ".hydra"), "--config-name", "config",
                       "mode=eval", f"checkpoint_path={report['checkpoint']}",
                       f"run_dir={tmp_path / 'direct'}"])
    for col, key in replica._EVAL_KEYS.items():
        assert report["metrics"]["test"][col] == pytest.approx(100.0 * direct[key], abs=1e-9)


def test_replica_pretrained_gate(chip_dir, tmp_path, monkeypatch):
    monkeypatch.delenv("PRITHVI_PRETRAINED_PATH", raising=False)
    gated = [o for o in _overrides(chip_dir, tmp_path / "gated")
             if not o.startswith("replica.require_pretrained")]
    with pytest.raises(RuntimeError, match="PRITHVI_PRETRAINED_PATH"):
        run_main(["mode=replica"] + gated + ["model.load_pretrained_weights=True"])
    with pytest.raises(RuntimeError, match="require_pretrained"):
        run_main(["mode=replica"] + gated + ["model.load_pretrained_weights=False"])
    assert not (tmp_path / "gated" / "REPORT.md").exists()


def test_replica_requires_test_split(chip_dir, tmp_path):
    with pytest.raises(ValueError, match="test_filepath"):
        run_main(["mode=replica"] + _overrides(chip_dir, tmp_path / "nosplit")
                 + ["test_filepath=null"])


REPORT = {
    "task": "multitemporal_crop_classification", "model": "prithvi_eo_v1_100",
    "pretrained": None, "epochs": 1, "hardware": "gpu:NVIDIA H100 80GB HBM3 x1",
    "stages": {"stats_s": 3.25, "train_s": 41.5, "eval_val_s": 2.0, "eval_test_s": 2.5},
    "metrics": {"val": {"mIoU": 12.345, "Acc": 55.5, "mF1": 20.0, "ROC-AUC": 60.125},
                "test": {"mIoU": 11.0, "Acc": 54.0, "mF1": 19.5}},
    "reference": jax_replica.REFERENCE_TARGETS["multitemporal_crop_classification"],
    "deltas": {"mIoU": -36.87, "Acc": -12.1, "mF1": -44.69},
    "duration_s": 49.75,
}


@pytest.mark.parametrize("case", ["with_reference", "no_reference"])
def test_write_report_equals_jax(tmp_path, case):
    assert replica.REFERENCE_TARGETS == jax_replica.REFERENCE_TARGETS
    report = copy.deepcopy(REPORT)
    if case == "no_reference":
        report.update(task="custom", reference=None)
        del report["deltas"]
    for side, write in (("jax", jax_replica._write_report), ("port", replica._write_report)):
        (tmp_path / side).mkdir()
        write(str(tmp_path / side), copy.deepcopy(report))
    for name in ("REPORT.md", "report.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
