"""The port's serving layer against the JAX package's
(``tests/serve_tests/test_serving.py``, ``tests/model_tests/test_config_dataclasses.py``).

World: 4 chips of 6 bands at 32 px with labels, and a reference ``.ckpt``
of the tiny model (depth 2, 2 classes) holding seeded random weights, which
both packages read. Both run float32 on one device (the JAX server on a
one-device mesh, as the port's one card).

* ``EvaluationPipeline``: the required keys and the missing checkpoint
  raise; ``evaluate`` equals the JAX pipeline's metrics within 1e-4 (the
  ``tests/test_torch_run.py`` eval bound); ``chip_inference`` on the fused
  path and on the loader path (``tpu.fused_infer: false``) writes one int8
  prediction per chip, equal to the JAX pipeline's wherever the top-2 logit
  gap is at least 2e-3 (four times the 5e-4 logit bound); health and device
  info; ``cleanup``;
* ``ModelServer(cfg)``: the online batcher's reconfigure-and-close rule;
  ``evaluate`` equals ``Trainer.test`` on the same loader;
* ``ModelRegistry`` and the shipped registry file (parsed by the port's
  reader, cross-checked with PyYAML here only);
* ``config_dataclasses``;
* ``mode=export`` through ``run.main``: the artifact's class ids equal the
  server's.
"""

import csv
import os

import numpy as np
import pytest
import torch
import yaml

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu.models.checkpoint import export_torch_checkpoint
from instageo_tpu.models.registry import get_arch as jax_get_arch
from instageo_tpu.serve.pipeline import EvaluationPipeline as JaxEvaluationPipeline
from instageo_tpu.serve.registry import ModelRegistry as JaxModelRegistry
from instageo_tpu.train import factory as jax_factory
from instageo_tpu_torch.configs import config_dataclasses as cd
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.data.dataloader import create_dataloader
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.models.registry import PRITHVI_ARCHS
from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device
from instageo_tpu_torch.serve import registry as port_registry
from instageo_tpu_torch.serve.export import load_predict
from instageo_tpu_torch.serve.pipeline import EvaluationPipeline
from instageo_tpu_torch.serve.registry import ModelInfo, ModelRegistry
from instageo_tpu_torch.serve.server import ModelServer
from instageo_tpu_torch.train import run
from instageo_tpu_torch.train.trainer import Trainer
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

EVAL_ATOL = 1e-4
DECIDED_GAP = 2e-3
MEAN, STD = [5000.0] * 6, [3000.0] * 6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(root, reference .ckpt path)."""
    root = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
        lab = rng.integers(0, 2, size=(32, 32)).astype(np.int16)
        tr = Affine.from_origin(499980 + i * 960, 4100040, 30, 30)
        write_geotiff(str(root / f"chip_{i}.tif"), arr, transform=tr, crs=32633, nodata=0)
        write_geotiff(str(root / f"seg_map_{i}.tif"), lab[None], transform=tr, crs=32633,
                      nodata=-1)
        rows.append({"Input": f"chip_{i}.tif", "Label": f"seg_map_{i}.tif"})
    with open(root / "data.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["Input", "Label"])
        writer.writeheader()
        writer.writerows(rows)
    jcfg = jax_load_config("config", overrides=_overrides(root, None))
    variables = random_seg_variables(jax_factory.build_model(jcfg), 1, 32, seed=21)
    ckpt = str(root / "model.ckpt")
    export_torch_checkpoint(variables, jax_get_arch(
        "prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2), ckpt)
    return root, ckpt


def _overrides(root, ckpt, **extra):
    return {
        "root_dir": str(root), "test_filepath": str(root / "data.csv"),
        "checkpoint_path": ckpt, "model.model_name": "prithvi_eo_tiny", "model.depth": 2,
        "model.load_pretrained_weights": False, "dataloader.img_size": 32,
        "dataloader.bands": [0, 1, 2, 3, 4, 5], "dataloader.mean": MEAN,
        "dataloader.std": STD, "dataloader.no_data_value": 0,
        "dataloader.num_workers": 0, "train.ignore_index": -1, "train.batch_size": 4,
        "test.img_size": 32, "test.crop_size": 32, "test.stride": 32,
        "tpu.precision": "f32", "tpu.mesh": 1, **extra}


def _cfg(root, ckpt, **extra):
    return load_config("config", overrides={"device": "cpu", **_overrides(root, ckpt, **extra)})


def _jax_cfg(root, ckpt, **extra):
    return jax_load_config("config", overrides=_overrides(root, ckpt, **extra))


def test_pipeline_validation_errors(world):
    root, ckpt = world
    cfg = _cfg(root, ckpt)
    cfg["checkpoint_path"] = None
    with pytest.raises(ValueError, match="Missing required"):
        EvaluationPipeline(cfg)
    cfg["checkpoint_path"] = "/nonexistent"
    with pytest.raises(FileNotFoundError):
        EvaluationPipeline(cfg)


def _predictions(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with JaxGeoTiffReader(os.path.join(out_dir, name)) as r:
            assert r.count == 1 and r.dtypes[0] == "int8"
            out[name] = r.read(1)
    return out


def _decided(model, root):
    """Per chip name, the pixels whose port logits' top-2 gap is at least
    ``DECIDED_GAP``."""
    out = {}
    for i in range(4):
        with JaxGeoTiffReader(str(root / f"chip_{i}.tif")) as r:
            raw = r.read()[None]
        x = preprocess_chips(raw_to_device(raw, torch.device("cpu")), torch.tensor(MEAN),
                             torch.tensor(STD), 1, torch.arange(6), 1.0, img_size=32)
        with torch.no_grad():
            top2 = model(x, channels_last=True).topk(2, dim=-1).values[0]
        out[f"prediction_{i}.tif"] = ((top2[..., 0] - top2[..., 1]) >= DECIDED_GAP).numpy()
    return out


def test_pipeline_evaluate_and_chip_inference_match_jax(world, tmp_path):
    root, ckpt = world
    ref_pipe = JaxEvaluationPipeline(_jax_cfg(root, ckpt))
    ref = ref_pipe.evaluate()
    ref_pipe.chip_inference(str(tmp_path / "jax"))
    ref_pipe.cleanup()

    pipe = EvaluationPipeline(_cfg(root, ckpt))
    metrics = pipe.evaluate()
    assert "test_IoU" in metrics and "inference_time" in metrics
    assert set(metrics) == set(ref)
    for key, value in ref.items():
        if key != "inference_time":
            np.testing.assert_allclose(metrics[key], value, rtol=0, atol=EVAL_ATOL, err_msg=key)

    out = pipe.chip_inference(str(tmp_path / "preds"))
    assert out["num_chips"] == 4
    ours, theirs = _predictions(tmp_path / "preds"), _predictions(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) == [f"prediction_{i}.tif" for i in range(4)]
    decided = _decided(pipe.server.model, root)
    for name, pred in ours.items():
        assert decided[name].mean() > 0.9
        np.testing.assert_array_equal(pred[decided[name]], theirs[name][decided[name]])

    health = pipe.server.health_check()
    assert health["status"] == "healthy" and health["requests_served"] == 2
    info = pipe.server.get_device_info()
    assert info["num_devices"] == 1 and info["platform"] == "cpu"
    batcher = pipe.server.online_batcher(max_batch=2)
    pipe.cleanup()
    assert pipe.server is None and batcher._closed.is_set()

    # The loader path gives the fused path's predictions.
    loader_pipe = EvaluationPipeline(_cfg(root, ckpt, **{"tpu.fused_infer": False}))
    assert loader_pipe.chip_inference(str(tmp_path / "loader"))["num_chips"] == 4
    loader_pipe.cleanup()
    for name, pred in _predictions(tmp_path / "loader").items():
        np.testing.assert_array_equal(pred, ours[name], err_msg=name)


def test_server_evaluate_is_trainer_test(world):
    root, ckpt = world
    cfg = _cfg(root, ckpt)
    server = ModelServer(cfg)
    pre = run._train_preprocess(cfg, augment=False)
    loader = create_dataloader(run._make_dataset(str(root / "data.csv"), cfg, pre), 4,
                               num_workers=0)
    got = server.evaluate(lambda: iter(loader))
    ref = Trainer(cfg, server.model, device="cpu").test(lambda: iter(loader))
    assert got.pop("inference_time") >= 0
    assert got == ref and server.requests_served == 1


def test_online_batcher_reconfigure_and_close(world):
    """Changed knobs rebuild the batcher; close() stops its worker thread
    (a live thread holds the model)."""
    root, ckpt = world
    server = ModelServer(_cfg(root, ckpt))
    b1 = server.online_batcher(max_batch=4, max_wait_ms=1)
    assert b1.max_batch == 4
    b2 = server.online_batcher(max_batch=8, max_wait_ms=1)
    assert b2.max_batch == 8 and b2 is not b1
    assert b1._closed.is_set()
    assert server.online_batcher(max_batch=8, max_wait_ms=1) is b2
    server.close()
    assert b2._closed.is_set()


def test_server_runs_on_cuda_unless_told(world):
    root, ckpt = world
    cfg = _cfg(root, ckpt)
    del cfg["device"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelServer(cfg)
    assert ModelServer(cfg, device="cpu").device.type == "cpu"


def test_model_registry(tmp_path):
    registry_yaml = {
        "models": {
            "flood_mapping": {
                "name": "Flood Mapping",
                "description": "Sen1Floods11 fine-tune",
                "data_source": "HLS",
                "chip_size": 224,
                "num_steps": 1,
                "default_size": "base",
                "sizes": {
                    "base": {"model_name": "prithvi_eo_v1_100"},
                    "large": {"model_name": "prithvi_eo_v2_300"},
                },
            }
        }
    }
    reg_path = tmp_path / "models_registry.yaml"
    with open(reg_path, "w") as f:
        yaml.safe_dump(registry_yaml, f)
    models_path = tmp_path / "models"
    cfg_dir = models_path / "flood_mapping" / "base" / ".hydra"
    os.makedirs(cfg_dir)
    with open(cfg_dir / "config.yaml", "w") as f:
        yaml.safe_dump({"model": {"model_name": "prithvi_eo_v1_100"},
                        "train": {"batch_size": 16}}, f)

    reg = ModelRegistry(str(reg_path), str(models_path))
    ref = JaxModelRegistry(str(reg_path), str(models_path))
    models = reg.get_available_models()
    assert models == ref.get_available_models()
    assert len(models) == 1 and models[0]["model_key"] == "flood_mapping"
    meta = reg.get_model_metadata_for_size("flood_mapping")
    assert meta == ref.get_model_metadata_for_size("flood_mapping")
    assert meta["size"] == "base" and meta["model_name"] == "prithvi_eo_v1_100"
    meta_l = reg.get_model_metadata_for_size("flood_mapping", "large")
    assert meta_l["model_name"] == "prithvi_eo_v2_300"
    cfg = reg.get_model_config("flood_mapping", "base")
    assert cfg.train.batch_size == 16
    assert cfg == ref.get_model_config("flood_mapping", "base")
    with pytest.raises(KeyError):
        reg.get_model_metadata("nope")
    info = ModelInfo(model_key="flood_mapping", **{
        k: v for k, v in registry_yaml["models"]["flood_mapping"].items()})
    assert info.sizes["large"]["model_name"] == "prithvi_eo_v2_300"


def test_shipped_registry_parses_as_the_jax_one(monkeypatch):
    path = port_registry.DEFAULT_REGISTRY_PATH
    with open(path) as f:
        assert yaml.safe_load(f) == ModelRegistry(path)._load()
    monkeypatch.delenv("MODELS_REGISTRY_PATH", raising=False)
    assert ModelRegistry().get_available_models() == JaxModelRegistry().get_available_models()


def test_missing_checkpoint_raises_at_lookup(tmp_path, monkeypatch):
    monkeypatch.setenv("MODELS_PATH", str(tmp_path))
    reg = ModelRegistry(models_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="flood_mapping"):
        reg.get_checkpoint_path("flood_mapping", "base")
    target = tmp_path / "flood_mapping" / "base" / "instageo_best_checkpoint"
    os.makedirs(target)
    assert reg.get_checkpoint_path("flood_mapping", "base") == str(target)


def test_model_info_checks_types():
    info = ModelInfo(name="Flood", model_key="flood", chip_size="256", num_steps=2.0)
    assert info.chip_size == 256 and info.num_steps == 2
    assert info.sizes == {} and info.default_size == "base" and info.data_source == "HLS"
    for bad in (dict(chip_size="big"), dict(num_steps=True), dict(name=3),
                dict(sizes=["base"]), dict(temporal_step=1.5)):
        with pytest.raises(ValueError):
            ModelInfo(**{"name": "Flood", "model_key": "flood", **bad})


# ---------------------------------------------------------------------------
# config_dataclasses (tests/model_tests/test_config_dataclasses.py)
# ---------------------------------------------------------------------------


def test_model_enum_covers_registry_variants():
    assert {m.value for m in cd.ModelEnum} == set(PRITHVI_ARCHS)


def test_data_source_enum():
    assert {d.value for d in cd.DataSourceEnum} == {"HLS", "S2", "S1"}
    assert cd.ModelInfo is ModelInfo


def test_app_config_defaults_match_yaml():
    cfg = load_config("config")
    app = cd.AppConfig()
    assert app.mode == cfg["mode"] == "train"
    assert app.train.ignore_index == cfg["train"]["ignore_index"]
    assert app.dataloader.img_size == cfg["dataloader"]["img_size"]
    assert app.test.crop_size == cfg["test"]["crop_size"]
    assert cd.ChipInferenceConfig().mode == "chip_inference"


def test_dict_to_chip_inference_config():
    from instageo_tpu.configs.config_dataclasses import (
        dict_to_chip_inference_config as jax_dict_to_chip_inference_config,
    )
    from instageo_tpu_torch.serve import pipeline

    d = {"test_filepath": "/data/chips.csv", "checkpoint_path": "/models/best",
         "train": {"batch_size": 4}, "dataloader": {"img_size": 96}}
    cfg = cd.dict_to_chip_inference_config(d)
    assert cfg["mode"] == "chip_inference"  # pinned even if omitted
    assert cfg["test_filepath"] == "/data/chips.csv"
    assert cfg["checkpoint_path"] == "/models/best"
    assert cfg["train"]["batch_size"] == 4
    assert cfg["dataloader"]["img_size"] == 96
    assert cfg["model"]["model_name"]
    assert cfg["train"]["ignore_index"] is not None
    assert cfg == jax_dict_to_chip_inference_config(d)
    assert pipeline.dict_to_chip_inference_config(d)["mode"] == "train"  # not pinned there


# ---------------------------------------------------------------------------
# mode=export through the run CLI
# ---------------------------------------------------------------------------


def test_run_cli_export_mode(world, tmp_path, capsys):
    root, ckpt = world
    out = tmp_path / "flood.pt2"
    path = run.main(["mode=export", "device=cpu", f"root_dir={root}",
                     f"checkpoint_path={ckpt}", f"export.path={out}",
                     "model.model_name=prithvi_eo_tiny", "model.depth=2",
                     "model.load_pretrained_weights=False", "dataloader.img_size=32",
                     "dataloader.bands=[0,1,2,3,4,5]", "tpu.precision=f32"])
    assert path == str(out) and out.exists()
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert f'"artifact": "{out}"' in printed

    predict, meta = load_predict(path)
    assert meta["input_shape"] == [None, 6, 1, 32, 32] and meta["output"] == "class_ids"
    server = ModelServer(_cfg(root, ckpt))
    x = np.random.default_rng(0).normal(size=(2, 6, 1, 32, 32)).astype(np.float32)
    preds = predict(server.model.state_dict(), x)
    assert preds.shape == (2, 32, 32) and preds.dtype == torch.int8
    batcher = server.online_batcher(max_batch=2)
    live = np.stack([batcher.submit(c).result(timeout=60) for c in x])
    server.close()
    np.testing.assert_array_equal(preds.numpy(), live)
