"""The port's run CLI and model factory against the JAX package's.

Chips: 8 of 6 bands at 32 px with labels, written with the port's GeoTIFF
writer; the tiny model at depth 2, float32, on the CPU (``device=cpu``).

* ``stats`` equals the JAX ``stats`` JSON within 1e-6 relative (the same
  chips in another order: another summation order);
* ``train`` runs an epoch and writes the best checkpoint, its metrics
  sidecar and the resolved config; ``resume_from`` goes on from it;
* ``eval`` on a checkpoint holding bridged JAX weights gives the JAX
  ``Trainer.run_eval_epoch`` metrics within 1e-4 (float32 logits agree
  to ~1e-5, so an argmax could flip only where the top-2 gap is smaller;
  on these inputs every metric agrees within the bound);
* ``chip_inference`` writes one int8 prediction per chip;
* ``tpu.profile`` writes a trace that holds the train epoch's spans;
* the factory loads a synthetic pretrained encoder (6 and 12 model bands,
  and a band missing from the pretrained set) and a reference ``.ckpt``
  from ``export_torch_checkpoint``; the forward then matches the JAX
  model's within the ``tests/test_torch_models.py`` bounds.
"""

import csv
import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.configs.config import load_config_from_argv as jax_load_config_from_argv
from instageo_tpu.data.dataloader import create_dataloader as jax_create_dataloader
from instageo_tpu.data.dataloader import eval_collate as jax_eval_collate
from instageo_tpu.data.dataloader import process_test as jax_process_test
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu.models.checkpoint import export_torch_checkpoint, vit_params_to_torch
from instageo_tpu.models.registry import get_arch as jax_get_arch
from instageo_tpu.parallel.mesh import make_mesh
from instageo_tpu.train import factory as jax_factory
from instageo_tpu.train import run as jax_run
from instageo_tpu.train.trainer import Trainer as JaxTrainer
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.train import factory, run
from instageo_tpu_torch.train.checkpointing import BestCheckpointer, load_checkpoint
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

STATS_RTOL = 1e-6
EVAL_ATOL = 1e-4
LOGITS_ATOL = 5e-4  # tests/test_torch_models.py


@pytest.fixture(scope="module")
def chip_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("chips")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
        sign = rng.choice([0, 1], size=(2, 2))
        lab = np.repeat(np.repeat(sign, 16, axis=0), 16, axis=1).astype(np.int16)
        lab[:2] = -1
        arr[0] = np.where(lab > 0, 8000, 1000)
        tr = Affine.from_origin(499980 + i * 960, 4100040, 30, 30)
        write_geotiff(str(root / f"t_{i}_chip.tif"), arr, transform=tr, crs=32633, nodata=0)
        write_geotiff(str(root / f"t_{i}_label.tif"), lab[None], transform=tr, crs=32633)
        rows.append({"Input": f"t_{i}_chip.tif", "Label": f"t_{i}_label.tif"})
    with open(root / "chips.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["Input", "Label"])
        writer.writeheader()
        writer.writerows(rows)
    return root


def _overrides(root, run_dir, **extra):
    out = {
        "root_dir": str(root), "train_filepath": str(root / "chips.csv"),
        "valid_filepath": str(root / "chips.csv"), "test_filepath": str(root / "chips.csv"),
        "run_dir": str(run_dir), "model.model_name": "prithvi_eo_tiny",
        "model.load_pretrained_weights": False, "model.depth": 2,
        "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
        "dataloader.no_data_value": 0, "dataloader.num_workers": 0,
        "dataloader.mean": [5000] * 6, "dataloader.std": [3000] * 6,
        "train.ignore_index": -1, "train.batch_size": 4, "train.num_epochs": 1,
        "train.learning_rate": 0.002, "test.img_size": 32, "test.crop_size": 32,
        "test.stride": 32, "tpu.precision": "f32", **extra}
    return [f"{k}={json.dumps(v) if isinstance(v, list) else v}" for k, v in out.items()]


def test_stats_matches_jax(chip_dir, tmp_path, capsys):
    ours = run.main(["mode=stats", "device=cpu"] + _overrides(chip_dir, tmp_path))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = jax_run.main(["mode=stats"] + _overrides(chip_dir, tmp_path))
    assert printed == ours
    np.testing.assert_allclose(ours["mean"], ref["mean"], rtol=STATS_RTOL)
    np.testing.assert_allclose(ours["std"], ref["std"], rtol=STATS_RTOL)
    np.testing.assert_allclose(ours["class_weights"], ref["class_weights"], rtol=STATS_RTOL)


def test_train_resume_and_chip_inference(chip_dir, tmp_path, capsys):
    run_dir = tmp_path / "run"
    hist = run.main(["mode=train", "device=cpu"] + _overrides(chip_dir, run_dir))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(hist["train_loss"]) and printed["val_IoU"] == hist["val_IoU"]
    ckpt = run_dir / "instageo_best_checkpoint"
    sidecar = json.loads((run_dir / "instageo_best_checkpoint.metrics.json").read_text())
    assert load_checkpoint(str(ckpt))["step"] == 2 and sidecar["val_IoU"] == hist["val_IoU"]
    saved = load_config("config.yaml", str(run_dir / ".hydra"))
    assert saved.train.batch_size == 4 and saved.device == "cpu"
    assert (run_dir / "metrics.jsonl").read_text().count("\n") == 2  # epoch + complexity

    resumed = run.main(["mode=train", "device=cpu", f"resume_from={ckpt}"]
                       + _overrides(chip_dir, tmp_path / "resumed"))
    assert resumed["epoch"] == 0 and np.isfinite(resumed["train_loss"])

    n = run.main(["mode=chip_inference", "device=cpu", f"checkpoint_path={ckpt}"]
                 + _overrides(chip_dir, tmp_path / "infer"))
    assert n == 8
    preds = sorted((chip_dir / "predictions").glob("t_*_prediction.tif"))
    assert len(preds) == 8
    with JaxGeoTiffReader(str(preds[0])) as r:
        assert r.dtypes[0] == "int8" and r.crs == 32633
        assert set(np.unique(r.read(1))) <= {0, 1}


def test_profile_trace_carries_the_train_spans(chip_dir, tmp_path):
    """``tpu.profile``: the run's trace holds the train epoch's spans, two
    groups of k = 4 over the 8 chips (staged and run), and the read-back."""
    run_dir = tmp_path / "run"
    run.main(["mode=train", "device=cpu", "tpu.profile=true", "tpu.steps_per_call=4"]
             + _overrides(chip_dir, run_dir, **{"train.batch_size": 1}))
    events = json.loads((run_dir / "profile" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "user_annotation" and e["name"].startswith("instageo.train.")]
    group = ["host_batch", "seeds", "stage", "replay"]
    assert names == ["instageo.train." + n for n in group + group + ["finalize"]]


def test_eval_matches_jax_run_eval_epoch(chip_dir, tmp_path):
    """The JAX weights, bridged into a checkpoint of this package, through
    ``mode=eval`` against the JAX trainer's test epoch on the same chips."""
    jax_cfg = jax_load_config_from_argv(["mode=eval"] + _overrides(chip_dir, tmp_path))
    model = jax_factory.build_model(jax_cfg)
    variables = random_seg_variables(model, 1, 32, seed=3)
    ckpt = BestCheckpointer(str(tmp_path))
    ckpt.save(variables)  # the JAX tree is the checkpoint's layout

    ours = run.main(["mode=eval", "device=cpu", f"checkpoint_path={ckpt.path}"]
                    + _overrides(chip_dir, tmp_path))
    pre = partial(jax_process_test, mean=[5000] * 6, std=[3000] * 6,
                  temporal_size=1, img_size=32, crop_size=32, stride=32)
    ds = jax_run._make_dataset(str(chip_dir / "chips.csv"), jax_cfg, pre)
    loader = jax_create_dataloader(ds, 4, collate_fn=jax_eval_collate)
    trainer = JaxTrainer(jax_cfg, model, variables, mesh=make_mesh(1))
    ref = trainer.run_eval_epoch(iter(loader), 4, "test")
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=EVAL_ATOL, err_msg=key)


def test_regression_plot_key_is_read_in_eval_only(chip_dir, tmp_path):
    """``model.plot_reg_results`` on a regression config: ``train`` and
    ``chip_inference`` run, as in the JAX CLI, which reads the key only in
    ``eval``; ``eval`` writes ``regression_test.png`` into its run
    directory (``train/plots.py``)."""
    reg = ["device=cpu", "is_reg_task=True", "model.plot_reg_results=True"]
    run_dir = tmp_path / "run"
    hist = run.main(["mode=train"] + reg + _overrides(chip_dir, run_dir))
    assert np.isfinite(hist["train_loss"]) and np.isfinite(hist["val_RMSE"])
    ckpt = run_dir / "instageo_best_checkpoint"
    assert run.main(["mode=chip_inference", f"checkpoint_path={ckpt}"] + reg
                    + _overrides(chip_dir, tmp_path / "infer")) == 8
    eval_dir = tmp_path / "eval"
    metrics = run.main(["mode=eval", f"checkpoint_path={ckpt}"] + reg
                       + _overrides(chip_dir, eval_dir))
    assert np.isfinite(metrics["test_RMSE"]) and "_preds" not in metrics
    with open(eval_dir / "regression_test.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_cli_refusals():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["mode=train", "root_dir=/r", "train_filepath=a", "valid_filepath=b"])
    with pytest.raises(ValueError, match="root_dir"):
        run.main(["mode=replica", "device=cpu"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        run.main(["mode=sliding_inference", "device=cpu", "root_dir=/r", "test_filepath=a"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        run.main(["mode=export", "device=cpu", "root_dir=/r"])
    with pytest.raises(ValueError, match="Unknown mode"):
        run.main(["mode=serve", "device=cpu"])


# ---------------------------------------------------------------------------
# The factory's weight loading
# ---------------------------------------------------------------------------


def _factory_cfg(n_bands, **extra):
    over = {"model.model_name": "prithvi_eo_tiny", "model.depth": 2, "model.num_classes": 3,
            "dataloader.img_size": 32, "dataloader.bands": list(range(n_bands)),
            "dataloader.mean": [0.0] * n_bands, "dataloader.std": [1.0] * n_bands,
            "tpu.precision": "f32", **extra}
    return load_config("config", overrides=over), jax_load_config("config", overrides=over)


def _forwards_agree(port_model, jax_model, variables, n_bands):
    x = np.random.default_rng(9).standard_normal((2, n_bands, 1, 32, 32)).astype(np.float32)
    ref = jax_model.apply(variables, x)
    with torch.no_grad():
        ours = port_model(torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=LOGITS_ATOL)


@pytest.mark.parametrize("model_bands", [6, 12, "missing"])
def test_pretrained_encoder_loads_as_jax(model_bands, tmp_path):
    """A synthetic Prithvi-MAE checkpoint (depth 4, an ``encoder.`` prefix,
    a decoder, a mask token and a fixed position embedding) through
    ``create_model`` on both sides."""
    enc_model = jax_factory.build_model(jax_load_config("config", overrides={
        "model.model_name": "prithvi_eo_tiny", "dataloader.img_size": 32,
        "dataloader.bands": list(range(6))}))
    arch4 = jax_get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32)
    enc = random_seg_variables(enc_model, 1, 32, seed=4)["params"]["prithvi_encoder"]
    sd = {f"encoder.{k}": torch.from_numpy(np.ascontiguousarray(v))
          for k, v in vit_params_to_torch(enc, arch4).items()}
    sd.update({"encoder.pos_embed": torch.zeros(1, 5, 256), "mask_token": torch.zeros(1, 1, 256),
               "decoder_embed.weight": torch.zeros(8, 256)})
    path = str(tmp_path / "prithvi.pt")
    torch.save({"model_state_dict": sd}, path)

    n_bands = 6 if model_bands == "missing" else model_bands
    extra = {"model.load_pretrained_weights": True, "model.pretrained_path": path}
    cfg, jcfg = _factory_cfg(n_bands, **extra)
    if model_bands == "missing":
        # A model band the checkpoint lacks: its embedding is the seeded draw.
        bands = ["BLUE", "GREEN", "RED", "NIR_NARROW", "SWIR_1", "CIRRUS"]
        import instageo_tpu.models.checkpoint as jck
        import instageo_tpu_torch.models.checkpoint as pck

        arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
        ours = pck.load_pretrained_encoder(path, arch, model_bands=bands)
        ref = jck.load_pretrained_encoder(path, jax_get_arch(
            "prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2),
            model_bands=bands)
        d = ref["patch_embed"]["proj"]["kernel"].shape[1]
        np.testing.assert_array_equal(
            ours["patch_embed.proj.weight"].numpy(),
            ref["patch_embed"]["proj"]["kernel"].T.reshape(d, 6, 1, 16, 16))
        return
    jax_model, variables = jax_factory.create_model(jcfg, seed=0)
    port = factory.create_model(cfg, device="cpu")
    arch = get_arch("prithvi_eo_tiny", in_chans=n_bands, num_frames=1, img_size=32, depth=2)
    bridged = seg_state_dict_from_jax(jax.tree.map(np.asarray, variables), arch)
    enc_sd = {f"prithvi_encoder.{k}": v for k, v in port.prithvi_encoder.state_dict().items()}
    port.load_state_dict({**bridged, **enc_sd}, strict=True)
    _forwards_agree(port, jax_model, variables, n_bands)


def test_reference_ckpt_loads_as_jax(tmp_path):
    """A Lightning-style ``.ckpt`` (``state_dict``, ``net.`` prefix) written
    by the JAX package's exporter, through the port's ``load_finetuned``."""
    cfg, jcfg = _factory_cfg(6)
    jax_model = jax_factory.build_model(jcfg)
    variables = random_seg_variables(jax_model, 1, 32, seed=6)
    path = str(tmp_path / "model.ckpt")
    export_torch_checkpoint(variables, jax_get_arch(
        "prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2), path)
    cfg.checkpoint_path = path
    port = factory.create_model(cfg, device="cpu")
    _forwards_agree(port, jax_model, variables, 6)
