"""Checkpoints across the two packages: each loads, serves, distils from and
resumes a directory the other's ``BestCheckpointer`` wrote.

The tiny model (``prithvi_eo_tiny``, depth 2, 32 px, float32, the CPU);
logits within the JAX-vs-port model parity bounds (5e-4 absolute,
``tests/test_torch_models.py``; 1e-4 for the fast head,
``tests/test_torch_models_variants.py``); metrics within 1e-4 and class ids
equal wherever the top-2 logit gap is at least 2e-3
(``tests/test_torch_serving.py``). Weights, statistics and AdamW moments
that cross the bridge are equal bit for bit.

* a JAX directory -> the port's ``create_model``/``load_finetuned``: the
  torch head, the fast head, a ``_tl`` encoder, ``block_layout: scan`` and
  a legacy flat-qkv tree;
* a port directory -> the JAX ``load_finetuned`` (and its
  ``load_checkpoint``): the torch head, the fast head, ``scan``;
* resume both ways (``Trainer.restore`` on each side gets the other's step,
  parameters, statistics, AdamW moments and ``best_metric``), with and
  without ``freeze_backbone`` and the warm-restart schedule; the JAX side's
  restore must take the moments (not its fallback that drops them);
* distillation from a JAX teacher directory (``build_teacher``, and
  ``mode=train`` with ``train.teacher_ckpt_path``), ``resume_from`` in the
  CLI;
* ``EvaluationPipeline``/``ModelServer(cfg)``, ``mode=eval``,
  ``mode=chip_inference`` and ``mode=export`` on a JAX directory against the
  JAX pipeline on the same directory;
* a web-platform task (stages in process, ``DEVICE=cpu``) whose registry
  holds a JAX-written ``instageo_best_checkpoint``, against the JAX model's
  class ids.

(``mode=sliding_inference`` on a JAX directory: ``tests/test_torch_granule.py``.)
"""

import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.parallel.mesh import make_mesh
from instageo_tpu.serve.pipeline import EvaluationPipeline as JaxEvaluationPipeline
from instageo_tpu.train import factory as jax_factory
from instageo_tpu.train.checkpointing import BestCheckpointer as JaxBestCheckpointer
from instageo_tpu.train.checkpointing import load_checkpoint as jax_load_checkpoint
from instageo_tpu.train.trainer import Trainer as JaxTrainer
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import (
    seg_state_dict_from_jax,
    seg_variables_from_torch,
)
from instageo_tpu_torch.serve.export import load_predict
from instageo_tpu_torch.serve.pipeline import EvaluationPipeline
from instageo_tpu_torch.train import factory, run
from instageo_tpu_torch.train.checkpointing import BestCheckpointer, model_variables
from instageo_tpu_torch.train.trainer import Trainer
from tests.test_torch_serving import (  # noqa: F401  (world: a fixture)
    EVAL_ATOL,
    _cfg,
    _decided,
    _jax_cfg,
    _overrides,
    _predictions,
    world,
)
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

LOGITS_ATOL = 5e-4
FAST_ATOL = 1e-4

# case -> (variant, depth, JAX model kwargs, config overrides)
CASES = {
    "torch": ("prithvi_eo_tiny", 2, {}, {}),
    "fast": ("prithvi_eo_tiny", 2, {"head_impl": "fast"}, {"model.head_impl": "fast"}),
    "tl": ("prithvi_eo_v2_300_tl", 1, {}, {}),
    "scan": ("prithvi_eo_tiny", 2, {"block_layout": "scan"}, {"tpu.block_layout": "scan"}),
    "flat_qkv": ("prithvi_eo_tiny", 2, {}, {}),
}


def _config(case, **extra):
    variant, depth, _, over = CASES[case]
    return {"model.model_name": variant, "model.depth": depth, "model.num_classes": 3,
            "model.load_pretrained_weights": False, "dataloader.img_size": 32,
            "dataloader.bands": [0, 1, 2, 3, 4, 5], "train.learning_rate": 1e-3,
            "train.weight_decay": 0.01, "train.ignore_index": -1, "train.batch_size": 4,
            "train.class_weights": [0.5, 1.0, 2.0], "tpu.precision": "f32",
            "tpu.donate_state": False, **over, **extra}


def _jax_model(case, seed=3):
    variant, depth, kw, _ = CASES[case]
    model = jax_create_prithvi_seg(variant, temporal_step=1, depth=depth, image_size=32,
                                   num_bands=6, num_classes=3, **kw)
    return model, random_seg_variables(model, 1, 32, seed=seed)


def _jax_save(root, variables, step=7, opt_state=None, metrics=None):
    ckpt = JaxBestCheckpointer(str(root))
    ckpt.save(types.SimpleNamespace(step=np.int32(step), params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    opt_state=opt_state), metrics=metrics)
    return ckpt.path


def _flat_qkv(params):
    """The tree before the head-structured qkv: each block's qkv kernel
    ``(D, 3·H·Dh)`` and bias ``(3·H·Dh,)``."""
    enc = dict(params["prithvi_encoder"])
    for name, blk in list(enc.items()):
        if name.startswith("blocks_"):
            qkv = blk["attn"]["qkv"]
            k = np.asarray(qkv["kernel"])
            flat = {"kernel": k.reshape(k.shape[0], -1), "bias": np.asarray(qkv["bias"]).ravel()}
            enc[name] = {**blk, "attn": {**blk["attn"], "qkv": flat}}
    return {**params, "prithvi_encoder": enc}


def _x(seed=5, b=2):
    return np.random.default_rng(seed).standard_normal((b, 6, 1, 32, 32)).astype(np.float32)


def _port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_directory_loads_in_the_port(tmp_path, case):
    model, variables = _jax_model(case)
    saved = variables
    if case == "flat_qkv":
        saved = {**variables, "params": _flat_qkv(variables["params"])}
        assert np.asarray(saved["params"]["prithvi_encoder"]["blocks_0"]["attn"]["qkv"]
                          ["kernel"]).ndim == 2
    path = _jax_save(tmp_path, saved)
    x = _x()
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    cfg = load_config("config", overrides=_config(case, device="cpu", checkpoint_path=path))
    port = factory.create_model(cfg, seed=0, device="cpu")
    np.testing.assert_allclose(_port_logits(port, x), ref, rtol=0,
                               atol=FAST_ATOL if case == "fast" else LOGITS_ATOL)


@pytest.mark.parametrize("case", ["torch", "fast", "scan"])
def test_port_directory_loads_in_jax(tmp_path, case):
    cfg = load_config("config", overrides=_config(case, device="cpu"))
    port = factory.create_model(cfg, seed=4, device="cpu")
    layout = "scan" if case == "scan" else "loop"
    path = BestCheckpointer(str(tmp_path)).save(model_variables(port, layout))
    restored = jax_load_checkpoint(path)
    assert int(restored["step"]) == 0
    jcfg = jax_load_config("config", overrides=_config(case, checkpoint_path=path))
    jmodel, jvars = jax_factory.create_model(jcfg)
    x = _x(6)
    ref = _port_logits(port, x)
    np.testing.assert_allclose(np.asarray(jmodel.apply(jvars, jnp.asarray(x))), ref, rtol=0,
                               atol=FAST_ATOL if case == "fast" else LOGITS_ATOL)


# --- resume both ways ----------------------------------------------------------

RESUME = {"plain": {}, "freeze": {"model.freeze_backbone": True},
          "schedule": {"train.scheduler": True},
          "freeze_schedule": {"model.freeze_backbone": True, "train.scheduler": True}}


def _batches(n=1, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((4, 6, 1, 32, 32)).astype(np.float32)
        y = rng.integers(0, 3, (4, 32, 32)).astype(np.int32)
        out.append((x, y))
    return out


def _jax_adam(opt_state):
    """The live ``ScaleByAdamState`` inside a JAX trainer's optax state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _jax_adam(s)
            if found is not None:
                return found
    return None


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_moments(trainer, arch):
    """The port trainer's AdamW moments as JAX trees (the trainable part)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    mu, nu, steps = {}, {}, set()
    for p, st in trainer.optimizer.state.items():
        mu[names[id(p)]], nu[names[id(p)]] = st["exp_avg"], st["exp_avg_sq"]
        steps.add(float(st["step"]))
    to_tree = lambda m: seg_variables_from_torch(m, arch)["params"]  # noqa: E731
    return to_tree(mu), to_tree(nu), steps


@pytest.mark.parametrize("options", sorted(RESUME))
def test_port_run_resumes_in_jax(tmp_path, options):
    over = _config("torch", **RESUME[options])
    cfg = load_config("config", overrides={**over, "device": "cpu"})
    port = factory.build_model(cfg, device="cpu", training=True, seed=0)
    trainer = Trainer(cfg, port, device="cpu", steps_per_epoch=2)
    trainer.run_train_epoch(iter(_batches(2)), torch.Generator().manual_seed(0), 4)
    ckpt = BestCheckpointer(str(tmp_path))
    ckpt.save(trainer.state_dict(), metrics={"val_IoU": 0.375})

    jcfg = jax_load_config("config", overrides=over)
    jmodel, jvars = jax_factory.create_model(jcfg)
    jtrainer = JaxTrainer(jcfg, jmodel, jvars, mesh=make_mesh(1), steps_per_epoch=2)
    jtrainer.restore(ckpt.path)
    assert int(jtrainer.state.step) == trainer.step == 2
    assert jtrainer.best_metric == 0.375
    arch = port.arch
    want = seg_variables_from_torch(port.state_dict(), arch)
    got = jax.tree.map(np.asarray, jax.device_get(
        {"params": jtrainer.state.params, "batch_stats": jtrainer.state.batch_stats}))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, got, want)
    adam = _jax_adam(jax.device_get(jtrainer.state.opt_state))
    assert adam is not None and int(adam.count) == 2
    mu, nu, steps = _port_moments(trainer, arch)
    assert steps == {2.0}
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        for path, leaf in _walk(ours):
            np.testing.assert_array_equal(np.asarray(_at(theirs, path)), leaf,
                                          err_msg=str(path))
    frozen = "freeze" in options
    assert ("prithvi_encoder" in mu) != frozen
    if frozen:  # masked in the JAX state
        assert not any(isinstance(leaf, (np.ndarray, jax.Array)) for leaf in
                       jax.tree.leaves(adam.mu["prithvi_encoder"]))


@pytest.mark.parametrize("options", sorted(RESUME))
def test_jax_run_resumes_in_the_port(tmp_path, options):
    over = _config("torch", **RESUME[options])
    jcfg = jax_load_config("config", overrides=over)
    jmodel, jvars = jax_factory.create_model(jcfg)
    jtrainer = JaxTrainer(jcfg, jmodel, jvars, mesh=make_mesh(1), steps_per_epoch=2)
    jtrainer.run_train_epoch(iter(_batches(2)), jax.random.PRNGKey(0), 4)
    path = JaxBestCheckpointer(str(tmp_path)).save(jtrainer.state,
                                                   metrics={"val_IoU": 0.625, "epoch": 4})
    state = jax.tree.map(np.asarray, jax.device_get(jtrainer.state))

    cfg = load_config("config", overrides={**over, "device": "cpu"})
    port = factory.build_model(cfg, device="cpu", training=True, seed=1)
    trainer = Trainer(cfg, port, device="cpu", steps_per_epoch=2)
    trainer.restore(path)
    assert trainer.step == int(state.step) == 2
    assert trainer.epoch == 0 and trainer.best_metric == 0.625
    want = seg_state_dict_from_jax({"params": state.params, "batch_stats": state.batch_stats},
                                   port.arch)
    got = port.state_dict()
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    adam = _jax_adam(state.opt_state)
    mu, nu, steps = _port_moments(trainer, port.arch)
    assert steps == {float(adam.count)} == {2.0}
    for ours, theirs in ((mu, adam.mu), (nu, adam.nu)):
        for path, leaf in _walk(ours):
            np.testing.assert_array_equal(leaf, np.asarray(_at(theirs, path)),
                                          err_msg=str(path))
    trainable = {n for n, p in port.named_parameters()
                 if not ("freeze" in options and n.startswith("prithvi_encoder."))}
    assert len(trainer.optimizer.state) == len(trainable)
    # The resumed run goes on.
    loss = trainer.run_train_epoch(iter(_batches(1, seed=10)), torch.Generator(), 4)
    assert np.isfinite(loss["train_loss"]) and trainer.step == 3


# --- distillation, the CLI and serving -------------------------------------------

def test_teacher_from_a_jax_directory(tmp_path):
    model, variables = _jax_model("torch", seed=8)
    path = _jax_save(tmp_path / "teacher", variables)
    cfg = load_config("config", overrides=_config("torch", device="cpu"))
    teacher = factory.build_teacher(cfg, path, device="cpu")
    x = _x(7)
    np.testing.assert_allclose(_port_logits(teacher, x),
                               np.asarray(model.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=LOGITS_ATOL)
    assert not any(p.requires_grad for p in teacher.parameters())


@pytest.fixture(scope="module")
def jax_dir(world):
    """A JAX ``BestCheckpointer`` directory of the serving world's model
    (the same seeded weights as its reference ``.ckpt``)."""
    root, _ = world
    jcfg = jax_load_config("config", overrides=_overrides(root, None))
    variables = random_seg_variables(jax_factory.build_model(jcfg), 1, 32, seed=21)
    return _jax_save(root / "jax_run", variables, step=12)


def test_pipeline_and_cli_modes_read_a_jax_directory(world, jax_dir, tmp_path, capsys):
    """``EvaluationPipeline`` (``ModelServer(cfg)``), ``mode=eval`` and
    ``mode=chip_inference`` on the JAX directory against the JAX pipeline
    on it; ``mode=export``'s class ids against the server's."""
    root, _ = world
    ref_pipe = JaxEvaluationPipeline(_jax_cfg(root, jax_dir))
    ref = ref_pipe.evaluate()
    ref_pipe.chip_inference(str(tmp_path / "jax"))
    ref_pipe.cleanup()
    theirs = _predictions(tmp_path / "jax")

    pipe = EvaluationPipeline(_cfg(root, jax_dir))
    metrics = pipe.evaluate()
    server = pipe.server
    decided = _decided(server.model, root)
    argv = ["device=cpu"] + [f"{k}={json.dumps(v) if isinstance(v, list) else v}"
                             for k, v in _overrides(root, jax_dir).items()]
    cli = run.main(["mode=eval"] + argv)
    for ours in (metrics, cli):
        for key, value in ref.items():
            if key != "inference_time":
                np.testing.assert_allclose(ours[key], value, rtol=0, atol=EVAL_ATOL,
                                           err_msg=key)
    assert run.main(["mode=chip_inference"] + argv) == 4
    cli_preds = _predictions(root / "predictions")
    shutil.rmtree(root / "predictions")
    assert sorted(cli_preds) == sorted(theirs)
    for name, pred in cli_preds.items():
        assert decided[name].mean() > 0.9
        np.testing.assert_array_equal(pred[decided[name]], theirs[name][decided[name]])

    out = tmp_path / "model.pt2"
    assert run.main(["mode=export", f"export.path={out}"] + argv) == str(out)
    predict, _ = load_predict(str(out))
    x = np.random.default_rng(2).normal(size=(2, 6, 1, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = server.model.eval()(torch.from_numpy(x)).argmax(1)
    np.testing.assert_array_equal(predict(server.model.state_dict(), x).numpy(),
                                  want.numpy().astype(np.int8))
    pipe.cleanup()
    capsys.readouterr()


def test_cli_resumes_and_distils_from_jax_directories(world, jax_dir, tmp_path):
    """``mode=train`` with ``resume_from`` and with a JAX teacher
    (``train.distillation``, ``train.teacher_ckpt_path``)."""
    root, _ = world
    over = {k: v for k, v in _overrides(root, None).items() if k != "checkpoint_path"}
    over.update({"train_filepath": str(root / "data.csv"),
                 "valid_filepath": str(root / "data.csv"), "train.num_epochs": 1})
    argv = ["mode=train", "device=cpu"] + [
        f"{k}={json.dumps(v) if isinstance(v, list) else v}" for k, v in over.items()]
    resumed = run.main(argv + [f"run_dir={tmp_path / 'resumed'}", f"resume_from={jax_dir}"])
    assert np.isfinite(resumed["train_loss"])
    saved = BestCheckpointer(str(tmp_path / "resumed")).restore()
    assert int(saved["step"]) == 13  # the JAX run's 12, then one step of 4 chips
    distilled = run.main(argv + [f"run_dir={tmp_path / 'distilled'}", "train.distillation=True",
                                 f"train.teacher_ckpt_path={jax_dir}"])
    assert np.isfinite(distilled["train_loss"])


def test_web_task_serves_a_jax_checkpoint(tmp_path, monkeypatch):
    """A task of the port's web platform (its three stages drained in
    process on the CPU) whose registry holds a JAX-written
    ``instageo_best_checkpoint``: its class ids are the JAX model's on the
    chips the task wrote, wherever the JAX logits' top-2 gap is at least
    2e-3."""
    import torch_webapp_helpers as helpers  # tests/ is on sys.path (no __init__.py)

    from instageo_tpu_torch.data import stac
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.data.sources import hls
    from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device
    from instageo_tpu_torch.webapp import queue, settings
    from instageo_tpu_torch.webapp.tasks import Task

    item, bbox = helpers.granule_world(str(tmp_path))
    jcfg = jax_load_config("config", overrides=helpers.model_overrides())
    jmodel = jax_factory.build_model(jcfg)
    variables = random_seg_variables(jmodel, 1, helpers.CHIP, seed=23)
    ckpt = _jax_save(tmp_path / "jax_run", variables)
    cfg = load_config("config", overrides=helpers.model_overrides())
    registry, models = helpers.write_model(str(tmp_path), cfg.to_yaml(), ckpt)
    monkeypatch.setenv("MODELS_REGISTRY_PATH", registry)
    monkeypatch.setenv("MODELS_PATH", models)
    monkeypatch.setattr(stac.StacClient, "search",
                        lambda self, **kw: [stac.StacItem.from_dict(helpers.copy_item(item))])
    monkeypatch.setattr(hls, "retrieve_stac_metadata", hls.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    monkeypatch.setattr(settings.settings, "TASKS_DATA_DIR", str(tmp_path / "tasks"))
    monkeypatch.setattr(settings.settings, "DEVICE", "cpu")
    dbp = str(tmp_path / "web.sqlite")
    task = Task(bboxes=[bbox], parameters={"date": "2024-06-01", "chip_size": helpers.CHIP,
                                           "num_steps": 1, "data_source": "HLS"},
                model_key="toy_model", model_size="base", db_path=dbp)
    task.save()
    task.start_data_processing()
    assert queue.drain(db_path=dbp) == 3
    rec = Task.load(task.task_id, dbp)
    assert rec.status == "completed", rec.stages
    chips = sorted(os.listdir(os.path.join(task.data_dir, "chips")))
    assert chips
    decided = agree = 0
    for c in chips:
        with GeoTiffReader(os.path.join(task.data_dir, "chips", c)) as r:
            raw = r.read()[None]
        x = preprocess_chips(raw_to_device(raw, torch.device("cpu")), torch.tensor(helpers.MEAN),
                             torch.tensor(helpers.STD), 1, torch.arange(6), 1.0,
                             img_size=helpers.CHIP)
        logits = np.asarray(jmodel.apply(variables, jnp.asarray(x.numpy())))[0]
        top2 = np.sort(logits, axis=0)[-2:]
        ok = (top2[1] - top2[0]) >= 2e-3
        with GeoTiffReader(os.path.join(task.data_dir, "predictions",
                                        c.replace("chip", "prediction"))) as r:
            pred = r.read(1)
        decided += int(ok.sum())
        agree += int((pred == logits.argmax(0))[ok].sum())
    assert decided > 0.9 * len(chips) * helpers.CHIP ** 2 and agree == decided
