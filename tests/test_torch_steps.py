"""``tpu.steps_per_call``: the port's grouped train and eval steps.

On the CPU the grouped code runs without a CUDA graph: the k host batches
staged into the group's (k, B, ...) buffers, the k steps' dropout seeds in
the seed slots, the learning rates per step. So these tests hold the
staging, the seed order and the tail to the one-step run:

* k = 4 over 8 and 6 batches (a tail of 2) and k = 8 over 3 batches (all
  tail) against k = 1, with dropout, the schedule and ``grad_accum`` on:
  the same seeds, so the losses are equal and the parameters equal within
  float32 rounding (atol 1e-7; on the CPU the two runs do the same
  arithmetic in the same order);
* the port's k = 4 run against the JAX package's scanned trainer, on
  ``tests/model_tests/test_trainer_scan.py``'s setup with dropout off on
  both sides, within that file's tolerances (train loss 1e-5 relative,
  IoU 2e-2, parameters rtol 5e-2 / atol 2e-3), but for the conv biases
  ahead of a BatchNorm, whose exact gradient is 0: Adam moves both sides'
  on rounding noise, so they are held to 2·lr per step;
* the grouped eval epoch against the eager one, ROC-AUC included
  (``AucHistogram`` now counts with ``index_add_``): equal;
* ``auto`` resolves to 1 on the CPU and to the JAX trainer's cap on a CUDA
  device.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.models.seg import TPUDropout
from instageo_tpu.parallel.mesh import make_mesh
from instageo_tpu.train.factory import create_model as jax_create_model
from instageo_tpu.train.trainer import Trainer as JaxTrainer
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg, train_mode
from instageo_tpu_torch.train import factory
from instageo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

PARAM_ATOL = 1e-7


def _data(n_batches, bs=4, size=32, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(scale=0.5, size=(bs, 6, 1, size, size)).astype(np.float32),
             rng.integers(-1, 2, size=(bs, size, size)).astype(np.int64))
            for _ in range(n_batches)]


def _port_run(k, batches, grad_accum=1, epochs=1):
    cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                     "batch_size": 4, "scheduler": True, "grad_accum": grad_accum},
           "model": {"num_classes": 2}, "tpu": {"steps_per_call": k}}
    model = create_prithvi_seg("prithvi_eo_tiny", num_classes=2, depth=2, image_size=32,
                               param_dtype=torch.float32, device="cpu", seed=0)
    trainer = Trainer(cfg, model, device="cpu", steps_per_epoch=len(batches))
    losses, metrics = [], []
    for epoch in range(epochs):
        metrics.append(trainer.run_train_epoch(
            iter(batches), torch.Generator().manual_seed(7 + epoch), 4, losses=losses))
    return trainer, [float(x) for x in losses], metrics


@pytest.mark.parametrize("k,n_batches,grad_accum", [(4, 8, 1), (4, 6, 2), (8, 3, 1)])
def test_grouped_steps_equal_single_steps(k, n_batches, grad_accum):
    """Two epochs, so the second runs every full group through the group
    buffers again (the seeds and the rates of later steps)."""
    batches = _data(n_batches)
    one, losses_1, m_1 = _port_run(1, batches, grad_accum, epochs=2)
    grouped, losses_k, m_k = _port_run(k, batches, grad_accum, epochs=2)
    assert grouped.steps_per_call == k and grouped.step == one.step == 2 * n_batches
    assert losses_k == losses_1 and len(losses_k) == 2 * n_batches
    for a, b in zip(m_1, m_k):
        assert a == b
    ref = one.model.state_dict()
    for name, value in grouped.model.state_dict().items():
        torch.testing.assert_close(value, ref[name], rtol=0, atol=PARAM_ATOL, msg=name)
    for p_1, p_k in zip(one.optimizer.state.values(), grouped.optimizer.state.values()):
        torch.testing.assert_close(p_k["exp_avg"], p_1["exp_avg"], rtol=0, atol=PARAM_ATOL)


def test_grouped_steps_take_the_one_step_dropout_seeds():
    """Dropout on: each step's masks come from its seed slots, in call
    order, as the one-step loop draws them; a group that took another
    number of seeds than its slots raises."""
    batches = _data(4)
    one, losses_1, _ = _port_run(1, batches)
    grouped, losses_k, _ = _port_run(4, batches)
    assert losses_k == losses_1
    (group,) = grouped._groups.values()
    assert group.seeds.buffer.numel() == 4 * 5 and group.seeds.taken == 20
    group.seeds_per_step, group.seeds = 4, type(group.seeds)(16, "cpu")
    with pytest.raises(RuntimeError, match="dropout"):
        grouped.run_train_epoch(iter(batches), torch.Generator(), 4)


@pytest.mark.parametrize("n_batches", [8, 6])
def test_grouped_eval_equals_eager(n_batches):
    batches = _data(n_batches)
    out = {}
    for k in (1, 4):
        trainer, _, _ = _port_run(k, batches[:2])
        out[k] = [trainer.run_eval_epoch(iter(batches), 4, step) for step in ("val", "test")]
    assert out[1] == out[4]
    assert np.isfinite(out[4][1]["test_roc_auc"])


def test_steps_per_call_auto():
    cfg = load_config("multitemporal_crop_classification")
    c = factory.model_channels(cfg)
    assert factory.steps_per_call(cfg, "cpu", c) == 1
    assert factory.steps_per_call(cfg, "cuda", c) == 8  # 8 × 6·3·224²·2 bytes per group
    # 64 chips of 1.8 MB: 4 groups under 512 MB; f32 transfer doubles the bytes.
    assert factory.steps_per_call(cfg, "cuda", c, batch_size=64) == 4
    f32 = load_config("multitemporal_crop_classification", overrides={"tpu.precision": "f32"})
    assert factory.steps_per_call(f32, "cuda", c, batch_size=64) == 2
    assert factory.steps_per_call(f32, "cuda", c, batch_size=10_000) == 1
    fixed = load_config("config", overrides={"tpu.steps_per_call": 3})
    assert factory.steps_per_call(fixed, "cpu", 6) == 3
    model = create_prithvi_seg("prithvi_eo_tiny", depth=1, image_size=32,
                               param_dtype=torch.float32, device="cpu")
    assert Trainer(cfg, model, device="cpu").steps_per_call == 1


# ---------------------------------------------------------------------------
# Against the JAX package's scanned trainer
# ---------------------------------------------------------------------------


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, TPUDropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


SCAN_OVERRIDES = {"dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
                  "model.model_name": "prithvi_eo_tiny", "model.load_pretrained_weights": False,
                  "train.batch_size": 8, "train.ignore_index": -1, "train.learning_rate": 1e-3,
                  "tpu.precision": "f32", "tpu.steps_per_call": 4}


def test_grouped_steps_match_the_jax_scan():
    """6 batches at k = 4: one scanned (JAX) / grouped (port) call and a
    tail of 2 single steps."""
    rng = np.random.default_rng(3)
    batches = [(rng.normal(scale=0.5, size=(8, 6, 1, 32, 32)).astype(np.float32),
                rng.integers(0, 2, size=(8, 32, 32)).astype(np.int32)) for _ in range(6)]
    jcfg = jax_load_config("config", overrides=SCAN_OVERRIDES)
    jmodel, variables = jax_create_model(jcfg)
    host_variables = jax.tree.map(np.array, variables)  # the trainer donates its state
    jtrainer = JaxTrainer(jcfg, jmodel, variables, mesh=make_mesh(1))
    with fnn.intercept_methods(_no_dropout):
        ref = jtrainer.run_train_epoch(iter(batches), jax.random.PRNGKey(7), 8)
    ref_params = jax.device_get(jtrainer.state.params)

    cfg = load_config("config", overrides=SCAN_OVERRIDES)
    model = factory.build_model(cfg, device="cpu", training=True)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32,
                    depth=len(model.prithvi_encoder.blocks))
    model.load_state_dict(seg_state_dict_from_jax(host_variables, arch))
    train_mode(model, torch.Generator(), dropout_rate=0.0)
    trainer = Trainer(cfg, model, device="cpu")
    got = trainer.run_train_epoch(iter(batches), torch.Generator(), 8)
    assert trainer.step == 6 and int(jax.device_get(jtrainer.state.step)) == 6
    assert got["train_loss"] == pytest.approx(ref["train_loss"], rel=1e-5)
    assert got["train_IoU"] == pytest.approx(ref["train_IoU"], rel=2e-2)
    ours = model.state_dict()
    for name, value in seg_state_dict_from_jax({"params": ref_params,
                                                "batch_stats": {}}, arch).items():
        if name not in ours or "running" in name:
            continue
        if name.startswith("segmentation_head.") and name.endswith(".2.bias"):
            # A conv bias ahead of a BatchNorm has an exact gradient of 0:
            # both sides step on rounding noise, at most 2·lr apart per step.
            assert (ours[name] - value).abs().max().item() <= 2 * 1e-3 * 6, name
            continue
        np.testing.assert_allclose(ours[name].numpy(), value.numpy(), rtol=5e-2, atol=2e-3,
                                   err_msg=name)
