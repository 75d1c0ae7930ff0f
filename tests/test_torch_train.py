"""Parity of the port's training pieces with the JAX package.

Losses, AdamW, the schedule, the confusion matrix and batch padding are
held to the JAX functions on the same seeded numpy inputs; one whole train
step of the tiny model (depth 2, 32 px, 6 bands, 3 classes, batch 2,
float32) is held to ``jax.value_and_grad`` over the JAX model's train-mode
apply, once with JAX's XLA attention (T=1) and once with its Pallas
kernels in interpret mode (T=2), so that the Pallas backward is the
reference. Dropout is off on both sides (JAX: ``TPUDropout`` intercepted,
test-only; port: p = 0).

The trainer's options hold to the JAX ``Trainer`` (one device mesh, dropout
off) on one step from the same weights: ``grad_accum=2`` with unevenly
padded micro-batches, regression with and without ``use_log_scale``, and
distillation against a frozen teacher, with the same tolerances as the
whole train step. ``AucHistogram`` and ``RegressionStats`` agree with
theirs within 1e-6 relative. A run restored from its checkpoint goes on
bit for bit as an unbroken one.

Tolerances: losses 1e-6 relative (float32, another summation order);
AdamW 1e-6 relative (float32 elementwise); train-step loss 1e-5 relative,
gradients ‖Δ‖ ≤ 1e-4·‖ref‖ + 1e-6 per parameter and BatchNorm statistics
1e-5 (float32 through two blocks and four convolution stages, other
summation orders); parameters after the step atol 1e-2·lr where the
reference gradient is at least 100·eps, and 2·lr elsewhere: Adam's first
step moves a parameter by lr·(g/(|g|+eps) + wd·p), which magnifies the
float32 noise of a gradient near zero up to a sign.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.models.seg import TPUDropout
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.parallel.mesh import make_mesh
from instageo_tpu.parallel.mesh import pad_batch as jax_pad_batch
from instageo_tpu.train import losses as jl
from instageo_tpu.train.metrics import AucHistogram as JaxAucHistogram
from instageo_tpu.train.metrics import ConfusionMatrix as JaxConfusionMatrix
from instageo_tpu.train.metrics import RegressionStats as JaxRegressionStats
from instageo_tpu.train.optim import clip_params as jax_clip_params
from instageo_tpu.train.optim import cosine_warm_restarts as jax_schedule
from instageo_tpu.train.optim import make_optimizer as jax_make_optimizer
from instageo_tpu.train.trainer import EpochMetrics as JaxEpochMetrics
from instageo_tpu.train.trainer import Trainer as JaxTrainer
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg, train_mode
from instageo_tpu_torch.train import losses as tl
from instageo_tpu_torch.train.checkpointing import BestCheckpointer
from instageo_tpu_torch.train.metrics import AucHistogram, ConfusionMatrix, RegressionStats
from instageo_tpu_torch.train.optim import (
    clip_params,
    cosine_warm_restarts,
    make_optimizer,
)
from instageo_tpu_torch.train.trainer import Trainer, pad_batch
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

LOSS_RTOL = 1e-6
ADAM_RTOL = 1e-6
STEP_LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
BN_TOL = 1e-5
LR = 1e-3
ADAM_EPS = 1e-8
KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)
CLASS_WEIGHTS = [0.5, 1.0, 2.0]


def _seg_case(seed, classes=4, shape=(2, 6, 5)):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    logits = rng.standard_normal((b, classes, h, w)).astype(np.float32) * 3
    teacher = rng.standard_normal((b, classes, h, w)).astype(np.float32) * 3
    labels = rng.integers(-1, classes + 1, (b, h, w)).astype(np.int32)  # -1 ignored, C clipped
    return logits, teacher, labels


@pytest.mark.parametrize("weights", [None, [0.3, 1.0, 2.5, 0.7]])
def test_cross_entropy_and_distillation_match_jax(weights):
    logits, teacher, labels = _seg_case(1)
    t = [torch.from_numpy(a) for a in (logits, teacher, labels)]
    j = [jnp.asarray(a) for a in (logits, teacher, labels)]
    ce = tl.masked_cross_entropy(t[0], t[2], -1, weights)
    np.testing.assert_allclose(ce.item(), jl.masked_cross_entropy(j[0], j[2], -1, weights),
                               rtol=LOSS_RTOL)
    kl = tl.kl_distillation_loss(t[0], t[1], t[2], -1)
    np.testing.assert_allclose(kl.item(), jl.kl_distillation_loss(j[0], j[1], j[2], -1),
                               rtol=LOSS_RTOL)
    total, parts = tl.segmentation_loss_with_distillation(t[0], t[1], t[2], -1, weights)
    total_j, parts_j = jl.segmentation_loss_with_distillation(j[0], j[1], j[2], -1, weights)
    np.testing.assert_allclose(total.item(), total_j, rtol=LOSS_RTOL)
    for key in ("loss", "ce_loss", "distill_loss"):
        np.testing.assert_allclose(parts[key].item(), parts_j[key], rtol=LOSS_RTOL)
    # Every pixel ignored: the denominator is clamped to 1.
    none = np.full_like(labels, -1)
    assert tl.masked_cross_entropy(t[0], torch.from_numpy(none), -1, weights).item() == 0.0


@pytest.mark.parametrize("use_log_scale", [False, True])
def test_regression_losses_match_jax(use_log_scale):
    rng = np.random.default_rng(2)
    preds = rng.standard_normal((2, 7, 5)).astype(np.float32)
    teacher = rng.standard_normal((2, 7, 5)).astype(np.float32)
    labels = rng.uniform(0, 3, (2, 7, 5)).astype(np.float32)
    labels[0, :2] = -1.0
    t = [torch.from_numpy(a) for a in (preds, teacher, labels)]
    j = [jnp.asarray(a) for a in (preds, teacher, labels)]
    np.testing.assert_allclose(
        tl.masked_mse(t[0], t[2], -1.0, use_log_scale).item(),
        jl.masked_mse(j[0], j[2], -1.0, use_log_scale), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        tl.mse_distillation_loss(t[0], t[1], t[2], -1.0).item(),
        jl.mse_distillation_loss(j[0], j[1], j[2], -1.0), rtol=LOSS_RTOL)


class _TwoPart(nn.Module):
    """A backbone and a head, named as the segmentation model's are."""

    def __init__(self, params):
        super().__init__()
        self.prithvi_encoder = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params["prithvi_encoder"].items()})
        self.head = nn.ParameterDict(
            {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in params["head"].items()})


@pytest.mark.parametrize("freeze,clip", [(False, None), (True, None), (False, (-0.5, 0.5))])
def test_adamw_matches_optax(freeze, clip):
    rng = np.random.default_rng(3)
    params = {"prithvi_encoder": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
              "head": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                       "b": rng.standard_normal((2,)).astype(np.float32)}}
    module = _TwoPart(params)
    opt = make_optimizer(module, 1e-2, 0.05, freeze_backbone=freeze)
    tx = jax_make_optimizer(params, 1e-2, 0.05, freeze_backbone=freeze)
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = jax_clip_params(optax.apply_updates(jparams, updates), clip)
        for part in ("prithvi_encoder", "head"):
            for k, p in getattr(module, part).items():
                p.grad = torch.from_numpy(grads[part][k])
        opt.step()
        clip_params(module, clip)
    for part in ("prithvi_encoder", "head"):
        for k, p in getattr(module, part).items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[part][k]),
                                       rtol=ADAM_RTOL, atol=1e-7, err_msg=f"{part}.{k}")
    enc = module.prithvi_encoder["w"].detach().numpy()
    assert np.array_equal(enc, params["prithvi_encoder"]["w"]) == freeze


def test_schedule_matches_jax_at_fractional_epochs():
    ours = cosine_warm_restarts(1e-4, steps_per_epoch=7)
    ref = jax_schedule(1e-4, steps_per_epoch=7)
    for step in (0, 1, 3, 20, 69, 70, 71, 150, 209, 210, 211, 400, 1000):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {step}")
    flat = cosine_warm_restarts(1.0, 2, t_0=3, t_mult=1)
    flat_ref = jax_schedule(1.0, 2, t_0=3, t_mult=1)
    for step in range(0, 14, 3):
        np.testing.assert_allclose(flat(step), float(flat_ref(step)), rtol=1e-5, atol=1e-7)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(4)
    c = 5
    cm, cm_j = ConfusionMatrix(c), JaxConfusionMatrix.empty(c)
    for _ in range(3):
        y = rng.integers(-2, c + 2, (2, 9, 11)).astype(np.int32)  # out of range both ways
        p = rng.integers(-1, c + 1, (2, 9, 11)).astype(np.int32)
        cm.update(torch.from_numpy(y), torch.from_numpy(p), ignore_index=-1)
        cm_j = cm_j.update(jnp.asarray(y), jnp.asarray(p), ignore_index=-1)
    ours, ref = cm.compute(), cm_j.compute()
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-12, err_msg=key)


@pytest.mark.parametrize("n,repeat", [(3, True), (3, False), (8, True), (0, True)])
def test_pad_batch_matches_jax(n, repeat):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 2, 3)).astype(np.float32)
    y = rng.integers(0, 3, (n, 3)).astype(np.int32)
    ours = pad_batch((x, y), 8, -1, repeat_inputs=repeat)
    ref = jax_pad_batch((x, y), 8, -1, repeat_inputs=repeat)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# One whole train step of the tiny model
# ---------------------------------------------------------------------------


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, TPUDropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_steps():
    """T -> (variables, inputs, labels, loss, grads, params and batch stats
    after one step), computed once per module."""
    out = {}
    for t, attn in ((1, "xla"), (2, "pallas")):
        model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=t, attn_impl=attn,
                                       attn_interpret=attn == "pallas", **KW)
        variables = random_seg_variables(model, t, 32, seed=10 + t)
        rng = np.random.default_rng(20 + t)
        x = rng.standard_normal((2, 6, t, 32, 32)).astype(np.float32)
        y = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)
        y[:, :3] = -1

        def loss_fn(params):
            with fnn.intercept_methods(_no_dropout):
                logits, mutated = model.apply(
                    {"params": params, "batch_stats": variables["batch_stats"]},
                    jnp.asarray(x), train=True, mutable=["batch_stats"])
            return jl.masked_cross_entropy(logits, jnp.asarray(y), -1, CLASS_WEIGHTS), mutated

        params = jax.tree.map(jnp.asarray, variables["params"])
        (loss, mutated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx = jax_make_optimizer(params, LR, 0.01)
        new_params = jax.jit(
            lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(params, grads)
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        out[t] = dict(variables=variables, x=x, y=y, loss=float(loss),
                      grads=to_np(grads), params=to_np(new_params),
                      batch_stats=to_np(mutated["batch_stats"]))
    return out


def _bridge(params, batch_stats, t):
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=t, img_size=32, depth=2)
    return seg_state_dict_from_jax({"params": params, "batch_stats": batch_stats}, arch)


@pytest.mark.parametrize("temporal_step", [1, 2])
def test_train_step_matches_jax(jax_steps, temporal_step):
    ref = jax_steps[temporal_step]
    model = create_prithvi_seg("prithvi_eo_tiny", temporal_step=temporal_step,
                               param_dtype=torch.float32, device="cpu", **KW)
    model.load_state_dict(_bridge(ref["variables"]["params"],
                                  ref["variables"]["batch_stats"], temporal_step))
    cfg = {"train": {"learning_rate": LR, "weight_decay": 0.01, "ignore_index": -1,
                     "class_weights": CLASS_WEIGHTS},
           "model": {"num_classes": 3}}
    trainer = Trainer(cfg, model, device="cpu")
    train_mode(model, torch.Generator(), dropout_rate=0.0)
    x, y = torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]).long()
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: grads.__setitem__(name, p.grad.clone()))
        for name, p in model.named_parameters()]
    loss = trainer.train_step(x, y, torch.Generator())
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=STEP_LOSS_RTOL)

    grads_ref = _bridge(ref["grads"], {}, temporal_step)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        diff = (g - grads_ref[name]).norm().item()
        assert diff <= GRAD_REL * grads_ref[name].norm().item() + GRAD_ABS, name

    after_ref = _bridge(ref["params"], ref["batch_stats"], temporal_step)
    state = model.state_dict()
    for name, value in after_ref.items():
        if "running" in name:
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), atol=BN_TOL,
                                       rtol=BN_TOL, err_msg=name)
            continue
        diff = (state[name] - value).abs()
        stable = grads_ref[name].abs() >= 100 * ADAM_EPS
        assert (diff[stable] <= 1e-2 * LR).all(), name
        assert diff.max().item() <= 2 * LR, name


# ---------------------------------------------------------------------------
# The trainer's loops on a separable toy task
# ---------------------------------------------------------------------------


def _synthetic_seg(n=32, size=32, bands=6, seed=0):
    """Per-patch class from band 0's sign (as the JAX trainer's tests)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=0.3, size=(n, bands, 1, size, size)).astype(np.float32)
    sign = rng.choice([-1.0, 1.0], size=(n, size // 16, size // 16))
    sign = np.repeat(np.repeat(sign, 16, axis=1), 16, axis=2)
    x[:, 0, 0] += 1.5 * sign.astype(np.float32)
    y = (sign > 0).astype(np.int32)
    y[:, :2, :] = -1
    return x, y


def _loader(x, y, bs):
    def gen():
        for i in range(0, len(x), bs):
            yield x[i:i + bs], y[i:i + bs]
    return gen


def test_fit_learns_the_toy_task():
    cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                     "batch_size": 8, "num_epochs": 2},
           "model": {"num_classes": 2}}
    model = create_prithvi_seg("prithvi_eo_tiny", num_classes=2, depth=2, image_size=32,
                               param_dtype=torch.float32, device="cpu", seed=0)
    trainer = Trainer(cfg, model, device="cpu")
    x, y = _synthetic_seg()
    hist = trainer.fit(_loader(x, y, 8), _loader(x, y, 8))
    assert {"train_loss", "val_loss", "val_IoU", "val_Acc", "val_F1",
            "val_IoU_0", "val_IoU_1", "epoch"} <= set(hist)
    gen = torch.Generator().manual_seed(0)
    first = trainer.run_train_epoch(_loader(x, y, 8)(), gen, 8)
    for _ in range(4):
        last = trainer.run_train_epoch(_loader(x, y, 8)(), gen, 8)
    assert last["train_loss"] < first["train_loss"] * 0.7
    assert trainer.run_eval_epoch(_loader(x, y, 8)(), 8)["val_Acc"] > 0.8
    # A partial last batch is padded (13 = 8 + 5).
    part = trainer.run_train_epoch(_loader(x[:13], y[:13], 8)(), gen, 8)
    assert np.isfinite(part["train_loss"])


def test_trainer_refuses_what_is_not_ported():
    """What the port does not run raises; grad_accum, distillation, the
    regression task, steps_per_call, checkpointing, the GELU lowerings, the
    scan and pipeline block layouts, remat and ``tpu.quant`` (inference only: its training
    entry points refuse it) are ported and build."""
    model = create_prithvi_seg("prithvi_eo_tiny", depth=1, image_size=32,
                               param_dtype=torch.float32, device="cpu")
    # tp and pp need a mesh of processes (tests/test_torch_parallel.py).
    for cfg in ({"tpu": {"tp": 2}}, {"tpu": {"pp": 2}}):
        with pytest.raises(ValueError, match="mesh"):
            Trainer(cfg, model, device="cpu")
    for cfg in ({"train": {"grad_accum": 2}}, {"train": {"distillation": True}},
                {"tpu": {"block_layout": "pipeline"}}, {"tpu": {"remat": True}},
                {"tpu": {"steps_per_call": "auto"}}, {"tpu": {"steps_per_call": 4}},
                {"is_reg_task": True}, {"tpu": {"gelu": "tanh"}},
                {"tpu": {"block_layout": "scan"}}, {"tpu": {"quant": "int8"}}):
        Trainer(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        Trainer({"tpu": {"quant": "int8"}}, model, device="cpu").run_train_epoch(
            iter([]), torch.Generator(), 8)
    for value in (0, "fast", 2.5):
        with pytest.raises(ValueError, match="steps_per_call"):
            Trainer({"tpu": {"steps_per_call": value}}, model, device="cpu")
    with pytest.raises(ValueError):
        Trainer({}, model, device="cpu").restore("/nonexistent/instageo_best_checkpoint")


# ---------------------------------------------------------------------------
# The trainer's options against the JAX trainer, and metrics
# ---------------------------------------------------------------------------

METRIC_RTOL = 1e-6


def test_auc_and_regression_stats_match_jax():
    rng = np.random.default_rng(5)
    c = 4
    auc, auc_j = AucHistogram(c), JaxAucHistogram.empty(c)
    reg, reg_j = RegressionStats(), JaxRegressionStats.empty()
    for _ in range(3):
        y = rng.integers(-1, c + 1, 500).astype(np.int32)
        logits = rng.standard_normal((500, c)).astype(np.float32) * 2
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        valid = y != -1
        auc.update(torch.from_numpy(y), torch.from_numpy(probs), torch.from_numpy(valid))
        auc_j = auc_j.update(jnp.asarray(y), jnp.asarray(probs), jnp.asarray(valid))
        x = rng.uniform(0, 3, 700).astype(np.float32)
        p = (x + 0.3 * rng.standard_normal(700)).astype(np.float32)
        v = rng.random(700) > 0.2
        reg.update(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(v))
        reg_j = reg_j.update(jnp.asarray(x), jnp.asarray(p), jnp.asarray(v))
    ours, ref = auc.score(), auc_j.score()
    np.testing.assert_allclose(ours["roc_auc_per_class"], ref["roc_auc_per_class"],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(ours["roc_auc_macro"], ref["roc_auc_macro"], rtol=METRIC_RTOL)
    ours, ref = reg.compute(include_ee=True), reg_j.compute(include_ee=True)
    for key in ("mae", "rmse", "r2_score", "pearson_corrcoef", "ee_percentage"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=METRIC_RTOL, err_msg=key)


def _option_overrides(**extra):
    return {"model.model_name": "prithvi_eo_tiny", "model.load_pretrained_weights": False,
            "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
            "train.learning_rate": LR, "train.weight_decay": 0.01, "train.ignore_index": -1,
            "train.class_weights": CLASS_WEIGHTS, "train.batch_size": 4,
            "model.num_classes": 3, "tpu.precision": "f32", "tpu.donate_state": False, **extra}


def _jax_one_step(overrides, variables, x, y, num_classes, teacher=None):
    """One optimizer step of the JAX Trainer on one batch (dropout off) from
    ``variables``, built from its own pieces (``_prepare``, ``_micro_grads``
    or ``_accum_grads``, ``_update_metrics``, its AdamW) in one jitted call
    that also returns the gradients: (train metrics, gradients, params and
    batch stats after the step)."""
    cfg = jax_load_config("config", overrides=overrides)
    model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, depth=2,
                                   image_size=32, num_bands=6, num_classes=num_classes)
    trainer = JaxTrainer(cfg, model, variables, mesh=make_mesh(1), teacher=teacher)

    def step(state, xb, yb, rng):
        empty = JaxEpochMetrics.empty(num_classes)
        if trainer.grad_accum > 1:
            grads, mutated, metrics = trainer._accum_grads(state, xb, yb, rng, empty)
            batch_stats = mutated["batch_stats"]
        else:
            loss, logits, batch_stats, grads = trainer._micro_grads(
                state.params, state.batch_stats, xb, yb, rng)
            metrics = trainer._update_metrics(empty, logits, yb, loss, with_auc=False)
        updates, _ = trainer.tx.update(grads, state.opt_state, state.params)
        return grads, optax.apply_updates(state.params, updates), batch_stats, metrics

    with fnn.intercept_methods(_no_dropout):
        xb, yb = trainer._prepare(x, y, int(cfg.train.batch_size))
        trainer._ensure_opt_state()
        grads, params, batch_stats, metrics = jax.jit(step)(
            trainer.state, xb, yb, jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    return (trainer._finalize(metrics, "train", with_auc=False), to_np(grads),
            to_np(params), to_np(batch_stats))


def _port_model(variables, num_classes):
    model = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, depth=2, image_size=32,
                               num_bands=6, num_classes=num_classes,
                               param_dtype=torch.float32, device="cpu")
    model.load_state_dict(_bridge(variables["params"], variables["batch_stats"], 1))
    return model


def _assert_step_matches(model, ref_grads, ref_params, ref_bs):
    """``test_train_step_matches_jax``'s bounds on the updated parameters.
    The conv biases ahead of a BatchNorm (``segmentation_head.{i}.2.bias``)
    have an exact gradient of 0, so both sides' are rounding noise: they
    are held to the 2·lr bound only."""
    grads_ref = _bridge(ref_grads, {}, 1)
    after_ref = _bridge(ref_params, ref_bs, 1)
    state = model.state_dict()
    for name, value in after_ref.items():
        if "running" in name:
            np.testing.assert_allclose(state[name].numpy(), value.numpy(), atol=BN_TOL,
                                       rtol=BN_TOL, err_msg=name)
            continue
        diff = (state[name] - value).abs()
        pre_bn_bias = name.startswith("segmentation_head.") and name.endswith(".2.bias")
        stable = (grads_ref[name].abs() >= 100 * ADAM_EPS) & (not pre_bn_bias)
        assert (diff[stable] <= 1e-2 * LR).all(), name
        assert diff.max().item() <= 2 * LR, name


@pytest.mark.parametrize("case", ["grad_accum", "regression", "regression_log",
                                  "distillation", "distillation_regression"])
def test_trainer_options_match_jax(case):
    """One step of the port's Trainer against the JAX Trainer's. grad_accum:
    3 real chips padded to 4, so the second micro-batch holds one real
    chip and one all-ignored pad; regression labels in [0, 3) with ignored
    pixels; distillation against a second, frozen model."""
    reg = case.startswith("regression") or case == "distillation_regression"
    nc = 1 if reg else 3
    extra = {"grad_accum": {"train.grad_accum": 2},
             "regression": {"is_reg_task": True},
             "regression_log": {"is_reg_task": True, "model.use_log_scale": True},
             "distillation": {"train.distillation": True},
             "distillation_regression": {"train.distillation": True, "is_reg_task": True},
             }[case]
    jax_model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, depth=2,
                                       image_size=32, num_bands=6, num_classes=nc)
    variables = random_seg_variables(jax_model, 1, 32, seed=30)
    rng = np.random.default_rng(31)
    n = 3 if case == "grad_accum" else 4
    x = rng.standard_normal((n, 6, 1, 32, 32)).astype(np.float32)
    if reg:
        y = rng.uniform(0, 3, (n, 32, 32)).astype(np.float32)
        y[:, :4] = -1.0
    else:
        y = rng.integers(0, 3, (n, 32, 32)).astype(np.int32)
        y[:, :3] = -1
    teacher_vars = teacher = None
    if "distillation" in case:
        teacher_vars = random_seg_variables(jax_model, 1, 32, seed=32)
        teacher = _port_model(teacher_vars, nc).eval().requires_grad_(False)
    ref_m, ref_g, ref_p, ref_bs = _jax_one_step(
        _option_overrides(**extra), variables, x, y, nc,
        teacher=None if teacher_vars is None else (jax_model, teacher_vars))

    model = _port_model(variables, nc)
    trainer = Trainer(load_config("config", overrides=_option_overrides(**extra)), model,
                      device="cpu", teacher=teacher)
    train_mode(model, torch.Generator(), dropout_rate=0.0)
    got = trainer.run_train_epoch(iter([(x, y)]), torch.Generator(), 4)
    np.testing.assert_allclose(got["train_loss"], ref_m["train_loss"], rtol=STEP_LOSS_RTOL)
    if reg:
        for key in ("train_RMSE", "train_MAE", "train_R2"):
            np.testing.assert_allclose(got[key], ref_m[key], rtol=STEP_LOSS_RTOL, err_msg=key)
    _assert_step_matches(model, ref_g, ref_p, ref_bs)
    if reg:  # collect_outputs: the valid pixels' predictions and labels
        out = trainer.run_eval_epoch(iter([(x, y)]), 4, "test", collect_outputs=True)
        valid = y != -1.0
        np.testing.assert_array_equal(out["_labels"], y[valid])
        assert out["_preds"].shape == (valid.sum(),) and np.isfinite(out["_preds"]).all()


def test_restore_resumes_bit_for_bit(tmp_path):
    """2 epochs straight through == 1 epoch, checkpoint, restore into a
    fresh Trainer, 1 more epoch: parameters, BatchNorm statistics and
    AdamW moments equal bit for bit (dropout on, schedule on)."""
    x, y = _synthetic_seg(n=8)

    def run(epochs, restore_from=None, ckpt=None):
        cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                         "batch_size": 4, "num_epochs": epochs, "scheduler": True},
               "model": {"num_classes": 2}}
        model = create_prithvi_seg("prithvi_eo_tiny", num_classes=2, depth=1, image_size=32,
                                   param_dtype=torch.float32, device="cpu", seed=0)
        trainer = Trainer(cfg, model, device="cpu", steps_per_epoch=2)
        if restore_from:
            trainer.restore(restore_from)
        trainer.fit(_loader(x, y, 4), _loader(x, y, 4), checkpointer=ckpt, seed=7)
        return trainer

    straight = run(2)
    ckpt = BestCheckpointer(str(tmp_path))
    first = run(1, ckpt=ckpt)
    resumed = run(1, restore_from=ckpt.path)
    assert resumed.step == straight.step == 4 and resumed.epoch == 2
    assert resumed.best_metric >= first.best_metric
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    opt_a, opt_b = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    for key, st in opt_a["state"].items():
        for field in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[field], opt_b["state"][key][field])
