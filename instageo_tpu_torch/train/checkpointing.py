"""Best-model checkpointing and resume, in the JAX package's format.

Counterpart of ``instageo_tpu/train/checkpointing.py``: one best checkpoint
per run, ``<run_dir>/instageo_best_checkpoint`` (the reference's
``ModelCheckpoint(save_top_k=1, filename="instageo_best_checkpoint")``),
with the epoch's metrics beside it in ``instageo_best_checkpoint.metrics.json``.

The directory is the one the JAX package's ``BestCheckpointer`` writes: an
orbax checkpoint of ``{"step", "params", "batch_stats", "opt_state"}``, the
parameters and BatchNorm statistics as the JAX ``PrithviSeg`` of the run's
config holds them (``models/checkpoint.py:seg_variables_from_torch``), the
optimizer state as the optax tree that ``instageo_tpu/train/optim.py:
make_optimizer`` builds for the config (``adamw_state``). It is written by
``train/orbax_dir.py`` in orbax's plain layout; either layout is read. So
each package serves, evaluates, distils from and resumes the other's
checkpoints. The trainer's count of finished epochs, for which the JAX tree
has no place, is kept in ``_CHECKPOINT_METADATA``'s ``custom_metadata``
(which orbax keeps and ignores); a directory the JAX package wrote has none,
and a resume from it starts at epoch 0, as the JAX trainer's resume does.
The port's earlier directories (one ``state.pt``, written with
``torch.save``) are still read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from instageo_tpu_torch.models.checkpoint import (
    seg_state_dict_from_jax,
    seg_variables_from_torch,
)
from instageo_tpu_torch.train.orbax_dir import (
    checkpoint_custom_metadata,
    read_tree,
    write_tree,
)

BEST_NAME = "instageo_best_checkpoint"
STATE_FILE = "state.pt"  # the port's earlier checkpoint layout, read only
FROZEN_PREFIX = "prithvi_encoder"


class BestCheckpointer:
    """Keeps the single best checkpoint of a run (save_top_k=1)."""

    def __init__(self, run_dir: str, name: str = BEST_NAME) -> None:
        self.path = os.path.abspath(os.path.join(run_dir, name))
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def save(self, state: Dict[str, Any], metrics: Optional[Dict] = None) -> str:
        """Write ``state``, a tree in the JAX layout (``Trainer.state_dict()``,
        or ``model_variables(model)`` for a model alone; ``step`` defaults
        to 0, as the JAX checkpointer always writes one), and the numeric
        ``metrics``; the directory is replaced atomically."""
        tree = dict(state)
        if "params" not in tree:
            raise ValueError("a checkpoint is a tree with 'params' (Trainer.state_dict(), or "
                             "model_variables(model))")
        epoch = tree.pop("epoch", None)
        tree["step"] = np.asarray(tree.get("step", 0), np.int32)
        write_tree(self.path, tree, None if epoch is None else {"epoch": int(epoch)})
        if metrics is not None:
            with open(self.path + ".metrics.json", "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()
                           if isinstance(v, (int, float))}, f)
        return self.path

    def restore(self) -> Dict[str, Any]:
        """The saved state, as :func:`load_checkpoint` reads it."""
        return load_checkpoint(self.path)


def load_checkpoint(path: str, select: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A checkpoint directory of either package: the orbax tree
    (``train/orbax_dir.py:read_tree``; only its top-level keys in ``select``
    where given), with ``epoch`` where the port wrote one; an earlier
    ``state.pt`` directory of the port as ``torch.load(weights_only=True)``
    gives it (``{"model", "optimizer", "step", "epoch"}``)."""
    if not os.path.isdir(path):
        raise ValueError(f"{path}: not a checkpoint directory; for a reference .ckpt use "
                         "factory.load_finetuned")
    legacy = os.path.join(path, STATE_FILE)
    if os.path.isfile(legacy):
        return torch.load(legacy, map_location="cpu", weights_only=True)
    tree = read_tree(path, None if select is None else tuple(select))
    epoch = checkpoint_custom_metadata(path).get("epoch")
    if epoch is not None:
        tree["epoch"] = int(epoch)
    return tree


def load_best_metric(path: str, monitor: str) -> Optional[float]:
    """The monitored metric from a checkpoint's metrics sidecar, if any."""
    metrics_path = os.path.abspath(path) + ".metrics.json"
    if not os.path.exists(metrics_path):
        return None
    with open(metrics_path) as f:
        saved = json.load(f)
    return float(saved[monitor]) if monitor in saved else None


def migrate_param_tree(restored: Any, reference: Any) -> Any:
    """Reshape same-size leaves of ``restored`` onto ``reference``'s shapes.

    The port's copy of ``instageo_tpu/train/checkpointing.py:migrate_param_tree``
    over nested dicts and lists of numpy arrays (None stays None): a
    layout change that keeps the memory order, such as the attention's
    flat qkv ``(D, 3·H·Dh)`` becoming the head-structured ``(D, 3, H, Dh)``,
    leaves older checkpoints with the old shapes; a leaf whose element count
    matches the reference's is reshaped, a true size mismatch or a tree of
    another structure raises ``ValueError``."""

    def fit(new, cur, path):
        if isinstance(cur, Mapping):
            if not isinstance(new, Mapping) or set(new) != set(cur):
                raise ValueError(f"checkpoint tree at {path or 'root'} has keys "
                                 f"{sorted(new) if isinstance(new, Mapping) else type(new)}, "
                                 f"the live one {sorted(cur)}")
            return {k: fit(new[k], cur[k], f"{path}/{k}") for k in cur}
        if isinstance(cur, (list, tuple)):
            if not isinstance(new, (list, tuple)) or len(new) != len(cur):
                raise ValueError(f"checkpoint tree at {path}: not a sequence of {len(cur)}")
            return [fit(n, c, f"{path}/{i}") for i, (n, c) in enumerate(zip(new, cur))]
        if new is None or cur is None:
            if (new is None) != (cur is None):
                raise ValueError(f"checkpoint leaf {path}: {new!r} where the live tree has "
                                 f"{'None' if cur is None else 'an array'}")
            return new
        arr = np.asarray(new)
        cur_shape = tuple(np.shape(cur))
        if arr.shape == cur_shape:
            return new
        if arr.size == int(np.prod(cur_shape, dtype=np.int64)):
            return arr.reshape(cur_shape)
        raise ValueError(f"checkpoint leaf {path} shape {arr.shape} incompatible with live "
                         f"param shape {cur_shape} (sizes differ)")

    return fit(restored, reference, "")


# --- the optax AdamW state --------------------------------------------------

def adamw_state(params: Mapping, count: int, mu: Mapping, nu: Mapping, *,
                scheduler: bool = False, freeze_backbone: bool = False,
                frozen_prefix: str = FROZEN_PREFIX) -> list:
    """The tree orbax saves for ``make_optimizer(params, ...).init`` of the
    JAX package holding ``count`` and the moments: ``optax.adamw``'s chain
    ``[ScaleByAdamState(count, mu, nu), EmptyState, EmptyState]`` (the last a
    ``ScaleByScheduleState(count)`` under the warm-restart schedule), inside
    ``chain(masked(set_to_zero), masked(adamw))`` under ``freeze_backbone``,
    where the moments of ``frozen_prefix`` are masked (None). ``mu`` and
    ``nu`` hold the trainable part of ``params``'s tree."""
    count = np.asarray(count, np.int32)

    def moments(tree):
        if not freeze_backbone:
            return tree
        out = dict(tree)
        out[frozen_prefix] = _none_like(params[frozen_prefix])
        return out

    chain = [{"count": count, "mu": moments(mu), "nu": moments(nu)}, None,
             {"count": count} if scheduler else None]
    if freeze_backbone:
        return [{"inner_state": None}, {"inner_state": chain}]
    return chain


def _none_like(tree):
    if isinstance(tree, Mapping):
        return {k: _none_like(v) for k, v in tree.items()}
    return None


def adamw_moments(opt_state: Any):
    """``(count, mu, nu)`` of the ``ScaleByAdamState`` in an optax tree as
    orbax restores it (dicts for named tuples, lists for tuples), or None."""
    if isinstance(opt_state, Mapping):
        if {"count", "mu", "nu"} <= set(opt_state):
            return int(np.asarray(opt_state["count"])), opt_state["mu"], opt_state["nu"]
        children = list(opt_state.values())
    elif isinstance(opt_state, (list, tuple)):
        children = list(opt_state)
    else:
        return None
    for child in children:
        found = adamw_moments(child)
        if found is not None:
            return found
    return None


def _fill_masked(moment: Any, params: Any) -> Any:
    """A moment tree with its masked (None) leaves as zeros of the
    parameter's shape, so that it converts as a whole parameter tree."""
    if isinstance(params, Mapping):
        return {k: _fill_masked(moment.get(k) if isinstance(moment, Mapping) else None, v)
                for k, v in params.items()}
    return np.zeros(np.shape(params), np.float32) if moment is None else moment


# --- the trainer's state <-> the checkpoint tree ---------------------------

def checkpoint_tree(state: Mapping[str, Any], arch, names: Sequence[str], *,
                    block_layout: str = "loop", scheduler: bool = False,
                    freeze_backbone: bool = False) -> Dict[str, Any]:
    """A trainer's single-card state (``{"model", "optimizer", "step",
    "epoch"}``, the optimizer's ``state_dict`` indexed by ``names``) as the
    JAX checkpoint tree ``{"step", "params", "batch_stats", "opt_state",
    "epoch"}`` (``opt_state`` only where the state has an optimizer)."""
    variables = seg_variables_from_torch(state["model"], arch, block_layout=block_layout)
    step = int(state.get("step", 0))
    tree = {"step": np.asarray(step, np.int32), **variables}
    if state.get("optimizer") is not None:
        per_param = state["optimizer"]["state"]
        model = state["model"]
        mu, nu = {}, {}
        for i, name in enumerate(names):
            st = per_param.get(i)
            mu[name] = st["exp_avg"] if st else torch.zeros_like(model[name])
            nu[name] = st["exp_avg_sq"] if st else torch.zeros_like(model[name])
        to_tree = lambda m: seg_variables_from_torch(  # noqa: E731
            m, arch, block_layout=block_layout)["params"]
        tree["opt_state"] = adamw_state(variables["params"], step, to_tree(mu), to_tree(nu),
                                        scheduler=scheduler, freeze_backbone=freeze_backbone)
    if "epoch" in state:
        tree["epoch"] = int(state["epoch"])
    return tree


def trainer_state(tree: Mapping[str, Any], arch, names: Sequence[str],
                  param_group: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`checkpoint_tree`: a JAX checkpoint tree (from
    either package) as a trainer's single-card state, the AdamW moments
    indexed by ``names`` with ``param_group``'s settings. A tree without
    an optimizer state gives none; a parameter whose moments are masked in
    the tree gets no state, as a fresh AdamW has none."""
    variables = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {})}
    state: Dict[str, Any] = {"model": seg_state_dict_from_jax(variables, arch),
                             "step": int(np.asarray(tree.get("step", 0))),
                             "epoch": int(tree.get("epoch", 0))}
    found = adamw_moments(tree.get("opt_state"))
    if found is None:
        return state
    count, mu, nu = found
    per_name = [seg_state_dict_from_jax({"params": _fill_masked(m, tree["params"])}, arch)
                for m in (mu, nu)]
    # The JAX package masks the moments of the frozen encoder as a whole.
    frozen = all(leaf is None for leaf in _leaves(mu.get(FROZEN_PREFIX, {}))) \
        and FROZEN_PREFIX in mu
    per_param: Dict[int, Dict[str, torch.Tensor]] = {}
    for i, name in enumerate(names):
        if frozen and name.startswith(FROZEN_PREFIX + "."):
            continue
        per_param[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": per_name[0][name], "exp_avg_sq": per_name[1][name]}
    group = dict(param_group, params=list(range(len(names))))
    state["optimizer"] = {"state": per_param, "param_groups": [group]}
    return state


def _leaves(tree) -> List[Any]:
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def model_variables(model, block_layout: str = "loop") -> Dict[str, Any]:
    """A ``PrithviSeg``'s weights alone as the JAX tree ``{"params",
    "batch_stats"}`` (what ``BestCheckpointer.save`` takes for a model
    without a trainer)."""
    return seg_variables_from_torch(model.state_dict(), model.arch, block_layout=block_layout)


def model_state_dict(state: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """The ``model``'s state dict from a loaded checkpoint of either kind:
    an earlier ``state.pt``'s ``model``, or the JAX tree's parameters and
    statistics, migrated onto the live model's shapes
    (:func:`migrate_param_tree`: a legacy flat qkv is reshaped) in the
    tree's own block layout and bridged (``seg_state_dict_from_jax``)."""
    if "model" in state:
        return state["model"]
    params = state["params"]
    stacked = "blocks" in params.get("prithvi_encoder", {})
    # Shapes only: meta tensors, no copy of the live weights.
    live = {k: torch.empty(v.shape, device="meta") for k, v in model.state_dict().items()}
    ref = seg_variables_from_torch(live, model.arch,
                                   block_layout="scan" if stacked else "loop")
    variables = {"params": migrate_param_tree(params, ref["params"]),
                 "batch_stats": migrate_param_tree(state.get("batch_stats", {}),
                                                   ref["batch_stats"])}
    return seg_state_dict_from_jax(variables, model.arch)
