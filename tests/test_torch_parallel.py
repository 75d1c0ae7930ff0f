"""The port's ``parallel/`` against the JAX package's, on the CPU with gloo.

Each world is one spawned run of ``WORKER`` per rank (``subprocess`` with
a timeout; the workers import no JAX, not even ``tests/conftest.py``, and
rendezvous through a file under ``tmp_path``), which runs every mode of
that world in turn on the tiny model (``prithvi_eo_tiny``: 4 heads, depth
4; 32 px, float32, batch 8, two optimizer steps) from the JAX model's
weights (``seg_state_dict_from_jax``), head dropout off:

* world 2: data parallelism, ZeRO-1, FSDP (with ZeRO-1 and
  ``steps_per_call: 2``), remat and pipeline parallelism (pp 2, 2
  micro-batches); world 4: tensor parallelism (2 × 2, with ZeRO-1) and
  sequence parallelism (2 × 2);
* each mode's per-step losses are held to the JAX ``Trainer``'s on the
  matching mesh (``make_mesh(2)``, ``make_mesh_2d(tp=2, num_devices=4)``,
  ``make_mesh_pp(2, 2)``) at rtol 1e-4, the JAX tests' own tolerance
  (``tests/model_tests/test_parallel.py``); the BatchNorm running statistics
  after the first step at ``BN_TOL`` (float32 through the head, other
  summation orders) and that step's confusion matrix exactly;
* with head dropout on, world 2's losses equal the port's own world-1 run
  at the same tolerance: each rank draws its rows' masks of the whole batch;
* the port's own collectives are counted as ``test_collective_audit.py``
  counts the JAX schedule's: 2 all-reduces per block in the tensor-parallel
  forward; 2 all-gathers (and the one after the last block) and 2
  reduce-scatters per block under sequence parallelism; under pipeline
  parallelism one hand-off per stage boundary per micro-batch, each way;
* a checkpoint written at world 2 (FSDP) loads at world 1 and gives the
  same logits.

The placement rules (``fsdp_spec_for``, ``tp_spec_for_path``) are held to
the JAX ones leaf for leaf, and the factory's rejections to the JAX
factory's.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.models.prithvi import stack_block_params
from instageo_tpu.models.seg import TPUDropout
from instageo_tpu.parallel.fsdp import fsdp_spec_for as jax_fsdp_spec_for
from instageo_tpu.parallel.mesh import make_mesh, zero1_shardable as jax_zero1_shardable
from instageo_tpu.parallel.pp import make_mesh_pp
from instageo_tpu.parallel.tp import make_mesh_2d, tp_specs
from instageo_tpu.train.factory import create_model as jax_create_model
from instageo_tpu.train.trainer import EpochMetrics as JaxEpochMetrics
from instageo_tpu.train.trainer import Trainer as JaxTrainer
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.seg import Dropout
from instageo_tpu_torch.parallel.fsdp import fsdp_spec_for
from instageo_tpu_torch.parallel.mesh import shard_batch, shard_stacked_batch, zero1_shardable
from instageo_tpu_torch.parallel.multihost import host_local_to_global
from instageo_tpu_torch.parallel.pp import pp_specs
from instageo_tpu_torch.parallel.tp import tp_spec_for_path
from instageo_tpu_torch.train import factory
from instageo_tpu_torch.train.checkpointing import load_checkpoint
from instageo_tpu_torch.train.trainer import Trainer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# One rank: ``python worker.py <world> <rank> <dir>`` joins the group through
# ``file://<dir>/rendezvous``, reads ``<dir>/case.pt`` (the weights, the
# batches, the overrides, the modes), runs each mode on its mesh and, on
# rank 0, writes ``<dir>/results.pt``.
WORKER = r'''
import os
import sys

import torch
import torch.distributed as dist

from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.seg import Dropout
from instageo_tpu_torch.parallel import mesh as pmesh
from instageo_tpu_torch.parallel.multihost import initialize_multihost
from instageo_tpu_torch.train.checkpointing import BestCheckpointer, load_checkpoint, trainer_state
from instageo_tpu_torch.train.factory import build_model
from instageo_tpu_torch.train.trainer import EpochMetrics, Trainer

torch.set_num_threads(1)


def _counts_over_world() -> dict:
    counts = pmesh.read_collectives()
    t = torch.tensor([counts[k] for k in sorted(counts)], dtype=torch.int64)
    dist.all_reduce(t)
    return dict(zip(sorted(counts), t.tolist())), counts


def make_trainer(spec: dict, case: dict):
    cfg = load_config("config", overrides={**case["overrides"], **spec["overrides"]})
    model = build_model(cfg, device="cpu", training=True)
    model.load_state_dict(case["state"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = spec.get("dropout", 0.0)
    mesh = pmesh.mesh_from_config(cfg.get("tpu"))
    return model, Trainer(cfg, model, device="cpu", mesh=mesh)


def run_mode(name: str, spec: dict, case: dict, root: str) -> dict:
    model, trainer = make_trainer(spec, case)
    out = {"mode": trainer.mode}
    batches = case["batches"]
    if spec.get("count"):
        x_local = trainer._host_batch(*batches[0], 8, accum=1)[0]
        pmesh.reset_collectives()
        with torch.no_grad():
            model.eval()(x_local)
        out["forward_counts"], out["forward_counts_rank0"] = _counts_over_world()
        pmesh.reset_collectives()
    gen = torch.Generator().manual_seed(0)
    losses: list = []
    if spec.get("cm"):  # the first step on its own, for its confusion matrix
        metrics = EpochMetrics(2, torch.device("cpu"))
        trainer._run_train_steps(batches[:1], gen, 8, metrics, losses)
        trainer._finalize(metrics, "train")
        out["cm"] = metrics.cm.matrix.clone()
        out["bn"] = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        trainer.run_train_epoch(iter(batches[1:]), gen, 8, losses)
    else:
        trainer.run_train_epoch(iter(batches), gen, 8, losses)
    out["losses"] = [float(v) for v in losses]
    if spec.get("count"):
        out["train_counts"], _ = _counts_over_world()
    if spec.get("checkpoint"):
        state = trainer.state_dict()
        names = trainer._single_card_names()
        with torch.no_grad():
            out["probe_logits"] = model.eval()(case["probe"])
        if dist.get_rank() == 0:
            path = BestCheckpointer(root, name).save(state)
            # The saved optax moments in the single-card AdamW's format.
            group = {"lr": float(trainer.optimizer.param_groups[0]["lr"])}
            out["optimizer"] = trainer_state(load_checkpoint(path), model.arch, names,
                                             group)["optimizer"]
        dist.barrier()
        # The run resumed from its checkpoint takes the step the run takes.
        _, resumed = make_trainer(spec, case)
        resumed.restore(os.path.join(root, name))
        for key, t in (("next", trainer), ("resumed_next", resumed)):
            out[key] = []
            t.run_train_epoch(iter(batches[:1]), torch.Generator().manual_seed(1), 8, out[key])
            out[key] = [float(v) for v in out[key]]
    return out


def main() -> None:
    world, rank, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    case = torch.load(os.path.join(root, "case.pt"), weights_only=False)
    initialize_multihost("cpu", init_method=f"file://{root}/rendezvous",
                         world_size=world, rank=rank)
    results = {name: run_mode(name, spec, case, root) for name, spec in case["modes"].items()}
    if rank == 0:
        torch.save(results, os.path.join(root, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
'''
LOSS_RTOL = 1e-4
# Of the largest moment: the entries that are rounding noise (a bias before
# a BatchNorm has no gradient in exact arithmetic) follow the summation
# order, up to 1.2e-6 of it under pp.
MOMENT_ATOL = 1e-5
BN_TOL = 1e-5
DEPTH = 4
OVERRIDES = {
    "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
    "model.model_name": "prithvi_eo_tiny", "model.load_pretrained_weights": False,
    "train.batch_size": 8, "train.ignore_index": -1, "tpu.precision": "f32",
    "tpu.donate_state": False,
}
WORLD2 = {
    "dp": {"overrides": {}, "cm": True, "checkpoint": True},
    "zero1": {"overrides": {"tpu.zero1": True}, "checkpoint": True},
    "fsdp": {"overrides": {"tpu.fsdp": True, "tpu.zero1": True, "tpu.steps_per_call": 2},
             "checkpoint": True},
    "remat": {"overrides": {"tpu.remat": True}},
    "pp": {"overrides": {"tpu.pp": 2, "tpu.pp_microbatches": 2}, "count": True,
           "checkpoint": True},
    "dropout": {"overrides": {}, "dropout": 0.1},
}
WORLD4 = {
    "tp": {"overrides": {"tpu.tp": 2, "tpu.zero1": True}, "count": True, "checkpoint": True},
    "sp": {"overrides": {"tpu.tp": 2, "tpu.sp": True}, "count": True},
}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, TPUDropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope="module")
def case():
    """The JAX model's weights, two batches (the first rows mostly ignored,
    so the ranks' valid counts differ) and a probe input."""
    cfg = jax_load_config("config", overrides=OVERRIDES)
    _, variables = jax_create_model(cfg)
    variables = jax.tree.map(np.asarray, variables)
    port_cfg = load_config("config", overrides=OVERRIDES)
    state = seg_state_dict_from_jax(variables, factory._arch(port_cfg))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(2):
        x = rng.normal(size=(8, 6, 1, 32, 32)).astype(np.float32)
        y = rng.integers(0, 2, size=(8, 32, 32)).astype(np.int32)
        y[:3, :20] = -1
        batches.append((x, y))
    probe = torch.from_numpy(rng.normal(size=(4, 6, 1, 32, 32)).astype(np.float32))
    return {"variables": variables, "state": state, "batches": batches, "probe": probe}


def _spawn(world: int, modes: dict, case: dict, tmp_path) -> dict:
    root = tmp_path / f"world{world}"
    root.mkdir()
    torch.save({"state": case["state"], "batches": case["batches"], "probe": case["probe"],
                "overrides": OVERRIDES, "modes": modes}, root / "case.pt")
    (root / "worker.py").write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(root / "worker.py"), str(world), str(r),
                               str(root)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return torch.load(root / "results.pt", weights_only=False)


@pytest.fixture(scope="module")
def world2(case, tmp_path_factory):
    return _spawn(2, WORLD2, case, tmp_path_factory.mktemp("parallel")), \
        tmp_path_factory.getbasetemp()


@pytest.fixture(scope="module")
def world4(case, tmp_path_factory):
    return _spawn(4, WORLD4, case, tmp_path_factory.mktemp("parallel"))


def _jax_run(case, extra: dict, mesh, stacked: bool = False):
    """Per-step losses, and the first step's confusion matrix (exact
    counts) and batch stats, of the JAX Trainer on ``mesh``. (The stats
    are held after one step, as ``test_torch_train.py`` holds them: a
    second step reads parameters that Adam moved by up to ±lr where a
    gradient is rounding noise.)"""
    cfg = jax_load_config("config", overrides={**OVERRIDES, **extra})
    model, _ = jax_create_model(cfg)
    variables = case["variables"]
    if stacked:
        params = dict(variables["params"])
        params["prithvi_encoder"] = stack_block_params(params["prithvi_encoder"], DEPTH)
        variables = {**variables, "params": params}
    trainer = JaxTrainer(cfg, model, variables, mesh=mesh)
    losses, cm, batch_stats = [], None, None
    with fnn.intercept_methods(_no_dropout):
        for i, (x, y) in enumerate(case["batches"]):
            trainer.state, m = trainer._train_step(
                trainer.state, *trainer._prepare(x, y, 8), jax.random.PRNGKey(i),
                JaxEpochMetrics.empty(2))
            losses.append(float(m.loss_sum))
            if cm is None:
                cm = (np.asarray(m.cm.matrix, np.float64)
                      + np.asarray(m.cm.matrix_lo, np.float64))
                batch_stats = jax.tree.map(np.asarray, trainer.state.batch_stats)
    return losses, cm, batch_stats


@pytest.fixture(scope="module")
def jax_dp(case):
    return _jax_run(case, {}, make_mesh(2))


@pytest.mark.parametrize("mode", ["dp", "zero1", "fsdp", "remat"])
def test_data_parallel_modes_match_jax(world2, jax_dp, case, mode):
    results, _ = world2
    losses, cm, batch_stats = jax_dp
    np.testing.assert_allclose(results[mode]["losses"], losses, rtol=LOSS_RTOL)
    if mode == "dp":
        np.testing.assert_array_equal(results[mode]["cm"].numpy(), cm)
        ref = seg_state_dict_from_jax({"params": case["variables"]["params"],
                                       "batch_stats": batch_stats},
                                      factory._arch(load_config("config", overrides=OVERRIDES)))
        for name, value in results[mode]["bn"].items():
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=name)
    assert results[mode]["mode"] == ("fsdp" if mode == "fsdp" else "dp")


def test_pipeline_matches_jax(world2, case):
    results, _ = world2
    losses, _, _ = _jax_run(case, {"tpu.pp": 2, "tpu.pp_microbatches": 2},
                            make_mesh_pp(2, 2), stacked=True)
    res = results["pp"]
    assert res["mode"] == "pp"
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
    # One hand-off per stage boundary per micro-batch: 2 in the forward, 2
    # more in the backward of each step.
    assert res["forward_counts"]["p2p"] == 1 * 2
    assert res["train_counts"]["p2p"] == 2 * (2 * 1 * 2)


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_tensor_and_sequence_parallel_match_jax(world4, case, mode):
    extra = {"tpu.tp": 2, "tpu.zero1": True} if mode == "tp" else {"tpu.tp": 2, "tpu.sp": True}
    losses, _, _ = _jax_run(case, extra, make_mesh_2d(tp=2, num_devices=4))
    res = world4[mode]
    assert res["mode"] == ("tp" if mode == "tp" else "tp+sp")
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL)
    counts = res["forward_counts_rank0"]
    if mode == "tp":
        assert counts == {"all_reduce": 2 * DEPTH, "all_gather": 0, "reduce_scatter": 0,
                          "p2p": 0}
    else:
        assert counts == {"all_reduce": 0, "all_gather": 2 * DEPTH + 1,
                          "reduce_scatter": 2 * DEPTH, "p2p": 0}


def _world1_losses(case, dropout: float):
    cfg = load_config("config", overrides=OVERRIDES)
    model = factory.build_model(cfg, device="cpu", training=True)
    model.load_state_dict(case["state"])
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = dropout
    losses: list = []
    trainer = Trainer(cfg, model, device="cpu")
    trainer.run_train_epoch(iter(case["batches"]), torch.Generator().manual_seed(0), 8, losses)
    return [float(v) for v in losses], trainer


def test_world2_equals_world1_with_dropout(world2, case):
    results, _ = world2
    ref, _ = _world1_losses(case, 0.1)
    no_drop, _ = _world1_losses(case, 0.0)
    np.testing.assert_allclose(results["dropout"]["losses"], ref, rtol=LOSS_RTOL)
    assert abs(ref[1] - no_drop[1]) > 1e-3  # the dropout masks mattered


def test_checkpoint_from_world2_loads_at_world1(world2, case, tmp_path):
    results, base = world2
    path = next(base.glob("parallel*/world2/fsdp"))
    cfg = load_config("config", overrides=OVERRIDES)
    model = factory.build_model(cfg, device="cpu", training=True)
    trainer = Trainer(cfg, model, device="cpu")
    trainer.restore(str(path))  # the single-card run's tree
    assert trainer.step == 2 and len(trainer.optimizer.state) == len(list(model.parameters()))
    with torch.no_grad():
        logits = model.eval()(case["probe"])
    torch.testing.assert_close(logits, results["fsdp"]["probe_logits"], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def world1_optimizer(case):
    return _world1_losses(case, 0.0)[1].optimizer.state_dict()


@pytest.mark.parametrize("world,mode", [(2, "dp"), (2, "zero1"), (2, "fsdp"), (2, "pp"),
                                        (4, "tp")])
def test_checkpoint_holds_the_moments_and_resumes(world2, world4, world1_optimizer, world,
                                                   mode):
    """A mesh run's checkpoint holds the single-card AdamW state (ZeRO-1's
    shares, the stages' blocks and the tensor-parallel shards gathered): the
    world-1 run's after the same two steps, index for index; the run
    resumed from it takes the next step as the run itself does, bit for
    bit."""
    res = world2[0][mode] if world == 2 else world4[mode]
    assert res["resumed_next"] == res["next"]
    ours, ref = res["optimizer"], world1_optimizer
    assert set(ours["state"]) == set(ref["state"])
    for key in ("exp_avg", "exp_avg_sq"):
        top = max(float(st[key].abs().max()) for st in ref["state"].values())
        for i, st in ref["state"].items():
            assert float(ours["state"][i]["step"]) == float(st["step"]) == 2
            torch.testing.assert_close(ours["state"][i][key], st[key], rtol=LOSS_RTOL,
                                       atol=MOMENT_ATOL * top, msg=f"{mode} {i} {key}")
    assert ours["param_groups"][0]["params"] == ref["param_groups"][0]["params"]
    assert ours["param_groups"][0]["lr"] == ref["param_groups"][0]["lr"]


def test_fsdp_spec_rule_matches_jax(case):
    model = factory.build_model(load_config("config", overrides=OVERRIDES), device="cpu",
                                training=True)
    shapes = [tuple(p.shape) for p in model.parameters()] + [
        (64, 2048), (3, 3, 256, 128), (3,), (257, 509), (1280, 5120), (5120, 1280)]
    for n in (1, 2, 4, 8):
        for shape in shapes:
            spec = jax_fsdp_spec_for(np.zeros(shape, np.int8), n)
            dim = fsdp_spec_for(shape, n)
            assert (dim is None and spec == jax.sharding.PartitionSpec()) or \
                (dim is not None and spec[dim] == "data"), (shape, n, spec, dim)
            x = np.zeros(shape, np.int8)
            assert zero1_shardable(x, n) == jax_zero1_shardable(x, n)


def _torch_spec(jax_path: str, spec) -> tuple:
    """A JAX block leaf's PartitionSpec in the torch parameter's layout."""
    if jax_path.endswith("qkv/kernel"):  # (D, 3, H, Dh) -> view (3, H, Dh, D)
        spec = tuple(spec) + (None,) * (4 - len(spec))
        return (spec[1], spec[2], spec[3], spec[0])
    if jax_path.endswith("kernel") and len(spec) > 0:  # (in, out) -> (out, in)
        spec = tuple(spec) + (None,) * (2 - len(spec))
        return (spec[1], spec[0])
    return tuple(spec)


def test_tp_spec_rule_matches_jax(case):
    specs = tp_specs(case["variables"]["params"])
    jax_specs = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)):
        keys = [getattr(k, "key", str(k)) for k in path]
        jax_specs["/".join(keys)] = spec
    model = factory.build_model(load_config("config", overrides=OVERRIDES), device="cpu")
    seen = 0
    for name, _ in model.named_parameters():
        ours = tp_spec_for_path(name)
        parts = name.split(".")
        if parts[:2] == ["prithvi_encoder", "blocks"]:
            leaf = {"weight": "scale" if parts[-2].startswith("norm") else "kernel",
                    "bias": "bias"}[parts[-1]]
            path = "/".join(["prithvi_encoder", f"blocks_{parts[2]}", *parts[3:-1], leaf])
            ref = jax_specs[path]
            if ref == jax.sharding.PartitionSpec():
                assert ours == (), name
            else:
                assert ours == _torch_spec(path, ref), (name, ref)
                seen += 1
        else:
            assert ours == (), name
    assert seen == 6 * DEPTH  # qkv, fc1 (weight and bias), proj and fc2 weights
    assert all(s == jax.sharding.PartitionSpec() for p, s in jax_specs.items()
               if "/blocks_" not in p)


def test_shard_batch_is_the_data_axis_split():
    class FakeMesh:
        mesh_dim_names = ("data",)

        def __init__(self, rank):
            self.rank = rank

        def size(self, dim=None):
            return 2

        def get_local_rank(self, axis):
            return self.rank

    x = np.arange(8)
    assert shard_batch(x, FakeMesh(1)).tolist() == [4, 5, 6, 7]
    # grad_accum 2: rank 1 takes the second half of each micro-batch.
    assert shard_batch(x, FakeMesh(1), accum=2).tolist() == [2, 3, 6, 7]
    assert host_local_to_global((x, x), FakeMesh(0), 2)[1].tolist() == [0, 1, 4, 5]
    assert shard_batch(x, None).tolist() == list(range(8))
    # (k, B, ...) stacks split their second axis.
    assert shard_stacked_batch(np.arange(16).reshape(2, 8), FakeMesh(1)).tolist() == [
        [4, 5, 6, 7], [12, 13, 14, 15]]


def test_pp_specs_put_the_blocks_on_the_pipe():
    """The JAX rule (``parallel/pp.py:pp_specs``): the blocks on ``pipe``,
    everything else on every stage."""
    model = factory.build_model(load_config("config", overrides=OVERRIDES), device="cpu")
    specs = pp_specs(model)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    assert {n for n, s in specs.items() if s == "pipe"} == {
        n for n, _ in model.named_parameters() if n.startswith("prithvi_encoder.blocks.")}


@pytest.mark.parametrize("bad,match", [
    ({"tpu.sp": True}, "requires tpu.tp"),
    ({"tpu.pp": 2, "tpu.tp": 2}, "mutually exclusive"),
])
def test_factory_rejects_what_jax_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        factory.build_model(load_config("config", overrides={**OVERRIDES, **bad}),
                            device="cpu")


def _cli_chips(root) -> None:
    """Eight 32 px chips and their labels, as ``test_torch_run.py`` writes them."""
    import csv

    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
        lab = np.repeat(np.repeat(rng.choice([0, 1], size=(2, 2)), 16, 0), 16, 1).astype(np.int16)
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


def test_run_cli_under_torchrun_equals_one_process(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    instageo_tpu_torch.train.run`` (gloo, FSDP + ZeRO-1, two grouped steps):
    rank 0 alone writes the run directory, and each step's loss is the
    one-process run's; then ``mode=chip_inference`` at world 2 writes and
    counts every chip."""
    import json

    from instageo_tpu_torch.train import run

    _cli_chips(tmp_path)
    csv_path = str(tmp_path / "chips.csv")
    args = ["mode=train", "device=cpu", f"root_dir={tmp_path}", f"train_filepath={csv_path}",
            f"valid_filepath={csv_path}", "model.model_name=prithvi_eo_tiny",
            "model.load_pretrained_weights=False", "model.depth=2", "dataloader.img_size=32",
            "dataloader.bands=[0,1,2,3,4,5]", "dataloader.no_data_value=0",
            "dataloader.num_workers=0", "dataloader.mean=[5000,5000,5000,5000,5000,5000]",
            "dataloader.std=[3000,3000,3000,3000,3000,3000]", "train.ignore_index=-1",
            "train.batch_size=4", "train.num_epochs=1", "train.learning_rate=0.002",
            "tpu.precision=f32"]
    one = run.main(args + [f"run_dir={tmp_path / 'one'}"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "instageo_tpu_torch.train.run", *args, f"run_dir={tmp_path / 'two'}",
         "tpu.fsdp=True", "tpu.zero1=True", "tpu.steps_per_call=2", "tpu.mesh=2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])  # rank 0's line alone
    with open(tmp_path / "two" / "metrics.jsonl") as f:
        two = json.loads(f.readline())
    np.testing.assert_allclose(two["train_step_losses"], one["train_step_losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(last["train_loss"], one["train_loss"], rtol=LOSS_RTOL)
    two = load_checkpoint(str(tmp_path / "two" / "instageo_best_checkpoint"))
    one = load_checkpoint(str(tmp_path / "one" / "instageo_best_checkpoint"))
    assert jax.tree.structure(two) == jax.tree.structure(one)
    # chip_inference at world 2: each rank writes its rows; the last line
    # counts the chips of both.
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "instageo_tpu_torch.train.run", *args, "mode=chip_inference",
         f"test_filepath={csv_path}",
         f"checkpoint_path={tmp_path / 'two' / 'instageo_best_checkpoint'}"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["chips"] == 8
    assert len(list((tmp_path / "predictions").glob("t_*_prediction.tif"))) == 8
