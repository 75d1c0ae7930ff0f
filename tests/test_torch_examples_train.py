"""The port's training walkthroughs, run as a user runs them, on the CPU.

* the quickstart against ``examples/quickstart.py``, each ``main`` run in
  this process with the run CLI and the map recorded, not run: the
  synthetic dataset's files are the JAX one's byte for byte, and each
  ``run_main`` argv is the JAX one's with ``device=cpu`` added and the
  artifact's name, resolving to the same config through each package's
  ``load_config_from_argv``.
* ``instageo_tpu_torch/examples/quickstart.py --device cpu`` in a fresh
  interpreter: it prints the JAX quickstart's marker; its 3 epochs of 2
  steps complete with finite losses and metrics; chip inference writes one
  prediction per chip; the ``torch.export`` artifact loads in this process
  and gives the checkpoint's model's class ids on a batch; no Hopper kernel
  launches on the CPU.
* ``instageo_tpu_torch/examples/multichip_training.py --device cpu`` under
  ``python -m torch.distributed.run --standalone`` at world 2 (gloo): the
  JAX walkthrough's marker; four placements with their meshes and qkv
  placements; the same loss in each within 1e-5 at the first step (one
  batch, the same weights, other reduction orders) and at the second,
  after each placement's own AdamW step (ZeRO-1's sharded one, TP's and
  FSDP's on their shards); and at a world of one
  (no ``torchrun``) the tensor-parallel placement skipped, said so.

Each run is a process group of its own (``start_new_session``), killed
whole at its time limit, so a hung rank fails the test.
"""

import importlib.util
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
STEP_LOSS_ATOL = 1e-5


def _run(argv, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    assert "Traceback" not in out, out[-4000:]
    return out


def _quickstart_calls(main, root, run_module, viz_module, artifact, monkeypatch):
    """``main``'s ``run_main`` argvs, in order, and the files it leaves in
    ``root``, with the run CLI and the map recorded in place of run."""
    calls = []

    def run_main(argv):
        calls.append(list(argv))
        if argv[0] == "mode=eval":
            return {"test_Acc": 0.0, "test_IoU": 0.0}
        if argv[0] == "mode=export":
            artifact.write_bytes(b"")
            return str(artifact)
        return {}

    monkeypatch.setattr(run_module, "main", run_main)
    monkeypatch.setattr(viz_module, "create_map_with_geotiff_tiles",
                        lambda preds, path, **kw: path)
    main()
    files = {f: (root / f).read_bytes() for f in sorted(os.listdir(root))
             if f != "quickstart_results.json"}
    return calls, files


def test_quickstart_writes_the_jax_dataset_and_resolves_the_jax_configs(tmp_path,
                                                                       monkeypatch):
    from instageo_tpu.apps import viz as jax_viz
    from instageo_tpu.configs import config as jax_config
    from instageo_tpu.train import run as jax_run
    from instageo_tpu_torch.apps import viz as port_viz
    from instageo_tpu_torch.configs import config as port_config
    from instageo_tpu_torch.examples import quickstart as port_quickstart
    from instageo_tpu_torch.train import run as port_run

    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    jax_quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_quickstart)
    root = tmp_path / "demo"
    monkeypatch.setattr(sys, "argv", ["quickstart.py", str(root)])
    jax_calls, jax_files = _quickstart_calls(jax_quickstart.main, root, jax_run, jax_viz,
                                             tmp_path / "jax_artifact", monkeypatch)
    for f in os.listdir(root):
        os.remove(root / f)
    calls, files = _quickstart_calls(lambda: port_quickstart.main([str(root), "--device", "cpu"]),
                                     root, port_run, port_viz, tmp_path / "port_artifact",
                                     monkeypatch)

    assert len(files) == 33 and files == jax_files  # 16 chips, 16 labels, train.csv
    assert [c[0] for c in jax_calls] == ["mode=train", "mode=eval", "mode=chip_inference",
                                         "mode=export"]
    assert len(calls) == len(jax_calls)
    for argv, jax_argv in zip(calls, jax_calls):
        assert [a.replace("predict.pt2", "predict.stablehlo") for a in argv
                if a != "device=cpu"] == jax_argv
        assert argv.count("device=cpu") == 1
        cfg = port_config.load_config_from_argv(argv).to_dict()
        assert cfg.pop("device") == "cpu"
        if "export" in cfg:
            cfg["export"]["path"] = cfg["export"]["path"].replace("predict.pt2",
                                                                  "predict.stablehlo")
        assert cfg == jax_config.load_config_from_argv(jax_argv).to_dict(), argv[0]


def test_quickstart_runs_on_the_cpu(tmp_path):
    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.serve.export import load_predict
    from instageo_tpu_torch.train.factory import create_model

    root = tmp_path / "demo"
    out = _run([sys.executable, "-m", "instageo_tpu_torch.examples.quickstart", str(root),
                "--device", "cpu"])
    assert "map.html in a browser" in out
    results = json.loads((root / "quickstart_results.json").read_text())
    assert results["device"] == "cpu" and set(results["launches"].values()) == {0}
    epochs = [json.loads(line) for line in (root / "run" / "metrics.jsonl").read_text()
              .splitlines()]
    epochs = [e for e in epochs if "epoch" in e]
    assert [e["epoch"] for e in epochs] == [0, 1, 2]
    for e in epochs:
        assert all(math.isfinite(e[k]) for k in ("train_loss", "val_loss", "val_IoU"))
    assert len(results["train_step_losses"]) == 2  # 16 chips, batch 8
    assert all(math.isfinite(v) for v in results["test_metrics"].values())
    assert results["predictions"] == 16 and (root / "map.html").exists()

    predict, meta = load_predict(results["artifact"])
    assert meta["device"] == "cpu" and meta["output"] == "class_ids"
    cfg = load_config("config", overrides={
        "model.model_name": "prithvi_eo_tiny", "model.load_pretrained_weights": False,
        "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
        "checkpoint_path": results["checkpoint"], "device": "cpu"})
    model = create_model(cfg, device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 6, 1, 32, 32))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x).argmax(dim=1)
    got = predict(model.state_dict(), x)
    assert got.shape == (3, 32, 32) and torch.equal(got.long(), want)


def _multichip(out_dir, torchrun: bool):
    argv = [sys.executable, "-m", "instageo_tpu_torch.examples.multichip_training", str(out_dir),
            "--device", "cpu"]
    if torchrun:
        argv[1:3] = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                     "-m", "instageo_tpu_torch.examples.multichip_training"]
    out = _run(argv)
    assert "multichip walkthrough OK" in out
    return out, json.loads((out_dir / "multichip_results.json").read_text())


def test_multichip_walkthrough_at_world_2_on_gloo(tmp_path):
    out, results = _multichip(tmp_path / "mc", torchrun=True)
    placed = results["placements"]
    assert results["world"] == 2 and not results["skipped"]
    assert list(placed) == ["data parallel", "DP + ZeRO-1", "DP x TP(2) + ZeRO-1",
                            "FSDP (ZeRO-3)"]
    assert [p["mode"] for p in placed.values()] == ["dp", "dp", "tp", "fsdp"]
    assert placed["DP x TP(2) + ZeRO-1"]["mesh"] == {"data": 1, "model": 2}
    assert placed["data parallel"]["mesh"] == {"data": 2}
    assert placed["DP + ZeRO-1"]["optimizer"] == "ZeroRedundancyOptimizer"
    assert placed["data parallel"]["qkv_placement"] == "replicated (768, 256)"
    assert placed["DP x TP(2) + ZeRO-1"]["qkv_placement"] == "tp shard (384, 256) of (768, 256)"
    assert placed["FSDP (ZeRO-3)"]["qkv_placement"].startswith("DTensor ('Shard(dim=0)',)")
    dp_losses = placed["data parallel"]["step_losses"]
    for title, p in placed.items():
        assert len(p["step_losses"]) == 2 and math.isfinite(p["train_loss"])
        for step, (loss, dp_loss) in enumerate(zip(p["step_losses"], dp_losses)):
            assert abs(loss - dp_loss) <= STEP_LOSS_ATOL, (title, step)
    assert set(results["launches"].values()) == {0}
    for title in placed:
        assert f"[{title}] mesh=" in out


def test_multichip_walkthrough_alone_is_a_world_of_one(tmp_path):
    out, results = _multichip(tmp_path / "mc", torchrun=False)
    assert results["world"] == 1
    assert list(results["skipped"]) == ["DP x TP(2) + ZeRO-1"]
    assert "needs a world of a multiple of 2 ranks" in out
    assert sorted(results["placements"]) == ["DP + ZeRO-1", "FSDP (ZeRO-3)", "data parallel"]
