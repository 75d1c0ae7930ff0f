"""Run CLI: ``python -m instageo_tpu_torch.train.run --config-name=... mode=...``.

Counterpart of ``instageo_tpu/train/run.py`` with every mode of it and the
same config files, keys, required values and last-line JSON:

* ``stats``: per-band mean/std and class weights of the training chips;
* ``train``: ``train.num_epochs`` epochs with validation, the best
  checkpoint in the run directory (``run_dir``, else
  ``outputs/<date>/<time>``), the resolved config in ``.hydra/``, the
  metrics log, an energy estimate and the model's FLOPs;
* ``eval``: the sliding-window test crops of ``test_filepath`` through a
  checkpoint, with ROC-AUC; with ``model.plot_reg_results`` on a regression
  task, ``regression_test.png`` in the run directory (``train/plots.py``,
  matplotlib);
* ``chip_inference``: one prediction GeoTIFF per chip of ``test_filepath``
  under ``<root_dir>/predictions``;
* ``sliding_inference``: whole granules from a chip-creator dataset JSON
  (``test_filepath``: ``{key: {"granules": [STAC item, ...]}}``, one item
  per timestep, opened by ``test.data_source``: HLS, S2 or S1) through
  ``serve/granule.py``, one ``predictions/prediction_<key>.tif`` each;
* ``export``: the serving forward of ``checkpoint_path``'s model as a
  ``torch.export`` artifact (``serve/export.py``) at ``export.path``
  (``<root_dir>/predict.pt2`` by default), with a symbolic batch unless
  ``export.batch_size`` pins it, class ids or ``export.probabilities``;
* ``replica``: stats → train → eval on the val and test splits → a report
  against the reference's published row (``train/replica.py``).

The run is on ``cuda`` unless the config's top-level ``device`` says
otherwise (``device=cpu``); no config file sets it. Seed 1042, as the
reference.

Under ``torchrun`` (``python -m torch.distributed.run --nproc-per-node N -m
instageo_tpu_torch.train.run ...``) each of the N processes takes a card
and joins the run's process group first (``parallel/multihost.py``), the
mesh comes from ``tpu.*`` (``parallel/mesh.py:mesh_from_config``), and
``train``, ``eval``, ``stats`` and ``chip_inference`` run on it; rank 0
alone writes the run directory, the checkpoints, the logs and the last
line. ``sliding_inference`` and ``export`` write one artifact and run on
rank 0; ``replica`` runs in one process.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from datetime import datetime
from functools import partial
from typing import Any, List, Optional

import torch

from instageo_tpu_torch.configs.config import (
    check_required_flags,
    get_augmentations,
    load_config_from_argv,
    save_config,
)
from instageo_tpu_torch.data.dataloader import (
    InstaGeoDataset,
    create_dataloader,
    eval_collate,
    infer_collate,
    process_and_augment,
    process_test,
)
from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.parallel.multihost import (
    initialize_multihost,
    is_main_process,
    world_size,
)

log = logging.getLogger("instageo_tpu_torch.run")

SEED = 1042
MODES = ("stats", "train", "eval", "chip_inference", "sliding_inference", "export",
         "replica")


def _make_dataset(filepath: str, cfg: Any, preprocess_func, include_filenames=False,
                  seed: Optional[int] = None) -> InstaGeoDataset:
    return InstaGeoDataset(
        filename=filepath,
        input_root=cfg.root_dir,
        preprocess_func=preprocess_func,
        chip_no_data_value=cfg.dataloader.get("no_data_value", -9999) or 0,
        label_no_data_value=cfg.train.get("ignore_index", -100),
        replace_label=(tuple(cfg.dataloader.replace_label)
                       if cfg.dataloader.get("replace_label") else None),
        reduce_to_zero=bool(cfg.dataloader.get("reduce_to_zero", False)),
        constant_multiplier=float(cfg.dataloader.get("constant_multiplier", 1.0)),
        bands=cfg.dataloader.get("bands"),
        include_filenames=include_filenames,
        cache_dir=cfg.dataloader.get("cache_dir"),
        seed=seed,
    )


def _train_preprocess(cfg: Any, augment: bool = True, stats_mode: bool = False):
    mean = [0.0] * len(cfg.dataloader.mean) if stats_mode else list(cfg.dataloader.mean)
    std = [1.0] * len(cfg.dataloader.std) if stats_mode else list(cfg.dataloader.std)
    return partial(
        process_and_augment,
        mean=mean,
        std=std,
        temporal_size=int(cfg.dataloader.get("temporal_dim", 1)),
        im_size=int(cfg.dataloader.get("img_size", 224)),
        label_no_data_value=cfg.train.get("ignore_index", -100),
        chip_no_data_value=cfg.dataloader.get("no_data_value", -9999) or 0,
        max_pixel_value=float(cfg.dataloader.get("max_pixel_value", 10000)),
        augmentations=get_augmentations(cfg) if (augment and not stats_mode) else None,
    )


def _run_dir(cfg: Any) -> str:
    run_dir = cfg.get("run_dir") or os.path.join(
        "outputs", datetime.now().strftime("%Y-%m-%d/%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def main(argv: Optional[List[str]] = None) -> Any:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = load_config_from_argv(argv if argv is not None else sys.argv[1:])
    mode = cfg.get("mode", "train")
    if mode not in MODES:
        raise ValueError(f"Unknown mode {mode!r}")
    device = resolve_device(cfg.get("device"))
    started = not torch.distributed.is_initialized() and initialize_multihost(device.type)
    try:
        if not is_main_process():
            logging.getLogger().setLevel(logging.WARNING)
        log.info("Resolved config:\n%s", cfg.to_yaml())
        if world_size() > 1 and mode in ("sliding_inference", "export", "replica"):
            if mode == "replica":
                raise ValueError("mode=replica runs in one process, not under torchrun")
            if not is_main_process():
                return None
        return _main(cfg, mode, device)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _emit(out: Any) -> None:
    """The last line of the run's output, from rank 0."""
    if is_main_process():
        print(json.dumps(out))


def _main(cfg: Any, mode: str, device: torch.device) -> Any:
    from instageo_tpu_torch.parallel.mesh import mesh_from_config

    start_time = time.time()
    # Building a mesh is collective: only the modes that run on one.
    mesh = (mesh_from_config(cfg.get("tpu")) if mode in ("train", "eval", "chip_inference")
            else None)
    batch_size = int(cfg.train.get("batch_size", 8))
    loader = partial(create_dataloader, num_workers=int(cfg.dataloader.get("num_workers", 1)),
                     worker_mode=str(cfg.dataloader.get("worker_mode", "thread")),
                     prefetch_depth=int((cfg.get("tpu") or {}).get("prefetch_depth", 2)),
                     seed=SEED, device=device)

    if mode == "stats":
        from instageo_tpu_torch.train.stats import compute_stats

        check_required_flags(["root_dir", "train_filepath"], cfg)
        ds = _make_dataset(cfg.train_filepath, cfg, _train_preprocess(cfg, stats_mode=True),
                           seed=SEED)
        mean, std, class_weights = compute_stats(
            loader(ds, batch_size, shuffle=True), cfg.get("is_reg_task", False),
            ignore_index=int(cfg.train.get("ignore_index", -1)))
        out = {"mean": mean, "std": std, "class_weights": class_weights}
        _emit(out)
        return out

    if mode == "replica":
        # Each stage re-enters this main through the saved .hydra config.
        from instageo_tpu_torch.train.replica import run_replica

        return run_replica(cfg)

    from instageo_tpu_torch.train.factory import build_teacher, create_model
    from instageo_tpu_torch.train.trainer import Trainer

    is_reg = bool(cfg.get("is_reg_task", False))

    if mode == "train":
        check_required_flags(["root_dir", "train_filepath", "valid_filepath"], cfg)
        from instageo_tpu_torch.train.checkpointing import BestCheckpointer
        from instageo_tpu_torch.utils.experiment_logger import init_experiment_logger
        from instageo_tpu_torch.utils.telemetry import (
            EmissionsTracker,
            count_params,
            get_model_complexity,
            profile_trace,
            rank_footprint,
        )

        model = create_model(cfg, seed=SEED, device=device, training=True)
        main_process = is_main_process()
        run_dir = _run_dir(cfg) if main_process else None
        if main_process:
            save_config(cfg, run_dir)
        train_ds = _make_dataset(cfg.train_filepath, cfg, _train_preprocess(cfg), seed=SEED)
        val_ds = _make_dataset(cfg.valid_filepath, cfg, _train_preprocess(cfg, augment=False),
                               seed=SEED)
        train_loader = loader(train_ds, batch_size, shuffle=True)
        val_loader = loader(val_ds, batch_size)
        teacher = None
        if cfg.train.get("distillation") and cfg.train.get("teacher_ckpt_path"):
            teacher = build_teacher(cfg, str(cfg.train.teacher_ckpt_path), device)
        trainer = Trainer(cfg, model, device=device, teacher=teacher,
                          steps_per_epoch=max(1, len(train_loader)), mesh=mesh)
        resume_from = cfg.get("resume_from")
        if resume_from:
            # Step, epoch, optimizer moments and best_metric go on, unlike
            # checkpoint_path, which loads weights only.
            trainer.restore(str(resume_from))
            train_loader.sampler.epoch = val_loader.sampler.epoch = trainer.epoch
            log.info("Resumed training state from %s (step %d)", resume_from, trainer.step)
        # Rank 0 writes; every rank trains (and gathers the checkpoints).
        ckpt = BestCheckpointer(run_dir) if main_process else None
        exp_logger = init_experiment_logger(cfg, run_dir) if main_process else None
        if exp_logger is not None:
            exp_logger.log_config(cfg)
        tracker = EmissionsTracker(name="train", output_dir=run_dir)
        tracker.start()
        profile = bool((cfg.get("tpu") or {}).get("profile", False)) and main_process
        with profile_trace(os.path.join(run_dir or ".", "profile"), enabled=profile):
            history = trainer.fit(
                lambda: iter(train_loader), lambda: iter(val_loader),
                checkpointer=ckpt, seed=SEED,
                log_fn=exp_logger and (lambda m: exp_logger.log_metrics(m, step=m.get("epoch"))))
        carbon = tracker.stop()
        duration = time.time() - start_time
        footprints = [rank_footprint(model, trainer.optimizer, history)]
        if world_size() > 1:
            footprints = [None] * world_size()
            torch.distributed.all_gather_object(
                footprints, rank_footprint(model, trainer.optimizer, history))
        c = int(model.arch.in_chans)
        t = int(cfg.dataloader.get("temporal_dim", 1))
        s = int(cfg.dataloader.get("img_size", 224))
        x = torch.zeros((1, c, t, s, s), device=device)
        # A tensor- or pipeline-parallel rank holds part of the model.
        whole = trainer.mode in ("single", "dp", "fsdp")
        complexity = get_model_complexity(model, x) if whole else {"flops": None, "gflops": None}
        complexity["params"] = count_params(model) if whole else None
        if exp_logger is not None:
            exp_logger.log_metrics({**complexity, "train_duration_s": duration, **carbon,
                                    "ranks": footprints, "placement": trainer.mode})
            exp_logger.stop()
            log.info("Model complexity: %s GFLOPs/forward, %s params",
                     complexity["gflops"], complexity["params"])
            log.info("Training completed in %.1fs; best %s; checkpoint: %s",
                     duration, trainer.best_metric, ckpt.path)
        del train_loader, val_loader  # stops their worker processes
        _emit({k: v for k, v in history.items() if isinstance(v, (int, float))})
        return history

    if mode == "export":
        from instageo_tpu_torch.serve.export import export_predict

        check_required_flags(["root_dir", "checkpoint_path"], cfg)
        model = create_model(cfg, seed=SEED, device=device)
        exp = cfg.get("export") or {}
        out_path = str(exp.get("path") or os.path.join(cfg.root_dir, "predict.pt2"))
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        bs = exp.get("batch_size")
        export_predict(
            model, out_path, num_bands=int(model.arch.in_chans),
            img_size=int(cfg.dataloader.get("img_size", 224)),
            temporal_dim=int(cfg.dataloader.get("temporal_dim", 1)), is_reg_task=is_reg,
            probabilities=bool(exp.get("probabilities", False)),
            batch_size=None if bs in (None, "null") else int(bs))
        _emit({"artifact": out_path, "bytes": os.path.getsize(out_path),
               "seconds": time.time() - start_time})
        return out_path

    check_required_flags(["root_dir", "test_filepath", "checkpoint_path"], cfg)
    model = create_model(cfg, seed=SEED, device=device)

    if mode == "eval":
        # The JAX CLI reads the key only in eval.
        plot_reg = is_reg and bool(cfg.model.get("plot_reg_results", False))
        if plot_reg:
            from instageo_tpu_torch.train.plots import (
                create_regression_plot,
                require_matplotlib,
            )

            require_matplotlib()  # refused before the evaluation, not after it
        img_size = int(cfg.test.get("img_size", 512))
        crop_size = int(cfg.test.get("crop_size", 224))
        stride = int(cfg.test.get("stride", 224))
        test_pre = partial(
            process_test,
            mean=list(cfg.dataloader.mean),
            std=list(cfg.dataloader.std),
            temporal_size=int(cfg.dataloader.get("temporal_dim", 1)),
            img_size=img_size, crop_size=crop_size, stride=stride,
        )
        test_loader = loader(_make_dataset(cfg.test_filepath, cfg, test_pre), batch_size,
                             collate_fn=eval_collate)
        trainer = Trainer(cfg, model, device=device, mesh=mesh)
        # The eval batch is the loader's batch times each image's crops.
        crops = max(1, (img_size - crop_size) // stride + 1) ** 2
        metrics = trainer.run_eval_epoch(iter(test_loader), batch_size * crops, "test",
                                         collect_outputs=plot_reg)
        del test_loader
        if plot_reg and "_preds" in metrics and is_main_process():
            out_png = os.path.join(_run_dir(cfg), "regression_test.png")
            create_regression_plot(metrics.pop("_preds"), metrics.pop("_labels"), metrics,
                                   out_png, "test")
            log.info("Regression plot written to %s", out_png)
        metrics.pop("_preds", None)
        metrics.pop("_labels", None)
        log.info("Evaluation took %.1fs", time.time() - start_time)
        _emit(metrics)
        return metrics

    if mode == "sliding_inference":
        return _sliding_inference(cfg, model, batch_size)

    from instageo_tpu_torch.serve.infer import chip_inference
    from instageo_tpu_torch.serve.server import place_for_serving, serving_shard

    place_for_serving(model, mesh)
    shard, writes = serving_shard(mesh)
    out_dir = os.path.join(cfg.root_dir, "predictions")
    # The centre crop: save_prediction anchors the raster at the chip's
    # centre window.
    infer_pre = partial(_train_preprocess(cfg, augment=False), crop="center")
    infer_loader = loader(_make_dataset(cfg.test_filepath, cfg, infer_pre,
                                        include_filenames=True),
                          batch_size, collate_fn=infer_collate)
    n, dt = chip_inference(infer_loader, out_dir, model, is_reg_task=is_reg, shard=shard,
                           write=writes)
    del infer_loader
    if world_size() > 1:  # the chips the ranks wrote, the slowest rank's seconds
        shares = [None] * world_size()
        torch.distributed.all_gather_object(shares, (n if writes else 0, dt))
        n, dt = sum(c for c, _ in shares), max(t for _, t in shares)
    _emit({"chips": n, "seconds": dt, "chips_per_sec": n / dt if dt else 0.0})
    return n


def _sliding_inference(cfg: Any, model, batch_size: int) -> int:
    """Stream each granule of the dataset JSON through ``serve/granule.py``;
    logs each granule's decode, copy and device seconds."""
    from instageo_tpu_torch.data.sources import hls, s1, s2
    from instageo_tpu_torch.serve.granule import granule_inference_to_file

    openers = {"HLS": hls.open_hls_stac_items,
               "S2": s2.open_s2_stac_items,
               "S1": s1.open_s1_stac_items}
    source = str(cfg.test.get("data_source", "HLS")).upper()
    with open(cfg.test_filepath) as f:
        dataset = json.load(f)
    out_dir = os.path.join(cfg.root_dir, "predictions")
    os.makedirs(out_dir, exist_ok=True)
    start_time = time.time()
    n = 0
    for key, tile_dict in dataset.items():
        t0 = time.perf_counter()
        bands, _masks, transform, crs = openers[source](tile_dict, load_masks=False)
        decode_s = time.perf_counter() - t0
        safe = key.replace("/", "_")[:128]
        stats = {}
        granule_inference_to_file(
            bands,
            os.path.join(out_dir, f"prediction_{safe}.tif"),
            model,
            mean=list(cfg.dataloader.mean), std=list(cfg.dataloader.std),
            transform=transform, crs=crs,
            chip_size=int(cfg.dataloader.get("img_size", 224)),
            temporal_size=int(cfg.dataloader.get("temporal_dim", 1)),
            bands=cfg.dataloader.get("bands"),
            constant_multiplier=float(cfg.dataloader.get("constant_multiplier", 1.0)),
            is_reg_task=bool(cfg.get("is_reg_task", False)),
            batch_size=batch_size,
            no_data_value=cfg.dataloader.get("no_data_value", -9999) or 0,
            stats=stats,
        )
        log.info("granule %s: %d chips in %d batches; decode %.3f s, to the device %.3f s, "
                 "device %s s (first batch %.3f s), wall %.3f s", key, stats["chips"],
                 stats["batches"], decode_s, stats["h2d_s"], stats["device_s"],
                 stats["first_batch_s"], time.perf_counter() - t0)
        n += 1
    dt = time.time() - start_time
    _emit({"granules": n, "seconds": dt, "out_dir": out_dir})
    return n


if __name__ == "__main__":
    main()
