"""One-command replication runbook (``mode=replica``).

Counterpart of ``instageo_tpu/train/replica.py``: dataset stats → fine-tune
→ val/test evaluation → a report against the reference's published row, in
one CLI call::

    python -m instageo_tpu_torch.train.run --config-name=sen1floods11 \\
        mode=replica root_dir=... train_filepath=... valid_filepath=... \\
        test_filepath=...

Every stage re-enters :func:`instageo_tpu_torch.train.run.main` through the
saved ``.hydra/config.yaml``, so the replica runs the CLI a user runs. The
stages share one decoded-chip cache (``dataloader.cache_dir``) unless
``replica.chip_cache`` is false or the config names its own. Outputs land
in ``run_dir``:

* ``report.json``: the stages' results and the deltas to the reference;
* ``REPORT.md``: the table row beside the reference's published row.

Pretrained weights must exist locally (``model.pretrained_path`` or
``$PRITHVI_PRETRAINED_PATH``) unless ``replica.require_pretrained=False``
(synthetic fixtures replicate from a fresh init).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch

log = logging.getLogger(__name__)

# The reference README table's rows, in percent, keyed by ``replica.task``
# (set in the task configs); the metric keys are the trainer's eval outputs.
REFERENCE_TARGETS: Dict[str, Dict[str, Any]] = {
    "sen1floods11": {
        "task": "Flood mapping (Sen1Floods11)",
        "config": "InstaGeo-Baseline",
        "gfm": "Prithvi-V1-100M",
        "mIoU": 88.53, "Acc": 97.24, "mF1": 93.71, "ROC-AUC": 99.16,
        "source": "reference README.md:31",
    },
    "multitemporal_crop_classification": {
        "task": "Multi-temporal crop seg (US)",
        "config": "InstaGeo-Replica",
        "gfm": "Prithvi-V1-100M",
        "mIoU": 47.87, "Acc": 66.10, "mF1": 64.19, "ROC-AUC": 95.82,
        "source": "reference README.md:36",
    },
    "locust": {
        "task": "Locust breeding ground",
        "config": "InstaGeo-Replica",
        "gfm": "Prithvi-V1-100M",
        "mIoU": 73.30, "Acc": 84.60, "mF1": 84.60, "ROC-AUC": 88.66,
        "source": "reference README.md:41",
    },
}

_METRIC_COLS = ("mIoU", "Acc", "mF1", "ROC-AUC")
# mode=eval prefixes every key with "test_", whichever split's file it reads.
_EVAL_KEYS = {"mIoU": "test_IoU", "Acc": "test_Acc", "mF1": "test_F1",
              "ROC-AUC": "test_roc_auc"}


def _as_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


def _check_pretrained_gate(cfg: Any) -> Optional[str]:
    """The local pretrained file a real replica starts from; raises before
    any work where there is none, unless ``replica.require_pretrained`` is
    false (the one opt-out)."""
    rep = cfg.get("replica") or {}
    if not _as_bool(rep.get("require_pretrained", True)):
        return None
    if not bool(cfg.model.get("load_pretrained_weights", False)):
        raise RuntimeError(
            "mode=replica with model.load_pretrained_weights=False would "
            "replicate from a fresh init — pass "
            "replica.require_pretrained=False to knowingly do that, or enable "
            "the pretrained load.")
    path = cfg.model.get("pretrained_path") or os.environ.get("PRITHVI_PRETRAINED_PATH")
    if not path or not os.path.exists(str(path)):
        raise RuntimeError(
            "mode=replica needs local pretrained encoder weights: set "
            "model.pretrained_path=<file> or export PRITHVI_PRETRAINED_PATH=<file>, "
            "or pass replica.require_pretrained=False to knowingly replicate "
            "from a fresh init.")
    return str(path)


def _fmt(v: Any) -> str:
    return f"{v:.2f}" if isinstance(v, (int, float)) else "—"


def _hardware(device: torch.device) -> str:
    """The run's device as ``platform:kind xcount``: the card's name and the
    number of cards, or the CPU."""
    if device.type == "cuda":
        return f"gpu:{torch.cuda.get_device_name(device)} x{torch.cuda.device_count()}"
    return f"{device.type}:{device.type} x1"


def _write_report(run_dir: str, report: Dict[str, Any]) -> None:
    with open(os.path.join(run_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)

    ref = report.get("reference")
    lines = [
        "# Replica report",
        "",
        f"Generated by `mode=replica` on {report['hardware']}; "
        f"total {report['duration_s']:.0f}s "
        f"(train {report['stages'].get('train_s', 0):.0f}s).",
        "",
        "| Task | Config | GFM | mIoU | Acc | mF1 | ROC-AUC | Hardware |",
        "|---|---|---|---|---|---|---|---|",
    ]
    task = (ref or {}).get("task", report["task"])
    gfm = report["model"]
    for split, m in report["metrics"].items():
        cells = " | ".join(_fmt(m.get(k)) for k in _METRIC_COLS)
        lines.append(f"| {task} | instageo_tpu replica ({split}) | {gfm} "
                     f"| {cells} | {report['hardware']} |")
    if ref:
        cells = " | ".join(_fmt(ref.get(k)) for k in _METRIC_COLS)
        lines.append(f"| {task} | {ref['config']} (reference, "
                     f"{ref['source']}) | {ref['gfm']} | {cells} "
                     f"| unspecified |")
        deltas = report.get("deltas") or {}
        if deltas:
            cells = " | ".join(_fmt(deltas.get(k)) for k in _METRIC_COLS)
            lines.append(f"| {task} | delta (test − reference) | — "
                         f"| {cells} | — |")
    lines += ["",
              "Metrics are percent, matching the reference README table. "
              "Stage configs: see `.hydra/config.yaml`; eval metrics per "
              "split in `eval_val.json` / `eval_test.json` next to this "
              "report (the `eval_*/` directories hold each stage's "
              "re-saved config)."]
    with open(os.path.join(run_dir, "REPORT.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def run_replica(cfg: Any) -> Dict[str, Any]:
    """stats → train → eval (val, test) → report, from a resolved config;
    returns the report."""
    # run.py imports this module inside main, and this module run.py here.
    from instageo_tpu_torch.configs.config import check_required_flags, save_config
    from instageo_tpu_torch.device import resolve_device
    from instageo_tpu_torch.train.run import main as run_main

    t0 = time.time()
    check_required_flags(["root_dir", "train_filepath", "valid_filepath", "test_filepath"],
                         cfg)
    device = resolve_device(cfg.get("device"))
    rep = cfg.get("replica") or {}
    pre_path = _check_pretrained_gate(cfg)

    run_dir = cfg.get("run_dir") or os.path.join(
        "outputs", "replica", time.strftime("%Y-%m-%d_%H-%M-%S"))
    os.makedirs(run_dir, exist_ok=True)
    save_config(cfg, run_dir)
    hydra_dir = os.path.join(run_dir, ".hydra")
    base = ["--config-path", hydra_dir, "--config-name", "config", f"run_dir={run_dir}"]
    # One decoded-chip cache for every stage: stats decodes each chip once,
    # train's later epochs and both eval splits read the cache.
    if _as_bool(rep.get("chip_cache", True)) and not cfg.dataloader.get("cache_dir"):
        base.append(f"dataloader.cache_dir={os.path.join(run_dir, 'chip_cache')}")
    stages: Dict[str, float] = {}
    report: Dict[str, Any] = {
        "task": str(rep.get("task", "")) or "unknown",
        "model": str(cfg.model.get("model_name")),
        "pretrained": pre_path,
        "epochs": int(cfg.train.get("num_epochs", 0)),
        "hardware": _hardware(device),
        "stages": stages,
        "metrics": {},
    }

    # Stage 1: dataset statistics. Every reference recipe trains on the
    # computed mean/std (replica.apply_stats); only the crop recipe also
    # takes the computed class weights (replica.apply_class_weights).
    extra: List[str] = []
    if _as_bool(rep.get("stats", True)):
        t = time.time()
        stats = run_main(base + ["mode=stats"])
        stages["stats_s"] = time.time() - t
        report["dataset_stats"] = stats
        if _as_bool(rep.get("apply_stats", True)):
            extra += [f"dataloader.mean={json.dumps(stats['mean'])}",
                      f"dataloader.std={json.dumps(stats['std'])}"]
        if _as_bool(rep.get("apply_class_weights", False)) and stats.get("class_weights"):
            extra.append(f"train.class_weights={json.dumps(stats['class_weights'])}")
        log.info("Replica stage 1/4 (stats) done in %.1fs", stages["stats_s"])

    # Stage 2: fine-tune. mode=train saves the resolved config (with the
    # applied stats) into run_dir/.hydra, so the eval stages load what trained.
    t = time.time()
    history = run_main(base + ["mode=train"] + extra)
    stages["train_s"] = time.time() - t
    report["history"] = {k: v for k, v in history.items() if isinstance(v, (int, float))}
    ckpt = os.path.join(run_dir, "instageo_best_checkpoint")
    if not os.path.exists(ckpt):
        raise RuntimeError(f"training produced no checkpoint at {ckpt}")
    report["checkpoint"] = ckpt
    log.info("Replica stage 2/4 (train) done in %.1fs", stages["train_s"])

    # Stage 3: both held-out splits, as the reference script's val + test loop.
    splits = {"val": cfg.get("valid_filepath"), "test": cfg.get("test_filepath")}
    for split, fp in splits.items():
        t = time.time()
        metrics = run_main(base + [
            "mode=eval", f"checkpoint_path={ckpt}", f"test_filepath={fp}",
            f"run_dir={os.path.join(run_dir, f'eval_{split}')}"])
        stages[f"eval_{split}_s"] = time.time() - t
        report["metrics"][split] = {col: 100.0 * float(metrics[key])
                                    for col, key in _EVAL_KEYS.items() if key in metrics}
        with open(os.path.join(run_dir, f"eval_{split}.json"), "w") as f:
            json.dump(metrics, f, indent=2, default=str)
    log.info("Replica stage 3/4 (eval) done")

    # Stage 4: the table row and the deltas to the published run.
    ref = REFERENCE_TARGETS.get(report["task"])
    report["reference"] = ref
    if ref and "test" in report["metrics"]:
        report["deltas"] = {
            k: report["metrics"]["test"][k] - ref[k]
            for k in _METRIC_COLS
            if k in report["metrics"]["test"] and isinstance(ref.get(k), (int, float))}
    report["duration_s"] = time.time() - t0
    _write_report(run_dir, report)
    log.info("Replica stage 4/4 (report) → %s/REPORT.md", run_dir)
    print(json.dumps({"run_dir": run_dir, "metrics": report["metrics"],
                      "deltas": report.get("deltas")}))
    return report
