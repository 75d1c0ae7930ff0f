"""A copy of the benchmark with a tiny cell of each kind, for the CPU
tests: ``prithvi_eo_tiny`` (D 256, Dh 64) at 2 blocks, T=2, 32 px."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100bench"


def make(dst: Path, steps_per_call: int = 2, grad_accum: int = 1) -> Path:
    """``dst`` holds BENCHMARK.json and h100bench/ with the cells
    ``tiny.serve`` and ``tiny.train`` added (new files and entries only)."""
    dst = Path(dst)
    shutil.copytree(BENCH, dst / "h100bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    b = dst / "h100bench"
    cfg = json.loads((BENCH / "configs" / "v1_100m_crop.json").read_text())
    t = 2
    cfg["name"] = "tiny"
    cfg["model"].update(embed_dim=256, depth=2, num_heads=4, num_frames=t, img_size=32,
                        num_classes=3)
    raw = cfg["raw_chips"]
    raw.update(bands=6 * t, size=40, dn_mean=raw["dn_mean"][:6] * t, dn_std=raw["dn_std"][:6] * t)
    prog = cfg["program"]
    prog["model"].update(model_name="prithvi_eo_tiny", depth=2, num_classes=3)
    prog["dataloader"].update(bands=list(range(6 * t)), img_size=32, temporal_dim=t)
    prog["train"].update(class_weights=[0.5, 1.0, 2.0], batch_size=4, grad_accum=grad_accum)
    prog["tpu"]["steps_per_call"] = steps_per_call
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny_serve.json").write_text(json.dumps(
        {"kind": "serve_closed", "batch": 4, "in_flight": 2, "pool": 3, "warmup_requests": 1,
         "check_pool_batches": 2, "trace_requests": [2, 3], "calibration_chips": 4}))
    (b / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"kind": "train_epoch", "batch": 4, "pool": 5, "ignore_share": 0.05,
         "trace_steps": [2, 4]}))
    for cell, real in (("tiny.serve", "v1_100m_crop.serve_b64"),
                       ("tiny.train", "v1_100m_crop.train_b8")):
        if (b / "limits" / f"{real}.json").exists():
            shutil.copy(b / "limits" / f"{real}.json", b / "limits" / f"{cell}.json")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1, "why": "test"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is None:
            continue
        if any(".serve" in c for c in cells):
            cells.append("tiny.serve")
        if any(".train" in c for c in cells):
            cells.append("tiny.train")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst


def run(root: Path, cell: str, trace: int = 0, seed: int = 3000000123, seconds: float = 1.0,
        capsys=None):
    """harness.main on the CPU; returns (rc, the last stdout line as JSON)."""
    from h100bench import harness

    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, device="cpu")
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out else None
    return rc, line
