"""The benchmark's run: one cell, one seed, one process.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in ``BENCHMARK.json``, its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` (whose
``kind`` names the module that runs it, ``kinds/<kind>.py``) and its limits
in ``limits/<cell>.json``. That module builds the system under test, warms the
cell's shapes, measures one window and runs the comparison; with
``--trace 1`` it profiles a steady stretch of the window, and each of the
cell's per-layer metrics is read by ``metrics/<name>.py`` (else
``metrics/<name before the first dot>.py``). The last line of standard
output is the result's JSON; the last lines of standard error are the
numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "instageo_tpu")


def load_benchmark(root: Path) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: Dict, section: str, cell: str) -> List[Dict]:
    """The cell's metrics of ``end_to_end`` or ``per_layer``: those that
    list it under ``workloads``, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: Path, cell: Dict) -> Dict:
    """The configuration, traffic and limits of a cell, by name."""
    bench_dir = root / HERE.name
    limits_path = bench_dir / "limits" / f"{cell['name']}.json"
    return {
        "config": load_json(bench_dir / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(limits_path) if limits_path.exists() else {},
    }


def kind_module(root: Path, kind: str):
    from h100bench.common import load_module

    return load_module(root / HERE.name / "kinds" / f"{kind}.py", f"h100bench_kind_{kind}")


def metric_reader(root: Path, name: str):
    """``read(summary, ctx, name)`` of a per-layer metric, or None."""
    from h100bench.common import load_module

    base = root / HERE.name / "metrics"
    for stem in (name, name.split(".")[0]):
        path = base / f"{stem}.py"
        if path.exists():
            return load_module(path, "h100bench_metric_" + stem.replace(".", "_")).read
    return None


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, root: Optional[Path] = None,
         device: Optional[str] = None, t_process: Optional[float] = None) -> int:
    """Run one cell and print its result. ``device="cpu"`` (the harness's
    own tests) skips the look for a card; the command line never does."""
    import torch

    from h100bench.common import Context, process_start
    from h100bench.tracing import Tracer, breakdown

    args = parse(argv)
    root = Path(root) if root is not None else HERE.parent
    bench = load_benchmark(root)
    cell = find_cell(bench, args.workload)
    files = cell_files(root, cell)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"h100bench: {cell['name']} needs {cell['chips']} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)
    ctx = Context(cell=cell["name"], config=files["config"], traffic=files["traffic"],
                  limits=files["limits"], seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=dev,
                  t_process=process_start() if t_process is None else t_process)
    ctx.tracer = Tracer(dev) if ctx.trace else None
    ctx.lap("imports")
    out = kind_module(root, files["traffic"]["kind"]).run(ctx)

    found = forbidden_modules()
    if found:
        print(f"h100bench: the process loaded {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    metrics = {}
    if not ctx.trace:
        for m in metrics_for(bench, "end_to_end", cell["name"]):
            if m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    else:
        summary = ctx.tracer.summary
        if summary is None:
            print("h100bench: the traced stretch did not complete", file=sys.stderr)
            return 4
        for m in metrics_for(bench, "per_layer", cell["name"]):
            read = metric_reader(root, m["name"])
            value = read(summary, ctx, m["name"]) if read is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if ctx.trace:
        device_info["busy_s"] = ctx.tracer.summary["busy_s"]
        device_info["window_s"] = ctx.tracer.summary["window_s"]
        result["breakdown"] = breakdown(ctx.tracer.summary)
    result["device"] = device_info
    result["check"] = out["check"]
    print(f"h100bench: card and power limit: {power_limit()}", file=sys.stderr)
    print("h100bench: set-up, seconds since the process began: "
          + ", ".join(f"{name} {t:.3f}" for name, t in ctx.laps), file=sys.stderr)
    for note in ctx.notes:
        print(f"h100bench: {note}", file=sys.stderr)
    for name, shown in out["check"].items():
        print(f"check: {name} {shown['value']!r} limit {shown['limit']!r}", file=sys.stderr)
    print(f"check: correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


def _finite(obj):
    """JSON has no infinity or NaN: such a number is written as its text."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None
