"""One traced run of a benchmark cell, with the program's spans laid out.

    python3 tools/trace_spans.py --workload <cell> --seed <n> --seconds <s> --out <file.json>

Runs ``h100bench/run.py``'s cell with ``--trace 1`` (its result line is
printed as the harness prints it) and writes to ``--out`` what the traced
stretch's Chrome trace says of the program's ``instageo.*`` spans
(``instageo_tpu_torch/utils/telemetry.py:span``), which the harness's own
summary (``h100bench/tracing.py:summarize``) does not read:

* ``spans``: {name: {"count", "host_s", "device_s"}}: how often each span
  ran, its summed host seconds, and the summed seconds of the device
  operations (kernels, memcpys, memsets) launched inside it. An operation
  belongs to a span when its ``correlation`` is that of a CUDA runtime or
  driver call made inside the span on the same thread; the kernels of a
  ``cudaGraphLaunch`` carry that call's correlation, so a replay's span
  owns its whole graph. An operation counts for every span that encloses
  its launch. ``bench_spans``: the same table for the harness's ``bench.*``
  spans;
* ``idle_in_span``: every idle gap on the device, the short ones included,
  credited to the innermost program span open at its middle, and
  ``idle_by_phase``: the same gaps by the innermost ``bench.*`` span and
  program span (``bench.predict / instageo.serve.upload``);
* ``device_op_s``: the device operations' summed seconds, and
  ``coverage``: the share of them that the cell's top-level spans own
  (serving: the five serving spans and ``bench.copy_back``; training:
  ``instageo.train.replay``, ``stage`` and ``seeds``);
* ``graph_kernel_args``: the argument keys of the kernels launched by a
  ``cudaGraphLaunch``, and how many carry a key naming a graph node;
* ``idle``, ``memcpy``, ``busy_s``, ``window_s``: the harness's idle
  labels, its memcpy seconds by kind (``Memcpy HtoD (Pinned -> Device)``),
  busy and traced seconds on the device, as its summary gives them;
* ``upload_counters``: the program's host counters of serving, over the
  traced stretch and over the whole process (warm-up included): the
  upload's (``ops/preprocess.py``: ``pinned_uploads``,
  ``pageable_uploads``, ``upload_slot_waits``) and the ``_tl`` coords'
  (``models/prithvi.py``: ``coord_embeds``, ``coords_missing``); those the
  program lacks are left out;
* ``launch_counters``: the same for every hand-written kernel's launches
  (``instageo_tpu_torch/ops:launch_counts``, graph replays included); also
  printed.

Run from the root of a checkout (of the program with or without spans);
on a card only, as ``h100bench/run.py`` is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from instageo_tpu_torch.ops import launch_counts  # noqa: E402

PROGRAM_PREFIX = "instageo."   # the program's spans
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COUNTERS = {"ops.preprocess": ("pinned_uploads", "pageable_uploads", "upload_slot_waits"),
            "models.prithvi": ("coord_embeds", "coords_missing")}
SERVE_TOP = ("instageo.serve.upload", "instageo.serve.preprocess", "instageo.model.encoder",
             "instageo.model.head", "instageo.serve.argmax")
TRAIN_TOP = ("instageo.train.replay", "instageo.train.stage", "instageo.train.seeds")


def _ranges(events: List[Dict], prefix: str) -> List[Tuple[float, float, str, Tuple]]:
    """The host ranges (``record_function``) whose names start with
    ``prefix``: (start, end, name, (pid, tid)), by start."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
            (e.get("pid"), e.get("tid")))
           for e in events
           if e.get("ph") == "X" and "dur" in e and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(prefix)]
    out.sort()
    return out


def _open_at(ranges, times: List[float]) -> List[Tuple]:
    """For each of the ascending ``times``, the ranges (by start) open at it."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= t]
        out.append(tuple(active))
    return out


def _innermost(open_: Tuple) -> Optional[str]:
    return min(open_, key=lambda r: r[1] - r[0])[2] if open_ else None


def span_table(events: List[Dict], prefix: str = PROGRAM_PREFIX) -> Dict[str, Dict[str, float]]:
    """{name: {"count", "host_s", "device_s"}} of the host ranges whose
    names start with ``prefix`` (see the module's docstring)."""
    from h100bench import tracing

    ranges = _ranges(events, prefix)
    table: Dict[str, Dict[str, float]] = {}
    for s, e, name, _ in ranges:
        row = table.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0})
        row["count"] += 1
        row["host_s"] += (e - s) * 1e-6
    if not ranges:
        return table
    device: Dict = {}
    launches: Dict[Tuple, List[Tuple[float, object]]] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        cat = e.get("cat", "")
        if cat in tracing.DEVICE_CATS:
            device[corr] = device.get(corr, 0.0) + float(e["dur"]) * 1e-6
        elif cat in LAUNCH_CATS:
            launches.setdefault((e.get("pid"), e.get("tid")), []).append((float(e["ts"]), corr))
    by_thread: Dict[Tuple, List] = {}
    for r in ranges:
        by_thread.setdefault(r[3], []).append(r)
    for thread, calls in launches.items():
        if thread not in by_thread:
            continue
        calls.sort(key=lambda c: c[0])
        for (_, corr), open_ in zip(calls, _open_at(by_thread[thread], [c[0] for c in calls])):
            seconds = device.get(corr, 0.0)
            if seconds:
                for r in open_:
                    table[r[2]]["device_s"] += seconds
    return table


def idle_by_span(events: List[Dict]) -> Tuple[Dict[str, float], Dict[str, float]]:
    """({program span: seconds}, {"<bench span> / <program span>": seconds})
    of the device's idle gaps (as ``tracing.summarize`` finds them, the
    short ones included), each credited at its middle to the innermost
    ranges open there; gaps outside every program span are left out of
    the first and named by their ``bench.*`` span alone in the second."""
    from h100bench import tracing

    busy = tracing._merge([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                           if e.get("ph") == "X" and "dur" in e
                           and e.get("cat") in tracing.DEVICE_CATS])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    middles = [0.5 * (gs + ge) for gs, ge in gaps]
    program = [_innermost(o) for o in _open_at(_ranges(events, PROGRAM_PREFIX), middles)]
    bench = [_innermost(o) for o in _open_at(_ranges(events, "bench."), middles)]
    in_span: Dict[str, float] = {}
    by_phase: Dict[str, float] = {}
    for (gs, ge), p, b in zip(gaps, program, bench):
        seconds = (ge - gs) * 1e-6
        if p is not None:
            in_span[p] = in_span.get(p, 0.0) + seconds
        label = " / ".join(n for n in (b, p) if n is not None) or "(no host range)"
        by_phase[label] = by_phase.get(label, 0.0) + seconds
    return in_span, by_phase


def describe(events, summary):
    """The span tables, coverage and graph kernels' argument keys of one
    traced stretch."""
    from h100bench import tracing

    spans = span_table(events)
    idle_in_span, idle_by_phase = idle_by_span(events)
    dev = [e for e in events if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in tracing.DEVICE_CATS]
    total = sum(float(e["dur"]) for e in dev) * 1e-6
    bench = span_table(events, "bench.")
    serving = "bench.copy_back" in bench
    top = [(n, spans.get(n, {}).get("device_s", 0.0)) for n in
           (SERVE_TOP if serving else TRAIN_TOP)]
    if serving:
        top.append(("bench.copy_back", bench["bench.copy_back"]["device_s"]))
    graph_corr = {(e.get("args") or {}).get("correlation") for e in events
                  if e.get("cat") in LAUNCH_CATS and "GraphLaunch" in e.get("name", "")}
    graph_kernels = [e for e in dev if e.get("cat") == "kernel"
                     and (e.get("args") or {}).get("correlation") in graph_corr]
    keys = sorted({k for e in graph_kernels for k in (e.get("args") or {})})
    with_node = sum(1 for e in graph_kernels
                    if any("graph" in k.lower() and "node" in k.lower() for k in e.get("args", {})))
    return {
        "spans": spans,
        "idle_in_span": idle_in_span,
        "idle_by_phase": dict(sorted(idle_by_phase.items(), key=lambda kv: -kv[1])[:12]),
        "bench_spans": bench,
        "device_op_s": total,
        "coverage": {"parts": dict(top),
                     "share": sum(s for _, s in top) / total if total else None},
        "graph_kernel_args": {"kernels": len(graph_kernels), "keys": keys,
                              "with_graph_node": with_node},
        "idle": dict(sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:12]),
        "memcpy": summary["memcpy"],
        "busy_s": summary["busy_s"],
        "window_s": summary["window_s"],
    }


def counters_now(counters: Dict[str, Tuple[str, ...]]) -> Dict[str, int]:
    """The program's ``counters`` now, by ``module.name``: a launch
    counter's total (graph replays included), a host counter's count; those
    the program lacks are left out."""
    import importlib

    out = {}
    for module, names in counters.items():
        try:
            mod = importlib.import_module(f"instageo_tpu_torch.{module}")
        except ModuleNotFoundError:
            continue
        short = module.split(".")[-1]
        for n in names:
            c = getattr(mod, n, None)
            if c is not None:
                out[f"{short}.{n}"] = c.total() if hasattr(c, "total") else c.count
    return out


COUNTER_GROUPS = {"upload_counters": lambda: counters_now(COUNTERS),
                  "launch_counters": launch_counts}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    from h100bench import env

    env.set_up()
    from h100bench import common, harness, tracing

    t0 = common.process_start()
    found = {}
    summarize = tracing.summarize

    # The harness keeps no timeline: its tracer hands the stretch's events
    # to ``tracing.summarize`` and drops them, so they are read on the way.
    def summarize_and_describe(events):
        summary = summarize(events)
        found.update(describe(events, summary))
        return summary

    tracing.summarize = summarize_and_describe
    marks = {}
    start, stop = tracing.Tracer.start, tracing.Tracer.stop

    def start_marked(self):
        marks["start"] = {k: read() for k, read in COUNTER_GROUPS.items()}
        start(self)

    def stop_marked(self, **units):
        stop(self, **units)
        marks["stop"] = {k: read() for k, read in COUNTER_GROUPS.items()}

    tracing.Tracer.start, tracing.Tracer.stop = start_marked, stop_marked
    rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"], t_process=t0)
    for key, read in COUNTER_GROUPS.items():
        found[key] = {
            name: {"stretch": (marks["stop"][key][name] - marks["start"][key][name]
                               if "stop" in marks else None),
                   "process": n} for name, n in read().items()}
    print("launch_counters " + json.dumps(found["launch_counters"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(found, workload=args.workload, seed=args.seed), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
