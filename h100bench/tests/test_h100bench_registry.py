"""The harness finds a configuration, a traffic mix and a per-layer metric
by name: a new cell needs new files and new BENCHMARK.json entries only."""

import hashlib
import json
from pathlib import Path

from h100bench import harness
from h100bench.tests import tiny


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path, capsys):
    root = tiny.make(tmp_path)
    before = _digests(tiny.BENCH)
    metric = root / "h100bench" / "metrics" / "dummy_metric.py"
    metric.write_text("def read(summary, ctx, name):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_chips_per_s", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(harness.load_benchmark(root), "tiny.serve")
    files = harness.cell_files(root, cell)
    assert files["config"]["name"] == "tiny"
    assert files["traffic"]["kind"] == "serve_closed"
    assert harness.metric_reader(root, "dummy_metric")(None, None, "dummy_metric") == 42.0
    # A suffixed name falls back to the reader of its base name.
    assert harness.metric_reader(root, "idle_pct.anything") is not None
    assert harness.metric_reader(root, "no_such_metric") is None

    rc, line = tiny.run(root, "tiny.serve", trace=1, capsys=capsys)
    assert rc == 0
    assert line["metrics"]["dummy_metric"] == {"value": 42.0, "unit": "%"}
    # The copy's original files are untouched; only new files were added.
    after = _digests(root / "h100bench")
    for rel, digest in before.items():
        assert after[rel] == digest, rel
