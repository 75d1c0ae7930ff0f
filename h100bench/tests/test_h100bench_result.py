"""The last line of a run has exactly the contract's keys, the numbers
compared last."""

import pytest

from h100bench.tests import tiny

TOP = ["correct", "attempted", "failed", "metrics", "device", "check"]
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(tmp_path, capsys, cell, trace):
    rc, line = tiny.run(tiny.make(tmp_path), cell, trace=trace, capsys=capsys)
    assert rc == 0
    keys = list(line)
    expected = TOP[:5] + (["breakdown"] if trace else []) + ["check"]
    assert sorted(keys) == sorted(expected)
    assert keys[-1] == "check"
    assert set(line["device"]) == DEVICE | ({"busy_s", "window_s"} if trace else set())
    assert isinstance(line["correct"], bool)
    for name, shown in line["check"].items():
        assert set(shown) == {"value", "limit"}, name
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
