"""The result line carries exactly the contract's keys, and the numbers
compared are the last lines of standard error."""

import json

from strbench import harness


def result(trace):
    r = dict(correct=True, attempted=12, failed=0, memory_peak_bytes=123,
             metrics={"loci_per_s": dict(value=1.5, unit="loci/s")})
    if trace:
        r.update(busy_s=0.5, window_s=10.0, breakdown=dict(
            device_ops=[["segment_kernel", 0.25]],
            idle_gaps=[["host_workers", 1.0]]))
    return r


def test_trace0_line(capsys):
    rows = [("ll_gap", 1e-6, 1e-3), ("em_gap", float("inf"), 0.01)]
    assert harness.emit(result(False), rows, dict(
        platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1), False) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"]["em_gap"] == {"value": "inf", "limit": 0.01}
    assert err.strip().splitlines()[-2:] == [
        "check ll_gap = 1e-06 (limit 0.001)",
        "check em_gap = inf (limit 0.01)"]


def test_trace1_line(capsys):
    harness.emit(result(True), [], dict(platform="gpu", kind="x", count=1),
                 True)
    line = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    from strbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "trio30x.stutter", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr()[0] == ""
