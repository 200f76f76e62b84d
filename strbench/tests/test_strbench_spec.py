"""BENCHMARK.json against the benchmark contract, and every name in it
resolving to its file."""

import json
import re

import pytest

from strbench import spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["strbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_names_and_units():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert spec.NAME.match(entry["name"]), entry["name"]
            names.append((section in ("end_to_end", "per_layer"),
                          entry["name"]))
            if "unit" in entry:
                assert spec.UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry and section not in ("end_to_end",
                                                     "per_layer"):
                    assert ONE_LINE.match(entry[key]), entry[key]
    assert len(names) == len(set(names))


def test_metric_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and ONE_LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.cell(BENCH, cell)
    w = c["workload"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and ONE_LINE.match(w["why"])
    cfg = c["config"]
    assert cfg["name"] == w["config"]
    for key in c["config_entry"]["reduced"]:
        assert key in cfg and spec.NAME.match(key)
    assert c["traffic"]["generator"]
    from strbench.traffic import generate
    generate.family(c["traffic"])
    assert set(c["limits"]) == {"em_start", "em_gap", "ll_gap", "post_gap",
                                "record_gb", "record_q_gap"}
    assert spec.metrics_of(BENCH, cell, "per_layer")
    assert len(spec.metrics_of(BENCH, cell, "end_to_end")) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    assert callable(spec.reader(metric).read)


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith("strbench/") for f in files)
