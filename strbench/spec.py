"""BENCHMARK.json and the files it names, found by name: a configuration
by its `file`, a traffic mix at strbench/traffic/<traffic>.json, a cell's
limits at strbench/limits/<cell>.json, a per-layer metric's reader at
strbench/metrics/<metric>.py."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def cell(spec: dict, name: str) -> dict:
    """Everything one cell runs on, by name: its workload entry, its
    configuration's entry and file, its traffic mix and its limits."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return dict(
        workload=w, config_entry=conf,
        config=json.loads((ROOT / conf["file"]).read_text()),
        traffic=dict(json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                                .read_text()), name=w["traffic"]),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()))


def metrics_of(spec: dict, cell_name: str, section: str) -> list:
    """The metrics of `section` that this cell reports."""
    return [m for m in spec[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(metric: str):
    return importlib.import_module(f"strbench.metrics.{metric}")
