"""`BENCHMARK.json` against the benchmark's contract and against the files
the harness finds by name: every cell has its workload, configuration and
mix files, every metric its reader with the same kind and unit."""

from __future__ import annotations

import json
import re

import pytest
from conftest import ROOT

from portbench import metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) and not w.startswith("/") for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(bench["workloads"])
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells >= 1


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads_match_their_files(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        own = json.loads((ROOT / "portbench/workloads" / f"{w['name']}.json").read_text())
        assert own == {"config": w["config"], "traffic": w["traffic"], "chips": w["chips"]}
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").exists()


def test_metrics_have_readers(bench):
    readers = metrics.load_all()
    e2e = {m["name"] for m in bench["end_to_end"]}
    all_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(all_names) == len(set(all_names)) and "setup_s" in e2e
    cells = {w["name"] for w in bench["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES and set(m.get("workloads", [])) <= cells
            r = readers[m["name"]]
            assert r.KIND == kind and r.UNIT == m["unit"]
            if kind == "end_to_end":
                assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
                assert _line(m["layer"]) and m["moves"] in e2e
                moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
                assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for cell in cells:  # each cell: setup_s, one more end-to-end metric, one per-layer metric
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
