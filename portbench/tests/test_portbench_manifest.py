"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                  and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]


def test_names_units_and_text():
    groups = [BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"], BENCH["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
    for c in BENCH["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert all(line(m["layer"]) for m in BENCH["per_layer"])


def test_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for n, m in e2e.items() if n != "setup_s")
        assert any(reports(m, cell) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells and reports(e2e[m["moves"]], cell)
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_chips_and_configs():
    cells = BENCH["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert all(w["chips"] in (1, 4) for w in cells)
    assert four <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in cells}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["source"].startswith("https://")
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics"])
def test_files_found_by_name(kind):
    """Every configuration, traffic mix and per-layer metric has its file,
    under the name BENCHMARK.json gives it."""
    here = ROOT / "portbench"
    if kind == "configs":
        for c in BENCH["configs"]:
            cfg = json.loads((ROOT / c["file"]).read_text())
            assert cfg["name"] == c["name"] and (here / "configs" / f"{c['name']}.json").is_file()
            assert cfg["check_limits"], "every configuration states the limits of its check"
    elif kind == "workloads":
        for w in BENCH["workloads"]:
            t = json.loads((here / "workloads" / f"{w['traffic']}.json").read_text())
            assert t["kind"] == "fleet"
    else:
        for m in BENCH["per_layer"]:
            assert (here / "metrics" / f"{m['name']}.py").is_file()
