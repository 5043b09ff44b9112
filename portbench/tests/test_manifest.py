"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(M) == KEYS
    assert len(json.dumps(M)) < 64 * 1024
    assert M["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("portbench/")
    with open(manifest.ROOT / entry["file"]) as f:
        conf = json.load(f)
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"] == []
    assert 0 < conf["limits"]["ratio"] < 1
    assert any(w["config"] == entry["name"] for w in M["workloads"])


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_workload(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = manifest.cell(w["name"])
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    assert {m["moves"] for m in cell["per_layer"]} <= e2e


@pytest.mark.parametrize("m", M["end_to_end"] + M["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    per_layer = "layer" in m
    keys = {"name", "unit", "better", "source"} | ({"layer", "moves"} if per_layer else {"bound"})
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if per_layer:
        assert manifest.load_module("metrics", m["name"]) is not None
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    else:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    names = {w["name"] for w in M["workloads"]}
    assert set(m.get("workloads", names)) <= names


def test_unknown_names():
    with pytest.raises(KeyError):
        manifest.cell("no-such.cell")
    assert manifest.load_module("metrics", "no.such.metric") is None
