"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); a per-layer metric is read by
``metrics/<name>.py``; a hand kernel's bytes are counted by
``rooflines/<kernel>.py``.  A later cell, mix, metric or kernel is a file
and an entry, never an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic and metrics:
    ``{"name", "chips", "config": {...}, "traffic": {...}, "end_to_end":
    [...], "per_layer": [...]}``."""
    manifest = manifest or load_manifest()
    found = [w for w in manifest["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    (conf,) = [c for c in manifest["configs"] if c["name"] == w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    return {
        "name": name,
        "chips": w["chips"],
        "config": config,
        "traffic": load_traffic(w["traffic"]),
        "end_to_end": [m for m in manifest["end_to_end"] if _reports(m, name)],
        "per_layer": [m for m in manifest["per_layer"] if _reports(m, name)],
    }


def load_traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return {"name": name, **json.load(f)}


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module, or None where there is no file."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
